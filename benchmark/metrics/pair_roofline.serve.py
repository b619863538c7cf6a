"""The served forwards' least time on the pairs (two forwards a dispatched
row under flip-TTA, padding rows included) over the device time of the
program's own kernels."""


def read(rec: dict):
    if rec.get("kind") != "serve" or not rec.get("port_kernel_s"):
        return None
    return 100.0 * rec["least_s"] / rec["port_kernel_s"]
