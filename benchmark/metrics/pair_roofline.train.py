"""The window's train steps' least time on the pairs (work.py: each pair's
forward and backward at the larger of FLOPs over the bf16 peak and bytes
over HBM bandwidth, recompute not counted) over the device time of the
program's own kernels."""


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("port_kernel_s"):
        return None
    return 100.0 * rec["least_s"] / rec["port_kernel_s"]
