"""The window's SMPL forwards' least time (``work_smpl.py``: float32 FLOPs
over the float32 peak, the algorithm's bytes over HBM bandwidth, the
larger) over the device time of the kernels launched under the program's
``mesh.smpl`` host region, in percent. The backward's kernels, launched by
autograd's thread, are not counted, nor is its work."""


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("smpl_least_s"):
        return None
    dev = rec.get("region_device_s", {}).get("mesh.smpl")
    if not dev:
        return None
    return 100.0 * rec["smpl_least_s"] / dev
