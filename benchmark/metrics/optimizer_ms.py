"""Device time per step of the kernels launched under torch's own
``Optimizer.step#AdamW.step`` profiler region."""


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("steps"):
        return None
    dev = rec.get("region_device_s", {}).get("Optimizer.step#")
    if not dev:
        return None
    return 1e3 * dev / rec["steps"]
