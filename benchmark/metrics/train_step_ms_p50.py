"""The median of the window's train steps on the device clock (CUDA events
the benchmark records around each step call)."""

import statistics


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("step_ms"):
        return None
    return statistics.median(rec["step_ms"])
