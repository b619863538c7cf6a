"""Model FLOPs of the window's train steps (three times the forward's,
from the shapes, no recompute) over the window's length times the bf16
peak."""

from benchmark.work import PEAK_BF16_FLOPS


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("window_s"):
        return None
    return 100.0 * rec["model_flops"] / (rec["window_s"] * PEAK_BF16_FLOPS)
