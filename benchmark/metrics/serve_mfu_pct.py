"""Model FLOPs of the served forwards (two a dispatched row under flip-TTA,
padding rows included, since the card computes them) over the traced
window's length times the bf16 peak."""

from benchmark.work import PEAK_BF16_FLOPS


def read(rec: dict):
    if rec.get("kind") != "serve" or not rec.get("window_s"):
        return None
    return 100.0 * rec["model_flops"] / (rec["window_s"] * PEAK_BF16_FLOPS)
