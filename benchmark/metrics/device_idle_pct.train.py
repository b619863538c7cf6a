"""The share of the traced training window with no work on the card."""


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
