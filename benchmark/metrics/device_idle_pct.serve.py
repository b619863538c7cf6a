"""The share of the traced serving window (from the first arrival until
every request due in it has completed) with no work on the card. At a
fixed offered rate a faster program idles more: read it beside the
latencies."""


def read(rec: dict):
    if rec.get("kind") != "serve" or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
