"""Padding rows as a share of the rows dispatched over the window (the
server's ``ServerStats``)."""


def read(rec: dict):
    if rec.get("kind") != "serve":
        return None
    rows = rec.get("real_rows", 0) + rec.get("padded_rows", 0)
    return 100.0 * rec["padded_rows"] / rows if rows else None
