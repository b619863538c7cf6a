"""Real requests per dispatched batch over the window (the server's
``ServerStats``: batched requests over batches)."""


def read(rec: dict):
    if rec.get("kind") != "serve" or not rec.get("batches"):
        return None
    return rec["real_rows"] / rec["batches"]
