"""Host time of the server's ``MotionBERT.lift`` calls (a span in the
benchmark's own code around each; the call ends in the result's host copy)
per row dispatched, padding included."""


def read(rec: dict):
    if rec.get("kind") != "serve" or not rec.get("lift_rows"):
        return None
    return 1e3 * rec["lift_s"] / rec["lift_rows"]
