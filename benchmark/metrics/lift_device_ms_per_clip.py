"""Device time of the server's lifts per row dispatched, padding included:
the program's ``lift.forward`` spans (both flip-TTA forwards and their
average, between CUDA events) summed over their rows. Beside
``lift_call_ms_per_clip`` it splits a call into device work and the host's
copies around it."""

from benchmark import spans


def read(rec: dict):
    if rec.get("kind") != "serve":
        return None
    fwd = spans.named(spans.recorded()["device"], "lift.forward")
    rows = sum(s["args"]["rows"] for s in fwd)
    return sum(s["ms"] for s in fwd) / rows if rows else None
