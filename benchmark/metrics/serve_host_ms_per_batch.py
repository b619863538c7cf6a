"""The collector thread's host time a dispatched batch outside the model
call: each ``serve.dispatch`` span less its ``serve.model`` child (stacking,
unstacking, resolving the futures), the mean over the window's batches.
The card has nothing of the batch queued meanwhile."""

from benchmark import spans


def read(rec: dict):
    if rec.get("kind") != "serve":
        return None
    got = spans.recorded()["spans"]
    model = {s["parent"]: s for s in spans.named(got, "serve.model")}
    host = [spans.host_ms(d) - spans.host_ms(model[d["id"]])
            for d in spans.named(got, "serve.dispatch") if d["id"] in model]
    return sum(host) / len(host) if host else None
