"""Host time a step in the program's ``data.feed`` spans: the trainer's
``device_prefetch`` taking the next host batch, pinning it, starting its
copy and handing over the batch it yields; summed over the window and
divided by its steps."""

from benchmark import spans


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("steps"):
        return None
    feed = spans.named(spans.recorded()["spans"], "data.feed")
    if not feed:
        return None
    return sum(spans.host_ms(s) for s in feed) / rec["steps"]
