"""The 95th percentile (nearest rank) over the window's requests of each
one's wait in the server's queue: from ``BatchingServer.submit`` to the
start of its batch's ``serve.model`` span (the program's
``serve.queue_wait_s`` samples)."""

from benchmark import spans
from benchmark.inputs import percentile


def read(rec: dict):
    if rec.get("kind") != "serve":
        return None
    waits = [1e3 * s["value"] for s in
             spans.named(spans.recorded()["samples"], "serve.queue_wait_s")]
    return percentile(waits, 95) if waits else None
