"""The share of the server's lifted rows that replayed a CUDA graph, in
percent: the rows of the program's ``lift.forward`` spans whose ``graph``
argument is 1 over the rows of all of them that carry it (0 is the eager
step). A program whose spans carry no such argument gives nothing."""

from benchmark import spans


def read(rec: dict):
    if rec.get("kind") != "serve":
        return None
    fwd = [s["args"] for s in spans.named(spans.recorded()["spans"],
                                          "lift.forward")
           if "graph" in s["args"]]
    rows = sum(a["rows"] for a in fwd)
    if not rows:
        return None
    return 100.0 * sum(a["rows"] for a in fwd if a["graph"]) / rows
