"""Device time a step of the program's ``mesh.targets`` spans: the ground
truth vertices and joints skinned on the card from each batch's SMPL
parameters, under no gradient, summed over the window and divided by its
steps. A program without the span gives nothing."""

from benchmark import spans


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("steps"):
        return None
    ms = [s["ms"] for s in spans.named(spans.recorded()["device"],
                                       "mesh.targets")]
    return sum(ms) / rec["steps"] if ms else None
