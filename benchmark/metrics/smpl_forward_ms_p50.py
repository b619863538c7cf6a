"""The median over the window's train steps of the program's ``mesh.smpl``
span on the device clock: the mesh head's SMPL forward (blend shapes,
kinematic chain, skinning) and its H36M joint regression, between CUDA
events. A program without the span gives nothing."""

import statistics

from benchmark import spans


def read(rec: dict):
    if rec.get("kind") != "train":
        return None
    ms = [s["ms"] for s in spans.named(spans.recorded()["device"],
                                       "mesh.smpl")]
    return statistics.median(ms) if ms else None
