"""The median over the window's train steps of the program's
``train.forward`` span on the device clock (CUDA events in
``make_train_step``)."""

import statistics

from benchmark import spans


def read(rec: dict):
    if rec.get("kind") != "train":
        return None
    ms = [s["ms"] for s in
          spans.named(spans.recorded()["device"], "train.forward")]
    return statistics.median(ms) if ms else None
