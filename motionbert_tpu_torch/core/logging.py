"""Scalar metrics logging: JSONL always, TensorBoard when it is importable.

The port of ``motionbert_tpu/core/logging.py``'s ``MetricsWriter``: scalars
go to <logdir>/scalars.jsonl, one {"time", "step", "tag", "value"} per line,
and to TensorBoard through ``tensorboardX`` when that imports (not
``torch.utils.tensorboard``, whose import can pull in all of TensorFlow).
Under data parallelism the ranks other than 0 get a ``NullWriter``.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(logdir)

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps(
            {"time": time.time(), "step": int(step), "tag": tag,
             "value": float(value)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """``MetricsWriter``'s interface, writing nothing."""

    def add_scalar(self, tag: str, value, step: int):
        pass

    def close(self):
        pass


def open_writer(logdir: str):
    """A ``MetricsWriter`` on rank 0 (or with no process group), a
    ``NullWriter`` on the other ranks."""
    from motionbert_tpu_torch.parallel.mesh import is_main

    return MetricsWriter(logdir) if is_main() else NullWriter()
