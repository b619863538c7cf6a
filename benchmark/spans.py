"""The program's own spans and samples of a traced window, for the readers
in ``metrics/``: what ``motionbert_tpu_torch.core.profiling`` recorded while
the window's profiler ran. A program without that recorder gives nothing
to read, and every list comes back empty."""

from __future__ import annotations


def recorded() -> dict:
    """``{"spans", "device", "samples"}``: host spans (``start_ns``,
    ``end_ns``, ``parent``, ``args``), device spans (``ms``, ``args``) and
    samples (``value``, ``args``), each with its ``name``."""
    from motionbert_tpu_torch.core import profiling

    read = getattr(profiling, "recorded", None)
    if read is None:
        return {"spans": [], "device": [], "samples": []}
    return read()


def named(items: list, name: str) -> list:
    return [x for x in items if x["name"] == name]


def host_ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) * 1e-6
