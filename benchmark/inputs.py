"""Inputs made from ``--seed``: clips of H36M-17 motion and arrival
schedules, and the order statistics the end-to-end metrics use.

A run's seed is split into independent streams (``streams``), so the
weights, the clips, the random flips and the arrivals each come from their
own. Every seed gives the same amount of work: the same clip shapes, the
same number of requests, in another order and at other instants.
"""

from __future__ import annotations

import math

import numpy as np

STREAMS = ("weights", "clips", "flips", "arrivals", "sample")


def streams(seed: int) -> dict:
    """One 32-bit seed per stream, from any non-negative whole number."""
    state = np.random.SeedSequence(int(seed)).generate_state(len(STREAMS))
    return {name: int(s) for name, s in zip(STREAMS, state)}


def clip_pool(seed: int, n: int, frames: int, joints: int = 17) -> tuple:
    """n clips of smooth random motion: (2D input (n, frames, joints, 3)
    with x, y and a confidence in [0.5, 1], 3D pose (n, frames, joints,
    3)), float32, in normalised coordinates."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0.0, 0.25, (n, 1, joints, 3)).astype(np.float32)
    drift = rng.normal(0.0, 0.01, (n, frames, joints, 3)).astype(np.float32)
    pose = base + np.cumsum(drift, axis=1, dtype=np.float32)
    conf = rng.uniform(0.5, 1.0, (n, frames, joints, 1)).astype(np.float32)
    return np.concatenate([pose[..., :2], conf], -1), pose


def batch_order(seed: int, pool: int, batch: int):
    """Batches of pool row indices: seeded permutations of the pool, one
    after another, so that rows repeat only after the whole pool."""
    rng = np.random.default_rng(seed)
    perm, at = rng.permutation(pool), 0
    while True:
        if at + batch > pool:
            perm, at = rng.permutation(pool), 0
        yield perm[at:at + batch]
        at += batch


def poisson_schedule(seed: int, rate: float, seconds: float,
                     pool: int) -> tuple:
    """An open-loop Poisson schedule with a fixed count: round(rate *
    seconds) arrival instants, uniform order statistics over [0, seconds)
    (a Poisson process given its count), and each request's clip index."""
    n = int(round(rate * seconds))
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(0.0, seconds, n)), rng.integers(0, pool, n)


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) over every value;
    inf counts as a value above all others (a request that never came)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return math.inf
    return float(v[max(int(math.ceil(q / 100.0 * v.size)), 1) - 1])
