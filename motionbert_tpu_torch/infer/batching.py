"""Batched inference over variable-length clip lists (the port of
``motionbert_tpu/infer/batching.py``).

Same-length clips are grouped into fixed-size batches, the tail group padded
by repeating its last clip; results come back per clip as writable numpy.
Results may be tensors, numpy arrays, or dicts, lists and tuples of them.
"""

from __future__ import annotations

import numpy as np
import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def stack_padded(clips, size: int) -> np.ndarray:
    """Stack same-shape (T, ...) clips into a (size, T, ...) batch, padding
    short groups by repeating the last clip (unstack_result drops the
    padding rows on the way out)."""
    batch = np.stack(clips)
    if len(clips) < size:
        batch = np.concatenate(
            [batch, np.repeat(batch[-1:], size - len(clips), 0)])
    return batch


def fetch_result(res):
    """One device -> host copy per output leaf, before per-clip unstacking."""
    return _tree_map(_to_numpy, res)


def unstack_result(res, k: int):
    """Batch element k of a host-fetched result, as writable numpy."""
    return _tree_map(lambda a: np.array(a[k]), res)


def run_batched(clips, batch_size: int, fn):
    """Apply fn((B, T, ...)) -> result with a leading batch dim over a list of
    (T_i, ...) clips; returns the per-clip results in input order."""
    clips = list(clips)
    by_len: dict = {}
    for i, c in enumerate(clips):
        by_len.setdefault(c.shape[0], []).append(i)
    out = [None] * len(clips)
    for _, idxs in sorted(by_len.items(), reverse=True):
        bs = min(batch_size, len(idxs))
        for s in range(0, len(idxs), bs):
            grp = idxs[s:s + bs]
            res = fetch_result(fn(stack_padded([clips[j] for j in grp], bs)))
            for k, j in enumerate(grp):
                out[j] = unstack_result(res, k)
    return out
