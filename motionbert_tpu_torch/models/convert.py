"""Weight names between the JAX package's flax params and the reference
PyTorch state_dict that the port's modules use.

The port's own copy of the mapping in ``motionbert_tpu/models/convert.py``:
- Dense ``kernel`` (in, out) <-> nn.Linear ``weight`` (out, in), transposed;
- LayerNorm ``scale`` <-> ``weight``;
- ``blocks_st_3`` <-> ``blocks_st.3`` (also ``blocks_ts``, ``ts_attn``);
- ``pre_logits`` <-> ``pre_logits.fc`` (the Tanh has no params);
- BatchNorm ``scale`` <-> ``weight``, and the ``batch_stats`` collection's
  ``mean`` / ``var`` <-> the ``running_mean`` / ``running_var`` buffers
  (ActionNet's ``head.bn``, the mesh head's ``head.bn1`` / ``head.bn2``).
So ``ts_attn_i/kernel`` (2C, 2) becomes ``ts_attn.i.weight`` (2, 2C), while
an unindexed ``ts_attn/kernel`` (2C, 2C), the gate of the legacy "parallel"
Attention or of the stage_para Block, becomes ``ts_attn.weight``. The
``backbone`` / ``head`` trees of ActionNet and of MeshRegressor become
``backbone.*`` / ``head.*``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_LIST_MODULES = ("blocks_st", "blocks_ts", "ts_attn")
_LIST_RE = re.compile(r"^(blocks_st|blocks_ts|ts_attn)_(\d+)$")
# modules whose 1-D ``weight`` is a norm scale (LayerNorm; the BatchNorms of
# ActionNet's head and of the mesh head)
_NORM_NAMES = ("norm", "norm1_s", "norm1_t", "norm2_s", "norm2_t", "bn", "bn1",
               "bn2")
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def strip_module_prefix(state_dict: Mapping[str, object]) -> Dict[str, object]:
    """Remove DataParallel 'module.' prefixes."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def _flat_paths(params, prefix=()):
    """Nested dict -> {path tuple: array}; a flat '/'-joined dict (the
    save_params_npz format) splits on '/'."""
    for k, v in params.items():
        path = prefix + tuple(str(k).split("/"))
        if isinstance(v, Mapping):
            yield from _flat_paths(v, path)
        else:
            yield path, v


def _torch_key(path: tuple) -> list:
    """A flax module path -> the torch module path, without the leaf."""
    parts = []
    for m in path:
        hit = _LIST_RE.match(m)
        if hit:
            parts += [hit.group(1), hit.group(2)]
        elif m == "pre_logits":
            parts += ["pre_logits", "fc"]
        else:
            parts.append(m)
    return parts


def state_dict_from_jax(params: Mapping,
                        batch_stats: Optional[Mapping] = None
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's params (nested numpy dicts, optionally under a
    'params' key beside a 'batch_stats' one, or a flat 'a/b/c' mapping such
    as the anchor npz) and BatchNorm statistics -> the port's torch
    state_dict, fp32 (fp16 snapshots are upcast)."""
    if "params" in params and isinstance(params["params"], Mapping):
        if batch_stats is None:
            batch_stats = params.get("batch_stats")
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        arr = np.asarray(arr)
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))

    for path, value in _flat_paths(params):
        *mods, leaf = path
        arr = np.asarray(value)
        if leaf == "kernel":
            arr, leaf = (arr.T if arr.ndim == 2 else arr), "weight"
        elif leaf == "scale":
            leaf = "weight"
        put(".".join(_torch_key(mods) + [leaf]), arr)
    for path, value in _flat_paths(batch_stats or {}):
        *mods, leaf = path
        put(".".join(_torch_key(mods) + [_STAT_LEAVES[leaf]]), value)
        if leaf == "mean":
            out[".".join(_torch_key(mods) + ["num_batches_tracked"])] = \
                torch.tensor(0, dtype=torch.long)
    return out


def jax_from_state_dict(state_dict: Mapping[str, object]) -> dict:
    """Inverse of state_dict_from_jax for the parameters: a torch
    state_dict (tensors or numpy) -> nested numpy params with flax names;
    BatchNorm buffers are left out."""
    params: dict = {}
    for key, value in strip_module_prefix(state_dict).items():
        if key.rsplit(".", 1)[-1] in _BUFFERS:
            continue
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
            else np.asarray(value)
        parts = key.split(".")
        mods, i = [], 0
        while i < len(parts) - 1:
            p = parts[i]
            if p in _LIST_MODULES and parts[i + 1].isdigit():
                mods.append(f"{p}_{parts[i + 1]}")
                i += 2
            elif p == "pre_logits" and parts[i + 1] == "fc":
                mods.append("pre_logits")
                i += 2
            else:
                mods.append(p)
                i += 1
        leaf = parts[-1]
        if leaf == "weight":
            if mods and mods[-1] in _NORM_NAMES:
                leaf = "scale"
            else:
                leaf = "kernel"
                arr = arr.T if arr.ndim == 2 else arr
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return params


def jax_batch_stats_from_state_dict(state_dict: Mapping[str, object]) -> dict:
    """The BatchNorm buffers of a torch state_dict as the JAX package's
    ``batch_stats`` collection: nested numpy ``mean`` / ``var`` leaves under
    the flax module names (the inverse of state_dict_from_jax's
    batch_stats)."""
    stats: dict = {}
    leaves = {v: k for k, v in _STAT_LEAVES.items()}
    for key, value in strip_module_prefix(state_dict).items():
        mod, _, leaf = key.rpartition(".")
        if leaf not in leaves:
            continue
        node = stats
        for m in mod.split("."):
            node = node.setdefault(m, {})
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
            else np.asarray(value)
        node[leaves[leaf]] = np.ascontiguousarray(arr)
    return stats
