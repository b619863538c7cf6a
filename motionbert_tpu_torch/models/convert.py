"""Weight names between the JAX package's flax params and the reference
PyTorch state_dict that the port's modules use.

The port's own copy of the mapping in ``motionbert_tpu/models/convert.py``:
- Dense ``kernel`` (in, out) <-> nn.Linear ``weight`` (out, in), transposed;
- LayerNorm ``scale`` <-> ``weight``;
- ``blocks_st_3`` <-> ``blocks_st.3`` (also ``blocks_ts``, ``ts_attn``);
- ``pre_logits`` <-> ``pre_logits.fc`` (the Tanh has no params).
So ``ts_attn_i/kernel`` (2C, 2) becomes ``ts_attn.i.weight`` (2, 2C).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LIST_MODULES = ("blocks_st", "blocks_ts", "ts_attn")
_LIST_RE = re.compile(r"^(blocks_st|blocks_ts|ts_attn)_(\d+)$")
_LN_NAMES = ("norm", "norm1_s", "norm1_t", "norm2_s", "norm2_t")


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


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's params (nested numpy dicts, optionally under a
    'params' key, or a flat 'a/b/c' mapping such as the anchor npz) -> the
    port's torch state_dict, fp32 (fp16 snapshots are upcast)."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flat_paths(params):
        *mods, leaf = path
        parts = []
        for m in mods:
            hit = _LIST_RE.match(m)
            if hit:
                parts += [hit.group(1), hit.group(2)]
            elif m == "pre_logits":
                parts += ["pre_logits", "fc"]
            else:
                parts.append(m)
        arr = np.asarray(value)
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        if leaf == "kernel":
            arr, leaf = (arr.T if arr.ndim == 2 else arr), "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(parts + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def jax_from_state_dict(state_dict: Mapping[str, object]) -> dict:
    """Inverse of state_dict_from_jax: a torch state_dict (tensors or numpy)
    -> nested numpy params with flax names."""
    params: dict = {}
    for key, value in strip_module_prefix(state_dict).items():
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
            if mods and mods[-1] in _LN_NAMES:
                leaf = "scale"
            else:
                leaf = "kernel"
                arr = arr.T if arr.ndim == 2 else arr
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return params
