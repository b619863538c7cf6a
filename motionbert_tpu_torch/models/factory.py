"""Backbone registry and factory (the port of ``motionbert_tpu/models/factory.py``).

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and on a machine without CUDA that raises
instead of falling back. Compute dtype is bf16 on the card and fp32 on the
CPU; the ``bf16`` config key overrides either way. Parameters stay fp32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from motionbert_tpu_torch.models.dstformer import DSTformer

_BACKBONES: Dict[str, Callable] = {}

# The published MotionBERT architecture (configs/pose3d/*): the flagship.
FLAGSHIP_CONFIG = dict(dim_in=3, dim_out=3, dim_feat=512, dim_rep=512,
                       depth=5, num_heads=8, mlp_ratio=2, num_joints=17,
                       maxlen=243)

# MotionBERT-Lite: half the width, 4x mlp_ratio.
LITE_CONFIG = dict(dim_in=3, dim_out=3, dim_feat=256, dim_rep=512,
                   depth=5, num_heads=8, mlp_ratio=4, num_joints=17,
                   maxlen=243)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; raises when a CUDA device is asked for and
    there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def default_compute_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def register_backbone(name: str):
    def deco(fn):
        _BACKBONES[name] = fn
        return fn
    return deco


def _cfg_get(args, key, default=None):
    """Read a config key from dict-like or attribute objects."""
    if hasattr(args, "get"):
        return args.get(key, default)
    return getattr(args, key, default)


@register_backbone("DSTformer")
def _dstformer(args, **overrides):
    kw = {k: _cfg_get(args, k) for k in
          ("dim_feat", "dim_rep", "depth", "num_heads", "mlp_ratio",
           "maxlen", "num_joints")}
    kw.update(dim_in=3, dim_out=3)
    kw.update(overrides)
    missing = [k for k, v in kw.items() if v is None]
    if missing:
        raise KeyError(f"backbone config is missing required key(s): "
                       f"{missing} (check the YAML spelling)")
    return DSTformer(**kw)


def load_backbone(args, dtype: Optional[torch.dtype] = None, device=None,
                  attn_impl: str = "kernel", **overrides) -> DSTformer:
    """Build the backbone named by args.backbone (default DSTformer) on
    ``device`` (None: the card), in eval mode, with uninitialised weights
    (load a state_dict, or call ``init_weights``).

    dtype=None resolves from the ``bf16`` config key when present, else bf16
    on the card and fp32 on the CPU. attn_impl "kernel" runs the pairs
    through the CUDA kernels on the card; "plain" runs their plain PyTorch
    versions (the fp32 reference)."""
    dev = resolve_device(device)
    name = _cfg_get(args, "backbone", "DSTformer")
    if name not in _BACKBONES:
        raise ValueError(f"Undefined backbone type: {name!r}; "
                         f"registered: {sorted(_BACKBONES)}")
    if dtype is None:
        bf16 = _cfg_get(args, "bf16", None)
        dtype = default_compute_dtype(dev) if bf16 is None else \
            (torch.bfloat16 if bf16 else torch.float32)
    overrides.setdefault("compute_dtype", dtype)
    overrides.setdefault("attn_impl", attn_impl)
    return _BACKBONES[name](args, **overrides).to(dev).eval()
