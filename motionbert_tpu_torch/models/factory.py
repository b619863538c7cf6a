"""Backbone registry and factory (the port of ``motionbert_tpu/models/factory.py``).

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and on a machine without CUDA that raises
instead of falling back. Compute dtype is bf16 on the card and fp32 on the
CPU; the ``bf16`` config key overrides either way. Parameters stay fp32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from motionbert_tpu_torch.models.dstformer import ATTN_IMPLS, DSTformer

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


# The JAX package's attn_impl names, as configs carry them, onto the port's
# (models.dstformer.ATTN_IMPLS).
JAX_ATTN_IMPLS = {"pallas": "kernel", "xla": "plain", "pallas_q8": "kernel_q8",
                  "pallas_stream": "kernel_stream",
                  "pallas_stream_q8": "kernel_stream_q8"}
DEFAULT_ATTN_IMPL = "kernel"


def resolve_attn_impl(attn_impl: Optional[str], args=None) -> str:
    """The port's name for ``attn_impl``: the argument, else the config's
    ``attn_impl`` key, else "kernel"; a JAX-package name maps onto the
    port's. An unknown name raises ValueError."""
    name = attn_impl or (_cfg_get(args, "attn_impl", None)
                         if args is not None else None) or DEFAULT_ATTN_IMPL
    name = JAX_ATTN_IMPLS.get(name, name)
    if name not in ATTN_IMPLS:
        raise ValueError(
            f"unknown attn_impl {name!r}; known: {sorted(ATTN_IMPLS)}, or the "
            f"JAX package's {sorted(JAX_ATTN_IMPLS)}")
    return name


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
                  attn_impl: Optional[str] = None, **overrides) -> DSTformer:
    """Build the backbone named by args.backbone (default DSTformer) on
    ``device`` (None: the card), in eval mode, with uninitialised weights
    (load a state_dict, or call ``init_weights``).

    dtype=None resolves from the ``bf16`` config key when present, else bf16
    on the card and fp32 on the CPU. attn_impl=None resolves from the
    ``attn_impl`` config key when present, else "kernel" (see
    ``resolve_attn_impl``): "kernel" runs the pairs through the CUDA kernels
    on the card, "kernel_q8" through the W8A8 int8 kernels, "kernel_stream"
    / "kernel_stream_q8" each stream's two pairs through one stream kernel,
    and "plain" / "plain_q8" run the pairs' plain PyTorch versions (the
    references)."""
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
    overrides.setdefault("attn_impl", resolve_attn_impl(attn_impl, args))
    return _BACKBONES[name](args, **overrides).to(dev).eval()
