"""Read model weights into the port's torch state_dict.

Three formats, chosen by file name:
- ``.bin`` / ``.pth``: a reference PyTorch checkpoint, ``{'model_pos':
  state_dict, ...}`` or a bare state_dict, with or without DataParallel
  ``module.`` prefixes;
- ``.npz``: a ``save_params_npz`` snapshot of the JAX package (flat
  ``a/b/c`` keys, optional ``__meta__``; the trained anchor is one, in fp16);
- anything else: a JAX package checkpoint, a pickle of numpy params
  (``motionbert_tpu/core/checkpoint.py``), read without importing jax.
"""

from __future__ import annotations

import json
import pickle
from typing import Dict, Tuple

import numpy as np
import torch

from motionbert_tpu_torch.models.convert import (
    state_dict_from_jax, strip_module_prefix)


def load_torch_checkpoint(path: str,
                          model_key: str = "model_pos") -> Dict[str, torch.Tensor]:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt[model_key] if model_key in ckpt else \
        ckpt.get("model", ckpt.get("state_dict", ckpt))
    return {k: v.float() if v.is_floating_point() else v
            for k, v in strip_module_prefix(sd).items()
            if isinstance(v, torch.Tensor)}


def load_params_npz(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state_dict, meta) from a save_params_npz snapshot."""
    with np.load(path) as z:
        meta = json.loads(z["__meta__"].tobytes().decode()) \
            if "__meta__" in z.files else {}
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return state_dict_from_jax(flat), meta


class _Opaque:
    """Stands in for any class outside numpy and the builtins while a JAX
    checkpoint is unpickled (optax states, for example): the port reads only
    the params, which are plain dicts of numpy arrays."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _ParamsUnpickler(pickle.Unpickler):
    _ALLOWED = ("numpy", "builtins", "collections", "copyreg", "_codecs")

    def find_class(self, module, name):
        if module.split(".")[0] in self._ALLOWED:
            return super().find_class(module, name)
        if name == "FrozenDict":
            return dict
        return _Opaque


def load_jax_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The params of a JAX package checkpoint payload as a state_dict."""
    with open(path, "rb") as f:
        payload = _ParamsUnpickler(f).load()
    return state_dict_from_jax(payload["params"])


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Weights from any of the three formats, as the port's state_dict."""
    if path.endswith((".bin", ".pth")):
        return load_torch_checkpoint(path)
    if path.endswith(".npz"):
        return load_params_npz(path)[0]
    return load_jax_checkpoint(path)
