"""Model weights into the port's torch state_dict, and the port's own
training checkpoints.

Four formats are read, chosen by file name and content:
- ``.bin`` / ``.pth``: a reference PyTorch checkpoint, ``{'model_pos':
  state_dict, ...}`` or a bare state_dict, with or without DataParallel
  ``module.`` prefixes;
- ``.npz``: a ``save_params_npz`` snapshot of the JAX package (flat
  ``a/b/c`` keys, optional ``__meta__``; the trained anchor is one, in fp16);
- a zip archive (what ``torch.save`` writes) under any other name: the
  port's own checkpoint (``CheckpointManager`` below);
- anything else: a JAX package checkpoint, a pickle of numpy params
  (``motionbert_tpu/core/checkpoint.py``), read without importing jax; its
  params cross over, and the BatchNorm statistics of an action or mesh
  checkpoint (``batch_stats``, in ``extra_vars`` or beside ``params``)
  become the ``running_mean`` / ``running_var`` buffers; its optax state
  does not map onto torch's.

``CheckpointManager`` keeps the reference's file roles (train.py:46-54,
364-374): ``latest_epoch.ckpt`` every epoch, ``epoch_{n}.ckpt`` every
``checkpoint_frequency`` epochs, ``best_epoch.ckpt`` on improvement. Its
payload: the model's state_dict (BatchNorm buffers included), the
optimizer's state_dict (with each parameter group's learning rate: the
action tasks' backbone and head groups), lr, the epoch to resume from
(epoch + 1), the best metric (P1 error, or top-1 accuracy), and the state of
the train step's generator, so that a resumed run draws the flips and masks
the uninterrupted run would have (the JAX package stores its PRNG key
there). Under tensor parallelism the payload holds whole tensors, as the JAX
checkpoint host-ifies its shards: the model's (its ``state_dict()`` gathers,
``parallel.mesh.gather_params``) and AdamW's moments
(``gather_optimizer_state``). A checkpoint written at any grid resumes at
any other: load the model's whole weights, ``shard_params`` it (before or
after), and load ``shard_optimizer_state`` of the optimizer's state into an
optimizer over the sharded parameters.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import zipfile
from typing import Dict, Optional, Tuple

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
    """The params and BatchNorm statistics of a JAX package checkpoint
    payload as a state_dict."""
    with open(path, "rb") as f:
        payload = _ParamsUnpickler(f).load()
    stats = (payload.get("extra_vars") or {}).get("batch_stats",
                                                  payload.get("batch_stats"))
    return state_dict_from_jax(payload["params"], stats)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Weights from any of the four formats, as the port's state_dict."""
    if path.endswith((".bin", ".pth")):
        return load_torch_checkpoint(path)
    if path.endswith(".npz"):
        return load_params_npz(path)[0]
    if is_port_checkpoint(path):
        return load_checkpoint(path)["model"]
    return load_jax_checkpoint(path)


def is_port_checkpoint(path: str) -> bool:
    """True for a file that ``CheckpointManager`` wrote (a ``torch.save``
    zip archive not named like a reference ``.bin``/``.pth``)."""
    return not path.endswith((".bin", ".pth")) and zipfile.is_zipfile(path)


def load_checkpoint(path: str) -> dict:
    """A payload that ``CheckpointManager`` wrote, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _write_bytes(path: str, blob: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)  # atomic publish


class CheckpointManager:
    """The reference's checkpoint roles in one directory."""

    LATEST = "latest_epoch.ckpt"
    BEST = "best_epoch.ckpt"

    def __init__(self, directory: str, frequency: int = 1):
        self.dir = directory
        self.frequency = max(int(frequency), 1)
        os.makedirs(directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    @property
    def latest_path(self) -> str:
        return self.path(self.LATEST)

    def has_latest(self) -> bool:
        return os.path.exists(self.latest_path)

    def save_epoch(self, epoch: int, lr: float, model: torch.nn.Module,
                   optimizer: Optional[torch.optim.Optimizer] = None,
                   best_metric=None, improved: bool = False,
                   rng: Optional[torch.Tensor] = None) -> None:
        """Write latest (always), epoch_{epoch} (when (epoch + 1) is a
        multiple of the frequency) and best (if improved). The payload
        records epoch + 1, the epoch a resumed run starts from
        (reference train.py:49, 297). One serialisation, written up to
        three times, by rank 0. A tensor-parallel model's weights and
        optimizer state are gathered whole first: then every rank calls
        this (the gathers are collectives)."""
        from motionbert_tpu_torch.parallel.mesh import (
            gather_optimizer_state, gather_params, is_main)

        state = gather_params(model)
        opt_state = None if optimizer is None else \
            gather_optimizer_state(optimizer, model)
        if not is_main():
            return
        buf = io.BytesIO()
        torch.save({
            "epoch": epoch + 1,
            "lr": float(lr),
            "model": {k: v.detach().cpu() for k, v in state.items()},
            "optimizer": opt_state,
            "best_metric": best_metric,
            "rng": None if rng is None else rng.cpu(),
        }, buf)
        blob = buf.getvalue()
        _write_bytes(self.latest_path, blob)
        if (epoch + 1) % self.frequency == 0:
            _write_bytes(self.path(f"epoch_{epoch}.ckpt"), blob)
        if improved:
            _write_bytes(self.path(self.BEST), blob)
