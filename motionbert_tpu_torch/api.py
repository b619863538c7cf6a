"""High-level public API, the port of ``motionbert_tpu/api.py``:

    from motionbert_tpu_torch.api import MotionBERT
    mb = MotionBERT.from_config("configs/pose3d/MB_ft_h36m.yaml",
                                checkpoint="best_epoch.bin")  # or .npz / JAX .ckpt
    rep = mb.get_representation(motion_2d)  # (B, F<=243, 17, 3) -> (B, F, 17, 512)
    pose3d = mb.lift(motion_2d)             # flip-TTA 2D -> 3D lifting

Inputs follow the H36M-17 joint format with channels (x, y, confidence) in
[-1, 1] normalized coordinates. Outputs are fp32 numpy arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from motionbert_tpu_torch.core.checkpoint import load_state_dict
from motionbert_tpu_torch.core.config import get_config
from motionbert_tpu_torch.core.profiling import annotate
from motionbert_tpu_torch.models.factory import load_backbone
from motionbert_tpu_torch.train.pose3d import make_eval_step


class MotionBERT:
    def __init__(self, model: torch.nn.Module, maxlen: int = 243):
        self.model = model
        self.maxlen = maxlen
        self.device = next(model.parameters()).device
        self._lift_steps = {}  # flip_tta -> eval step

    @classmethod
    def from_config(cls, config_path: str, checkpoint: Optional[str] = None,
                    device=None,
                    attn_impl: Optional[str] = None) -> "MotionBERT":
        """Build the configured backbone on ``device`` (None: the card; raises
        when there is none). Without a checkpoint the weights get the
        reference initialisation from a generator seeded with 0. attn_impl
        None takes the config's ``attn_impl`` key (``models.factory``):
        "kernel_q8", or ``attn_impl: pallas_q8`` in the config, serves from
        the W8A8 tier on the same checkpoint."""
        args = get_config(config_path)
        model = load_backbone(args, device=device, attn_impl=attn_impl)
        if checkpoint:
            model.load_state_dict(load_state_dict(checkpoint), strict=True)
        else:
            model.init_weights(torch.Generator().manual_seed(0))
        return cls(model, maxlen=args.maxlen)

    def _check(self, x) -> torch.Tensor:
        x = np.asarray(x, np.float32)
        if x.ndim == 3:
            x = x[None]
        if x.ndim != 4 or x.shape[2] != 17 or x.shape[3] != 3:
            raise ValueError(
                f"expected (B, F, 17, 3) H36M-17 motion, got {x.shape}")
        if x.shape[1] > self.maxlen:
            raise ValueError(
                f"clip length {x.shape[1]} exceeds maxlen {self.maxlen}; "
                f"chunk long videos into <= {self.maxlen}-frame windows")
        return torch.from_numpy(x).to(self.device)

    def get_representation(self, x) -> np.ndarray:
        """(B, F<=maxlen, 17, 3) -> (B, F, 17, dim_rep) motion embedding
        (reference DSTformer.get_representation)."""
        with torch.inference_mode():
            rep = self.model(self._check(x), return_rep=True)
        return rep.float().cpu().numpy()

    def lift(self, x, flip_tta: bool = True, rootrel: bool = True) -> np.ndarray:
        """2D keypoints -> 3D pose with optional flip test-time averaging."""
        if flip_tta not in self._lift_steps:
            self._lift_steps[flip_tta] = make_eval_step(
                self.model, no_conf=False, flip_tta=flip_tta)
        step = self._lift_steps[flip_tta]
        with annotate("lift.h2d"):
            x = self._check(x)
        with annotate("lift.forward", device=True, rows=int(x.shape[0])):
            pred = step(x)
        with annotate("lift.d2h"):
            pred = pred.cpu().numpy()
            if rootrel:
                pred[:, :, 0, :] = 0
        return pred
