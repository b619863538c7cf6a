"""Pose3D task: the flip-averaged evaluation step (reference train.py:66-72).

Training and the H36M evaluation protocol are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from motionbert_tpu_torch.geometry.skeleton import flip_data


def make_eval_step(model: torch.nn.Module, *, no_conf: bool,
                   flip_tta: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """step(batch_input (B, F, J, 3)) -> fp32 prediction (B, F, J, 3). With
    flip_tta the clip is also run mirrored, as a second forward, and the two
    are averaged in fp32: (pred + flip(pred_flip)) / 2."""

    @torch.inference_mode()
    def eval_step(batch_input: torch.Tensor) -> torch.Tensor:
        if no_conf:
            batch_input = batch_input[..., :2]
        pred = model(batch_input).float()
        if flip_tta:
            pred_flip = model(flip_data(batch_input)).float()
            pred = (pred + flip_data(pred_flip)) / 2
        return pred

    return eval_step
