"""The 2D corruption model of pretraining, on the batch's device.

The port of ``motionbert_tpu/data/augment.py`` (reference
lib/data/augmentation.py:10-99, Augmenter2D). The corruption makes
ground-truth 2D keypoints look like a detector's output:

- mixture noise per joint: a per-joint Gaussian (learned mean and std) or a
  uniform (+-uniform_range / 2), chosen by learned per-joint weights, drawn
  on 27 keyframes and interpolated linearly over the T frames (align_corners
  semantics), plus a small per-frame Gaussian jitter shared by the batch;
- a confidence synthesised from the displacement, f = a / (d + a) + b d plus
  a Gaussian shift (``d2c_params.pkl``), clipped to [0, 1];
- masking: a keep mask per (clip, frame, joint) and one per frame.

Every draw comes from the ``torch.Generator`` the caller passes, on that
generator's device, in a fixed order (noise: selector, Gaussian, uniform,
frame jitter, confidence shift; mask: joints, frames), so a saved generator
state reproduces the corruption. The per-clip draws are taken at the global
batch's size under data parallelism (``parallel.mesh.rank_draw``); the
frame jitter and the frame mask are shared by the batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from motionbert_tpu_torch.core.config import read_pkl
from motionbert_tpu_torch.parallel.mesh import rank_draw

NUM_KEYFRAMES = 27
FRAME_NOISE_STD = 0.002


@dataclass(frozen=True)
class NoiseParams:
    """The learned detector-noise model (``params/synthetic_noise.npz`` and
    ``params/d2c_params.pkl``)."""

    mean: np.ndarray          # (17, 2)
    std: np.ndarray           # (17, 2)
    weight: np.ndarray        # (17,) mixture weight: P(Gaussian)
    uniform_range: float      # total width of the uniform component
    a: float                  # displacement -> confidence parameters
    b: float
    m: float
    s: float

    @classmethod
    def load(cls, noise_path: str, d2c_params_path: str) -> "NoiseParams":
        """From an ``.npz`` (``params/synthetic_noise.npz``) or the
        reference's ``synthetic_noise.pth`` (a dict of tensors and numbers,
        read with ``torch.load(weights_only=True)``), and the d2c pickle."""
        d2c = read_pkl(d2c_params_path)
        if noise_path.endswith(".npz"):
            z = np.load(noise_path)
            noise = {k: z[k] for k in z.files}
        else:
            noise = {k: v.numpy() if isinstance(v, torch.Tensor) else v
                     for k, v in torch.load(noise_path, map_location="cpu",
                                            weights_only=True).items()}
        return cls(
            mean=np.asarray(noise["mean"], np.float32),
            std=np.asarray(noise["std"], np.float32),
            weight=np.asarray(noise["weight"], np.float32),
            uniform_range=float(noise.get("uniform_range", 0.06)),
            a=float(d2c["a"]), b=float(d2c["b"]),
            m=float(d2c["m"]), s=float(d2c["s"]))


def _uniform(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device,
                      dtype=torch.float32)


def _normal(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32)


def _interp_keyframes(delta: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Linear interpolation (B, K, J, 2) -> (B, T, J, 2) along the keyframe
    axis with align_corners semantics: what the reference's trilinear
    F.interpolate does when only that axis resizes."""
    K = delta.shape[1]
    pos = torch.linspace(0.0, K - 1.0, num_frames, device=delta.device,
                         dtype=torch.float32)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, max=K - 1)
    w = (pos - lo)[None, :, None, None]
    return delta[:, lo] * (1 - w) + delta[:, hi] * w


def dis2conf(generator: torch.Generator, dis: torch.Tensor,
             p: NoiseParams) -> torch.Tensor:
    """Displacement -> confidence with a Gaussian shift (reference
    augmentation.py:22-27)."""
    f = p.a / (dis + p.a) + p.b * dis
    return f + (rank_draw(_normal, dis.shape, generator) * p.s + p.m)


def add_noise(generator: torch.Generator, motion_2d: torch.Tensor,
              p: NoiseParams) -> torch.Tensor:
    """Corrupt the xy of motion_2d (N, T, J, >= 2) and synthesise the
    confidence: returns (N, T, J, 3)."""
    xy = motion_2d[..., :2]
    N, T, J = xy.shape[:3]
    dev = xy.device
    mean = torch.from_numpy(p.mean).to(dev)
    std = torch.from_numpy(p.std).to(dev)
    weight = torch.from_numpy(p.weight).to(dev)[:, None]  # (J, 1)

    sel = rank_draw(_uniform, (N, NUM_KEYFRAMES, J, 1), generator)
    gaussian = rank_draw(_normal, (N, NUM_KEYFRAMES, J, 2), generator) * std \
        + mean
    uniform = (rank_draw(_uniform, (N, NUM_KEYFRAMES, J, 2), generator)
               - 0.5) * p.uniform_range
    delta = torch.where(sel < weight, gaussian, uniform)
    delta = _interp_keyframes(delta, T)
    delta = delta + _normal((T, J, 2), generator) * FRAME_NOISE_STD

    noisy = xy + delta
    dis = torch.sqrt((delta * delta).sum(-1))
    conf = dis2conf(generator, dis, p).clamp(0, 1)[..., None]
    return torch.cat([noisy, conf], dim=-1)


def add_mask(generator: torch.Generator, x: torch.Tensor, mask_ratio: float,
             mask_T_ratio: float) -> torch.Tensor:
    """Random joint and frame masking (reference augmentation.py:67-74)."""
    N, T, J, _ = x.shape
    mask = rank_draw(_uniform, (N, T, J, 1), generator) > mask_ratio
    mask_T = _uniform((1, T, 1, 1), generator) > mask_T_ratio
    return x * mask * mask_T


def augment2d(generator: torch.Generator, motion_2d: torch.Tensor,
              p: Optional[NoiseParams], noise: bool, mask: bool,
              mask_ratio: float = 0.0,
              mask_T_ratio: float = 0.0) -> torch.Tensor:
    """The whole corruption (reference augmentation.py:76-81) of a batch on
    the generator's device."""
    if noise:
        motion_2d = add_noise(generator, motion_2d, p)
    if mask:
        motion_2d = add_mask(generator, motion_2d, mask_ratio, mask_T_ratio)
    return motion_2d
