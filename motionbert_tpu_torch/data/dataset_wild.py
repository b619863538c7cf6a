"""In-the-wild input: AlphaPose (Halpe-26) JSON detections -> H36M clips.

The port of ``motionbert_tpu/data/dataset_wild.py`` (reference
lib/data/dataset_wild.py), numpy on the host. Reads the detector JSON,
keeps one tracked person when ``focus`` is given, remaps Halpe-26 ->
H36M-17, normalises to [-1, 1] by the video size or by the confidence-aware
``crop_scale``, and cuts the stream into consecutive ``clip_len`` windows.
"""

from __future__ import annotations

import json
import math
from typing import Optional, Sequence

import numpy as np

from motionbert_tpu_torch.geometry.skeleton import halpe2h36m
from motionbert_tpu_torch.geometry.transforms import crop_scale


def read_input(json_path: str, vid_size: Optional[Sequence[float]],
               scale_range, focus: Optional[int]) -> np.ndarray:
    """(T, 17, 3) fp32 motion (x, y, confidence) from an AlphaPose result
    file: one entry per detection, ``keypoints`` a flat list of 26 x 3."""
    with open(json_path, "r") as f:
        results = json.load(f)
    kpts_all = np.array([np.array(item["keypoints"]).reshape(-1, 3)
                         for item in results
                         if focus is None or item["idx"] == focus])
    kpts_all = halpe2h36m(kpts_all)
    motion = kpts_all
    if vid_size:
        w, h = vid_size
        kpts_all[:, :, :2] = (kpts_all[:, :, :2] - np.array([w, h]) / 2.0) \
            / (min(w, h) / 2.0)
    if scale_range:
        motion = crop_scale(kpts_all, scale_range)
    return motion.astype(np.float32)


class WildDetDataset:
    """Consecutive clips of a detection stream: item i is frames
    [i * clip_len, (i + 1) * clip_len) as (T <= clip_len, 17, 3) numpy; the
    last clip may be shorter (the model takes any F <= maxlen)."""

    def __init__(self, json_path: str, clip_len: int = 243, vid_size=None,
                 scale_range=None, focus: Optional[int] = None):
        self.json_path = json_path
        self.clip_len = clip_len
        self.vid_all = read_input(json_path, vid_size, scale_range, focus)

    def __len__(self) -> int:
        return math.ceil(len(self.vid_all) / self.clip_len)

    def __getitem__(self, index: int) -> np.ndarray:
        st = index * self.clip_len
        return self.vid_all[st:min(st + self.clip_len, len(self.vid_all))]
