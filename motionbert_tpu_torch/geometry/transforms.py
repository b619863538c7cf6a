"""Host-side numpy transforms of the pose3d data pipeline: 2D/3D crop-and-scale
normalisation and clip slicing.

The port's own copy of ``motionbert_tpu/geometry/transforms.py``
(``crop_scale``, ``crop_scale_3d``, ``resample``, ``split_clips``; reference
utils_data.py:7-112). numpy, as in the JAX package: these run on the host.
"""

from __future__ import annotations

import numpy as np


def crop_scale(motion, scale_range=(1, 1),
               rng: np.random.RandomState | None = None):
    """Normalise 2D keypoints-with-confidence ((M,) T, 17, 3), channel 2 the
    confidence, to [-1, 1]: the bounding square of the joints with conf != 0,
    scaled by a random ratio in ``scale_range`` (reference
    utils_data.py:7-29, with its zero outputs for degenerate input and the
    final clip)."""
    motion = np.asarray(motion)
    result = motion.copy()
    valid_coords = motion[motion[..., 2] != 0][:, :2]
    if len(valid_coords) < 4:
        return np.zeros(motion.shape)
    xmin, ymin = valid_coords.min(axis=0)
    xmax, ymax = valid_coords.max(axis=0)
    rand = rng.uniform if rng is not None else np.random.uniform
    ratio = rand(low=scale_range[0], high=scale_range[1], size=1)[0]
    scale = max(xmax - xmin, ymax - ymin) * ratio
    if scale == 0:
        return np.zeros(motion.shape)
    xs = (xmin + xmax - scale) / 2
    ys = (ymin + ymax - scale) / 2
    result[..., :2] = (motion[..., :2] - [xs, ys]) / scale
    result[..., :2] = (result[..., :2] - 0.5) * 2
    return np.clip(result, -1, 1)


def crop_scale_3d(motion, scale_range=(1, 1),
                  rng: np.random.RandomState | None = None):
    """Normalise a 3D motion (T, 17, 3) to [-1, 1], z relative to the first
    frame's root (reference utils_data.py:31-52: divides by the ratio, and
    the final shift applies to z as well)."""
    motion = np.asarray(motion)
    result = motion.copy()
    result[:, :, 2] = result[:, :, 2] - result[0, 0, 2]
    xmin, xmax = motion[..., 0].min(), motion[..., 0].max()
    ymin, ymax = motion[..., 1].min(), motion[..., 1].max()
    rand = rng.uniform if rng is not None else np.random.uniform
    ratio = rand(low=scale_range[0], high=scale_range[1], size=1)[0]
    scale = max(xmax - xmin, ymax - ymin) / ratio
    if scale == 0:
        return np.zeros(motion.shape)
    xs = (xmin + xmax - scale) / 2
    ys = (ymin + ymax - scale) / 2
    result[..., :2] = (motion[..., :2] - [xs, ys]) / scale
    result[..., 2] = result[..., 2] / scale
    return (result - 0.5) * 2


def resample(ori_len: int, target_len: int, replay=False, randomness=True,
             rng: np.random.RandomState | None = None):
    """Indices mapping a length-``ori_len`` stream to ``target_len`` frames
    (reference utils_data.py:68-89): a random crop or modulo replay with
    ``replay``; a jittered linspace with ``randomness``; else an integer
    linspace without the end point."""
    r = rng if rng is not None else np.random
    if replay:
        if ori_len > target_len:
            st = r.randint(ori_len - target_len)
            return np.arange(st, st + target_len)
        return np.arange(target_len) % ori_len
    if randomness:
        even = np.linspace(0, ori_len, num=target_len, endpoint=False)
        if ori_len < target_len:
            low = np.floor(even)
            high = np.ceil(even)
            sel = r.randint(2, size=even.shape)
            result = np.sort(sel * low + (1 - sel) * high)
        else:
            interval = even[1] - even[0]
            result = r.random(even.shape) * interval + even
        return np.clip(result, a_min=0, a_max=ori_len - 1).astype(np.uint32)
    return np.linspace(0, ori_len, num=target_len, endpoint=False, dtype=int)


def split_clips(vid_list, n_frames: int, data_stride: int,
                rng: np.random.RandomState | None = None):
    """Slice a frame stream with per-frame video ids into clips of n_frames
    with stride data_stride, video-boundary-aware, resampling the tail of a
    video whose remainder never filled a clip (reference utils_data.py:91-112;
    the eval protocol depends on this exact index logic). Returns a list of
    index ranges/arrays, each of length n_frames."""
    result = []
    st = 0
    i = 0
    saved = set()
    n = len(vid_list)
    while i < n:
        i += 1
        if i - st == n_frames:
            result.append(range(st, i))
            saved.add(vid_list[i - 1])
            st = st + data_stride
        if i == n:
            break
        if vid_list[i] != vid_list[i - 1]:
            if vid_list[i - 1] not in saved:
                resampled = resample(i - st, n_frames, rng=rng) + st
                result.append(resampled)
                saved.add(vid_list[i - 1])
            st = i
    return result
