"""Host-side numpy transforms of the data pipelines: 2D/3D crop-and-scale
normalisation, clip slicing, and the action task's camera normalisation,
two-person tracking fix and random affine jitter.

The port's own copy of ``motionbert_tpu/geometry/transforms.py``
(``crop_scale``, ``crop_scale_3d``, ``resample``, ``split_clips``; reference
utils_data.py:7-112; ``make_cam``, ``human_tracking``, ``random_move``;
reference dataset_action.py:19-128). numpy, as in the JAX package: these run
on the host.
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


def make_cam(x, img_shape):
    """Pixels -> [-1, 1] by the larger image side (reference
    dataset_action.py:19-29). x: (M, T, V, C); img_shape: (height, width)."""
    h, w = img_shape
    return x / max(w, h) * 2 - 1


def human_tracking(x):
    """Greedy two-person identity fix by velocity (reference
    dataset_action.py:114-128): where person 0's step from the previous frame
    is better explained by person 1's previous position, the identities swap
    from there on (cumulative parity). x: (M, T, V, C)."""
    x = np.asarray(x)
    if x.shape[0] == 1:
        return x
    diff0 = np.sum(np.linalg.norm(x[0, 1:] - x[0, :-1], axis=-1), axis=-1)
    diff1 = np.sum(np.linalg.norm(x[0, 1:] - x[1, :-1], axis=-1), axis=-1)
    x_new = np.zeros(x.shape)
    sel = (np.cumsum(diff0 > diff1) % 2)[:, None, None]
    x_new[0][0] = x[0][0]
    x_new[1][0] = x[1][0]
    x_new[0, 1:] = x[1, 1:] * sel + x[0, 1:] * (1 - sel)
    x_new[1, 1:] = x[0, 1:] * sel + x[1, 1:] * (1 - sel)
    return x_new


def random_move(data, angle_range=(-10.0, 10.0), scale_range=(0.9, 1.1),
                transform_range=(-0.1, 0.1), move_time_candidate=(1,),
                rng: np.random.RandomState | None = None):
    """Smooth random affine jitter of the xy channels over time (reference
    dataset_action.py:76-112): rotation, scale and translation keyframes,
    linearly interpolated per frame. data: (M, T, V, C). The draws come in
    the JAX package's order (angles, scales, x then y shifts)."""
    r = rng if rng is not None else np.random
    data = np.asarray(data)
    T = data.shape[1]
    move_time = move_time_candidate[r.randint(len(move_time_candidate))] \
        if len(move_time_candidate) > 1 else move_time_candidate[0]
    node = np.arange(0, T, T * 1.0 / move_time).round().astype(int)
    node = np.append(node, T)
    num_node = len(node)
    A = r.uniform(angle_range[0], angle_range[1], num_node)
    S = r.uniform(scale_range[0], scale_range[1], num_node)
    T_x = r.uniform(transform_range[0], transform_range[1], num_node)
    T_y = r.uniform(transform_range[0], transform_range[1], num_node)
    a, s, t_x, t_y = (np.zeros(T) for _ in range(4))
    for i in range(num_node - 1):
        seg = slice(node[i], node[i + 1])
        n_seg = node[i + 1] - node[i]
        a[seg] = np.linspace(A[i], A[i + 1], n_seg) * np.pi / 180
        s[seg] = np.linspace(S[i], S[i + 1], n_seg)
        t_x[seg] = np.linspace(T_x[i], T_x[i + 1], n_seg)
        t_y[seg] = np.linspace(T_y[i], T_y[i + 1], n_seg)
    # per-frame 2x2 rotation-scale matrices (T, 2, 2)
    theta = np.stack(
        [np.stack([np.cos(a) * s, -np.sin(a) * s], axis=-1),
         np.stack([np.sin(a) * s, np.cos(a) * s], axis=-1)], axis=-2)
    out = data.copy()
    new_xy = np.einsum("tij,mtvj->mtvi", theta, data[..., :2])
    new_xy[..., 0] += t_x[None, :, None]
    new_xy[..., 1] += t_y[None, :, None]
    out[..., :2] = new_xy
    return out
