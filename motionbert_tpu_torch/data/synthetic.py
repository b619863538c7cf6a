"""Synthetic H36M data in the on-disk formats the pose3d driver reads: the
source pickle (the layout of ``h36m_sh_conf_cam_source_final.pkl``) and the
file-per-clip MB3D directory cut from it.

The port's own numpy copy of ``tools/make_synthetic_data.py``'s
``make_h36m_pickle`` and ``tools/convert_h36m.py``'s ``convert_h36m``: the
same draws in the same order from the same seeds, so both write equal
arrays. With ``learnable_z`` the depth channel is a fixed linear function of
the clean 2D pose, shared by every pickle of the family, so that lifting is
solvable and a trained model's error falls to the tens of millimetres
(``train/anchor.py`` trains on such a set).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

H36M_CAMERAS = ["54138969", "60457274", "55011271", "58860488"]
ACTIONS = ["Directions", "Sitting", "Walking"]

# the seed of the learnable-z map: a constant of the dataset family, apart
# from each pickle's own seed, so a model trained on one pickle's train
# split generalises to another pickle's test split
LEARNABLE_Z_SEED = 20260819
_MOTION_CENTER_XY = np.asarray([500.0, 500.0])
_MOTION_SCALE = 80.0


def _learnable_z_map() -> np.ndarray:
    """(34, 17) float64: the centred 17 x 2 pose onto 17 depths, scaled so
    that depth moves as much as the default generator's 0.3 * scale."""
    rng = np.random.RandomState(LEARNABLE_Z_SEED)
    return rng.normal(0.0, 0.3 * _MOTION_SCALE / np.sqrt(34.0),
                      (34, 17)).astype(np.float64)


def _smooth_motion(rng, n_frames, n_joints=17, dim=3, scale=80.0,
                   center=(500.0, 500.0, 0.0)) -> np.ndarray:
    """Smooth random joint trajectories: a sum of low-frequency sinusoids
    about a random rest pose."""
    t = np.linspace(0, 2 * np.pi, n_frames)[:, None, None]
    phases = rng.uniform(0, 2 * np.pi, (1, n_joints, dim))
    freqs = rng.uniform(0.5, 2.0, (1, n_joints, dim))
    base = rng.uniform(-1, 1, (1, n_joints, dim)) * scale
    motion = base + 0.3 * scale * np.sin(freqs * t + phases)
    return motion + np.asarray(center)[:dim]


def make_h36m_pickle(path, n_frames_per_video=64, seed=0,
                     include_blocked=True, learnable_z=False,
                     train_subjects=(1, 5), train_videos=3) -> dict:
    """Write a synthetic pickle with the H36M source file's layout to
    ``path`` and return it: a train split of ``train_videos`` videos per
    subject in ``train_subjects`` and a test split of 3 videos of subjects
    9 and 11 (one of them named like a source of the evaluation's block
    list with ``include_blocked``). Videos run ``n_frames_per_video`` plus
    0, 7 or 14 frames."""
    rng = np.random.RandomState(seed)
    z_map = _learnable_z_map() if learnable_z else None

    def make_split(subjects, n_videos):
        joint_2d, conf, joint3d, factor, cams, sources, actions = \
            [], [], [], [], [], [], []
        vid = 0
        for s in subjects:
            for a_idx in range(n_videos):
                action = ACTIONS[a_idx % len(ACTIONS)]
                cam = H36M_CAMERAS[vid % len(H36M_CAMERAS)]
                if include_blocked and s == 9 and a_idx == 0:
                    src = "s_09_act_05_subact_02_ca_%02d" % (vid % 4 + 1)
                else:
                    src = "s_%02d_act_%02d_subact_01_ca_%02d" % (
                        s, a_idx + 2, vid % 4 + 1)
                n = n_frames_per_video + (vid % 3) * 7
                m3d = _smooth_motion(rng, n)
                if z_map is not None:
                    xy_c = (m3d[..., :2] - _MOTION_CENTER_XY) / _MOTION_SCALE
                    m3d[..., 2] = xy_c.reshape(n, 34) @ z_map
                m3d[..., 2] += rng.uniform(100, 200)
                joint3d.append(m3d)
                joint_2d.append(m3d[..., :2] + rng.normal(0, 2, (n, 17, 2)))
                conf.append(rng.uniform(0.5, 1.0, (n, 17)))
                factor.append(np.full(n, rng.uniform(8, 12)))
                cams += [cam] * n
                sources += [src] * n
                actions += [action] * n
                vid += 1
        joint3d = np.concatenate(joint3d).astype(np.float32)
        factor = np.concatenate(factor).astype(np.float32)
        return {
            "joint_2d": np.concatenate(joint_2d).astype(np.float32),
            "confidence": np.concatenate(conf).astype(np.float32),
            "joint3d_image": joint3d,
            "joints_2.5d_image": joint3d * factor[:, None, None],
            "2.5d_factor": factor,
            "camera_name": np.array(cams),
            "source": np.array(sources, dtype=object),
            "action": np.array(actions, dtype=object),
        }

    data = {"train": make_split(list(train_subjects), train_videos),
            "test": make_split([9, 11], 3)}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return data


def convert_h36m(dt_root, dt_file, out_root, n_frames=243, data_stride=81,
                 sample_stride=1) -> tuple:
    """Slice ``<dt_root>/<dt_file>`` into ``<out_root>/{train,test}/%08d.pkl``
    clips of ``n_frames`` (train at ``data_stride``, test without overlap),
    each ``{"data_input", "data_label"}``, through the port's
    ``DataReaderH36M``. Returns the (train, test) clip counts."""
    from motionbert_tpu_torch.data.readers import DataReaderH36M

    reader = DataReaderH36M(
        n_frames=n_frames, sample_stride=sample_stride,
        data_stride_train=data_stride, data_stride_test=n_frames,
        dt_root=dt_root, dt_file=dt_file)
    train_data, test_data, train_labels, test_labels = reader.get_sliced_data()
    for split, data, labels in (("train", train_data, train_labels),
                                ("test", test_data, test_labels)):
        if len(data) != len(labels):
            raise ValueError(f"{split}: {len(data)} inputs, "
                             f"{len(labels)} labels")
        out_dir = os.path.join(out_root, split)
        os.makedirs(out_dir, exist_ok=True)
        for i in range(len(data)):
            with open(os.path.join(out_dir, "%08d.pkl" % i), "wb") as f:
                pickle.dump({"data_input": data[i], "data_label": labels[i]},
                            f)
    return len(train_data), len(test_data)
