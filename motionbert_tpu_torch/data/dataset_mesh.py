"""Mesh recovery datasets: 2D clips with SMPL ground truth synthesised on
the host.

The port of ``motionbert_tpu/data/dataset_mesh.py`` (reference
lib/data/dataset_mesh.py). Per clip: the normalised 2D detections (T, 17, 3)
and the SMPL pose and shape; the ground-truth vertices and the 17 joints
regressed from them come from the numpy SMPL forward in fp32, root-relative,
in mm. A training clip is flipped with probability 1/2: the 2D and the
thetas together (``flip_data_np``, ``flip_thetas_np``), drawn from the
per-(epoch, index) RNG of ``EpochSeededRNG``, so a batch gathered by
``get_batch`` (which ``BatchLoader`` picks up) equals the same items taken
one at a time.
"""

from __future__ import annotations

import numpy as np

from motionbert_tpu_torch.data.datasets import EpochSeededRNG
from motionbert_tpu_torch.data.readers import DataReaderH36M, DataReaderMesh
from motionbert_tpu_torch.geometry.rotations import flip_thetas_np
from motionbert_tpu_torch.geometry.skeleton import flip_data_np
from motionbert_tpu_torch.models.smpl import SMPLModel, smpl_forward_np


class SMPLDataset:
    """The 2D clips and SMPL parameters of one split of one mesh dataset:
    "h36m" (the H36M reader), "coco" (single frames, 640 x 640) or "pw3d"
    (1920 x 1920). ``smpl_model`` on the CPU."""

    def __init__(self, args, data_split: str, dataset: str,
                 smpl_model: SMPLModel):
        if data_split not in ("train", "test"):
            raise ValueError(f"Data split unknown: {data_split!r}")
        self.clip_len = args.clip_len
        self.data_split = data_split
        self.smpl = smpl_model
        if dataset == "h36m":
            reader = DataReaderH36M(
                n_frames=self.clip_len, sample_stride=args.sample_stride,
                data_stride_train=args.data_stride,
                data_stride_test=self.clip_len, dt_root=args.data_root,
                dt_file=args.dt_file_h36m)
        elif dataset == "coco":
            reader = DataReaderMesh(
                n_frames=1, sample_stride=args.sample_stride,
                data_stride_train=1, data_stride_test=1,
                dt_root=args.data_root, dt_file=args.dt_file_coco,
                res=(640, 640))
        elif dataset == "pw3d":
            reader = DataReaderMesh(
                n_frames=self.clip_len, sample_stride=args.sample_stride,
                data_stride_train=args.data_stride,
                data_stride_test=self.clip_len, dt_root=args.data_root,
                dt_file=args.dt_file_pw3d, res=(1920, 1920))
        else:
            raise ValueError(f"Mesh dataset undefined: {dataset}")
        split_train, split_test = reader.get_split_id()
        train_data, test_data = reader.read_2d()
        train = data_split == "train"
        split = split_train if train else split_test
        self.motion_2d = (train_data if train else test_data)[split]
        dt = reader.dt_dataset[data_split]
        self.motion_smpl_3d = {"pose": dt["smpl_pose"][split],
                               "shape": dt["smpl_shape"][split]}

    def __len__(self):
        return len(self.motion_2d)

    def __getitem__(self, index):
        raise NotImplementedError


class MotionSMPL(SMPLDataset, EpochSeededRNG):
    """Items (motion_2d (T, 17, 3), {"theta" (T, 82), "kp_3d" (T, 17, 3),
    "verts" (T, V, 3)}), float32; ``args.flip`` turns the training flip
    on."""

    def __init__(self, args, data_split, dataset, smpl_model):
        super().__init__(args, data_split, dataset, smpl_model)
        self.flip = bool(args.get("flip", False))

    def __getitem__(self, index):
        x, gt = self.get_batch([index])
        return x[0], {k: v[0] for k, v in gt.items()}

    def get_batch(self, indices):
        """The items at ``indices``, stacked, with one SMPL forward over all
        their frames."""
        indices = np.asarray(indices)
        B = len(indices)
        motion_2d = self.motion_2d[indices].copy()           # (B, T, 17, 3)
        motion_2d[..., 2] = np.clip(motion_2d[..., 2], 0, 1)
        pose = self.motion_smpl_3d["pose"][indices].reshape(B, -1, 24, 3)
        shape = self.motion_smpl_3d["shape"][indices].reshape(B, -1, 10)
        T = pose.shape[1]
        if self.data_split == "train" and self.flip:
            for i, idx in enumerate(indices):
                if self.item_rng(int(idx)).random() > 0.5:
                    motion_2d[i] = flip_data_np(motion_2d[i])
                    pose[i] = flip_thetas_np(pose[i])
        out = smpl_forward_np(self.smpl,
                              shape.reshape(B * T, 10).astype(np.float32),
                              pose.reshape(B * T, 72).astype(np.float32),
                              dtype=np.float32)
        verts = out["vertices"] * 1000.0                      # mm
        kp = self.smpl.numpy("J_regressor_h36m") @ verts
        verts = verts - kp[:, :1, :]
        kp = kp - kp[:, :1, :]
        theta = np.concatenate([pose.reshape(B, T, 72),
                                shape.reshape(B, T, 10)], axis=-1)
        return motion_2d.astype(np.float32), {
            "theta": theta.astype(np.float32),
            "kp_3d": kp.reshape(B, T, -1, 3).astype(np.float32),
            "verts": verts.reshape(B, T, -1, 3).astype(np.float32)}
