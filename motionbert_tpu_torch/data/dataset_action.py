"""Skeleton action-recognition datasets (NTU RGB+D in the pyskl pickle
format) and the m-per-class batch sampler of one-shot training.

The port's own copy of ``motionbert_tpu/data/dataset_action.py`` (reference
lib/data/dataset_action.py). At construction, per sample: the temporal
resample to ``n_frames`` (jittered for training), pixels to [-1, 1]
(``make_cam``), the greedy two-person tracking fix, COCO -> H36M joints, the
confidence channel, and a zero second person for single-person clips; the
draws come from the global numpy RNG after ``np.random.seed(0)``, in the JAX
package's order, so the arrays are the same. Per item: the ``random_move``
jitter (training) and ``crop_scale``, drawn from the item's RNG
(``EpochSeededRNG``). numpy on the host; the model's batches go to the
device in the train step.
"""

from __future__ import annotations

import numpy as np

from motionbert_tpu_torch.core.config import read_pkl
from motionbert_tpu_torch.data.datasets import EpochSeededRNG
from motionbert_tpu_torch.geometry.skeleton import coco2h36m
from motionbert_tpu_torch.geometry.transforms import (
    crop_scale, human_tracking, make_cam, random_move, resample)


def get_action_names(file_path="data/action/ntu_actions.txt"):
    """Class names from lines "A001. drink water" (reference
    dataset_action.py:12-17)."""
    with open(file_path) as f:
        actions = f.read().split("\n")
    return [a.split(".")[1][1:] for a in actions if a]


class ActionDataset(EpochSeededRNG):
    """Items (motion (M=2, n_frames, 17, 3) float32, label)."""

    def __init__(self, data_path, data_split, n_frames=243, random_move=True,
                 scale_range=(1, 1), check_split=True):
        np.random.seed(0)
        dataset = read_pkl(data_path)
        if check_split:
            assert data_split in dataset["split"], (
                f"unknown split {data_split}; have {list(dataset['split'])}")
            split = set(dataset["split"][data_split])
        self.random_move = random_move
        self.is_train = (("train" in data_split) or not check_split) \
            and "oneshot" not in data_split
        self.scale_range = scale_range
        motions, labels = [], []
        for sample in dataset["annotations"]:
            if check_split and sample["frame_dir"] not in split:
                continue
            resample_id = resample(ori_len=sample["total_frames"],
                                   target_len=n_frames,
                                   randomness=self.is_train)
            motion_cam = make_cam(x=sample["keypoint"],
                                  img_shape=sample["img_shape"])
            motion_cam = coco2h36m(human_tracking(motion_cam))
            motion_conf = sample["keypoint_score"][..., None]
            motion = np.concatenate(
                (motion_cam[:, resample_id], motion_conf[:, resample_id]),
                axis=-1)
            if motion.shape[0] == 1:  # one person: a zero second person
                motion = np.concatenate((motion, np.zeros(motion.shape)),
                                        axis=0)
            motions.append(motion.astype(np.float32))
            labels.append(sample["label"])
        self.motions = np.array(motions)
        self.labels = np.array(labels)

    def __len__(self):
        return len(self.motions)

    def __getitem__(self, idx):
        motion, label = self.motions[idx], self.labels[idx]  # (M, T, J, C)
        rng = self.item_rng(idx)
        if self.random_move:
            motion = random_move(motion, rng=rng)
        if self.scale_range:
            motion = crop_scale(motion, scale_range=self.scale_range, rng=rng)
        return motion.astype(np.float32), label


class NTURGBD(ActionDataset):
    pass


# NTU120 one-shot protocol: these 20 classes are held out for evaluation;
# training uses the other 100, relabelled 0..99 (reference
# dataset_action.py:187-195)
ONESHOT_CLASSES = tuple(range(0, 120, 6))


class NTURGBD1Shot(ActionDataset):
    def __init__(self, data_path, data_split, n_frames=243, random_move=True,
                 scale_range=(1, 1), check_split=False):
        super().__init__(data_path, data_split, n_frames, random_move,
                         scale_range, check_split)
        new_classes = sorted(set(range(120)) - set(ONESHOT_CLASSES))
        old2new = {cid: i for i, cid in enumerate(new_classes)}
        keep = ~np.isin(self.labels, ONESHOT_CLASSES)
        self.motions = self.motions[keep]
        self.labels = np.array([old2new[x] for x in self.labels[keep]])


class MPerClassSampler:
    """Index epochs in which every batch holds ``m`` samples of each of
    ``batch_size // m`` classes (the reference takes
    pytorch_metric_learning's sampler, train_action_1shot.py:145). Draws
    from its own ``RandomState(seed)``, as the JAX package's does."""

    def __init__(self, labels, m: int, batch_size: int, length: int,
                 seed: int = 0):
        self.labels = np.asarray(labels)
        self.m = m
        self.batch_size = batch_size
        assert batch_size % m == 0, "batch_size must be a multiple of m"
        self.length = length - (length % batch_size)
        self.rng = np.random.RandomState(seed)
        self.by_class = {c: np.nonzero(self.labels == c)[0]
                         for c in np.unique(self.labels)}

    def __len__(self):
        return self.length

    def __iter__(self):
        classes_per_batch = self.batch_size // self.m
        classes = list(self.by_class)
        out = []
        while len(out) < self.length:
            chosen = self.rng.choice(len(classes), classes_per_batch,
                                     replace=False)
            for ci in chosen:
                pool = self.by_class[classes[ci]]
                take = self.rng.choice(len(pool), self.m,
                                       replace=len(pool) < self.m)
                out.extend(pool[take])
        return iter(out[: self.length])
