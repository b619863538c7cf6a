"""The pose3d clip dataset, the 2D pretraining datasets and a threaded batch
loader.

The port's own copy of ``motionbert_tpu/data/datasets.py``'s
``EpochSeededRNG``, ``MotionDataset3D``, ``PoseTrackDataset2D``,
``InstaVDataset2D``, ``_collate`` and ``BatchLoader`` (reference
dataset_motion_3d.py, dataset_motion_2d.py): one pickle per clip, decoded on a thread
pool, shuffled with ``np.random.RandomState(seed)`` and per-item RNGs hashed
from (seed, epoch, index), so that batch order and augmentation draws match
the JAX package's loader. The random flip runs on the device in the train
step (``train/pose3d.py``), not here. A dataset with a ``get_batch`` method
(the native clip store, ``data/clipstore.py``) is gathered a batch at a
time; a ``sampler`` (the one-shot task's ``MPerClassSampler``) orders the
items in place of the shuffle. ``device_prefetch`` moves batches to the card
ahead of the train step.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import queue
import threading
from collections import defaultdict, deque
from typing import Iterator, Sequence

import numpy as np
import torch

from motionbert_tpu_torch.core.config import read_pkl
from motionbert_tpu_torch.core.profiling import annotate
from motionbert_tpu_torch.geometry.skeleton import posetrack2h36m
from motionbert_tpu_torch.geometry.transforms import (
    crop_scale, crop_scale_3d, split_clips)

DECODE_THREADS = 8   # items decoded in parallel
PREFETCH_BATCHES = 4  # ready batches the loader holds ahead of the consumer


class EpochSeededRNG:
    """Deterministic, thread-safe per-item augmentation RNG: each item draws
    from a RandomState seeded with a hash of (seed, epoch, index), so the
    draws do not depend on which loader thread decodes the item. Trainers
    pass the true epoch through BatchLoader.set_epoch, so a resumed run draws
    what the uninterrupted run would have."""

    _seed = 0
    _epoch = 0

    def set_seed(self, seed: int):
        self._seed = int(seed)

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def item_rng(self, index: int) -> np.random.RandomState:
        # boost-style hash_combine: a linear combination would alias
        # (epoch, index + stride) with (epoch + 1, index)
        h = self._seed & 0xFFFFFFFF
        for v in (self._epoch, int(index)):
            h ^= (v + 0x9E3779B9 + ((h << 6) & 0xFFFFFFFF) + (h >> 2)) \
                & 0xFFFFFFFF
        return np.random.RandomState(h & 0xFFFFFFFF)


class MotionDataset3D(EpochSeededRNG):
    """File-per-clip dataset: <data_root>/<subset>/<split>/*.pkl, each
    {"data_input": (T, 17, 3) or None, "data_label": (T, 17, 3)}. Items are
    (motion_2d, motion_3d) float32."""

    def __init__(self, args, subset_list: Sequence[str], data_split: str):
        self.data_root = args.data_root
        self.data_split = data_split
        self.synthetic = bool(args.get("synthetic", False))
        self.gt_2d = bool(args.get("gt_2d", False))
        self.scale_range_pretrain = args.get("scale_range_pretrain", None)
        self.file_list = []
        for subset in subset_list:
            path = os.path.join(self.data_root, subset, data_split)
            for name in sorted(os.listdir(path)):
                self.file_list.append(os.path.join(path, name))

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, index):
        motion_file = read_pkl(self.file_list[index])
        motion_3d = np.asarray(motion_file["data_label"], np.float32)
        if self.data_split == "train":
            if self.synthetic or self.gt_2d:
                if self.scale_range_pretrain:
                    motion_3d = crop_scale_3d(
                        motion_3d, self.scale_range_pretrain,
                        rng=self.item_rng(index)).astype(np.float32)
                motion_2d = np.zeros(motion_3d.shape, dtype=np.float32)
                motion_2d[:, :, :2] = motion_3d[:, :, :2]
                motion_2d[:, :, 2] = 1.0  # no detection: GT xy, conf 1
            elif motion_file["data_input"] is not None:
                motion_2d = np.asarray(motion_file["data_input"], np.float32)
            else:
                raise ValueError("Training illegal.")
        elif self.data_split == "test":
            motion_2d = np.asarray(motion_file["data_input"], np.float32)
            if self.gt_2d:
                motion_2d = motion_2d.copy()
                motion_2d[:, :, :2] = motion_3d[:, :, :2]
                motion_2d[:, :, 2] = 1.0
        else:
            raise ValueError("Data split unknown.")
        return motion_2d, motion_3d


class PoseTrackDataset2D:
    """PoseTrack18 2D tracks for pretraining (reference
    dataset_motion_2d.py:77-121): the first 30 frames of every track that
    has them and enough valid joints, crop-scaled (one RandomState(0) over
    the tracks in file order), remapped to H36M-17, kept when the root is
    visible in every frame. Items are (motion, motion) float32 (30, 17, 3):
    2D self-supervision, the confidence in the last channel. A missing
    ``data_root`` raises FileNotFoundError."""

    def __init__(self, data_root="data/motion2d/posetrack18_annotations/train/",
                 scale_range=(0.25, 1)):
        rng = np.random.RandomState(0)
        motions = []
        for filename in sorted(os.listdir(data_root)):
            with open(os.path.join(data_root, filename)) as f:
                json_dict = json.load(f)
            tracks = defaultdict(list)
            for annot in json_dict["annotations"]:
                tracks[annot["track_id"]].append(
                    np.array(annot["keypoints"]).reshape(-1, 3))
            motions += list(tracks.values())
        kept = []
        for motion in motions:
            if len(motion) < 30:
                continue
            motion = np.array(motion[:30])
            if np.sum(motion[:, :, 2]) <= 306:  # valid-joint threshold
                continue
            motion = posetrack2h36m(crop_scale(motion, scale_range, rng=rng))
            motion[motion[:, :, 2] == 0] = 0
            if np.sum(motion[:, 0, 2]) < 30:  # root visible in every frame
                continue
            kept.append(motion.astype(np.float32))
        self.motions_2d = np.array(kept)

    def __len__(self):
        return len(self.motions_2d)

    def __getitem__(self, index):
        m = self.motions_2d[index]
        return m, m


class InstaVDataset2D(EpochSeededRNG):
    """InstaVariety 2D clips (reference dataset_motion_2d.py:123-147):
    ``motion_all.npy`` cut into clips by ``id_all.npy``, those whose first
    root confidence is above the threshold, crop-scaled per item with the
    item's RNG. Items are (motion, motion) float32 (n_frames, 17, 3)."""

    def __init__(self, data_root="data/motion2d/InstaVariety", n_frames=81,
                 data_stride=27, valid_threshold=0.0, scale_range=(0.25, 1)):
        self.scale_range = scale_range
        motion_all = np.load(os.path.join(data_root, "motion_all.npy"))
        id_all = np.load(os.path.join(data_root, "id_all.npy"))
        motions_2d = motion_all[split_clips(id_all, n_frames, data_stride)]
        self.motions_2d = motions_2d[motions_2d[:, 0, 0, 2] > valid_threshold]

    def __len__(self):
        return len(self.motions_2d)

    def __getitem__(self, index):
        m = crop_scale(self.motions_2d[index], self.scale_range,
                       rng=self.item_rng(index))
        m[m[:, :, 2] == 0] = 0
        m = m.astype(np.float32)
        return m, m


def _collate(items):
    """Stack samples into batched arrays, recursing into tuples and dicts
    (torch default_collate semantics)."""
    first = items[0]
    if isinstance(first, tuple):
        return tuple(_collate([it[c] for it in items])
                     for c in range(len(first)))
    if isinstance(first, dict):
        return {k: _collate([it[k] for it in items]) for k in first}
    return np.stack(items)


class BatchLoader:
    """Shuffling, batching, prefetching loader yielding tuples of stacked
    numpy arrays: items decode on a thread pool (pickle and numpy release the
    interpreter lock on I/O), or a batch at a time through the dataset's
    ``get_batch``, and a bounded queue holds ready batches. ``sampler``: an
    iterable of indices with a length, in place of the shuffle."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, sampler=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.sampler = sampler
        self.rng = np.random.RandomState(seed)
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Pin the augmentation epoch of the next iteration."""
        self._epoch = int(epoch)

    def __len__(self):
        n = len(self.sampler if self.sampler is not None else self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        if self.sampler is not None:
            idx = np.fromiter(iter(self.sampler), dtype=np.int64)
        else:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                self.rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            b = idx[i:i + self.batch_size]
            if self.drop_last and len(b) < self.batch_size:
                return
            yield b

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_BATCHES)
        stop = threading.Event()
        set_epoch = getattr(self.dataset, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(self._epoch)
        self._epoch += 1
        get_batch = getattr(self.dataset, "get_batch", None)

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has gone away
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            pool = cf.ThreadPoolExecutor(DECODE_THREADS) \
                if get_batch is None else None
            try:
                for b in self._batches():
                    if stop.is_set():
                        return
                    batch = get_batch(b) if pool is None else _collate(
                        list(pool.map(self.dataset.__getitem__, b)))
                    if not put(batch):
                        return
            except BaseException as e:  # raised again in the consumer: a
                put(e)                  # swallowed error would silently
                return                  # cut the epoch short
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)
                put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # drain so the producer's last put lands
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def device_prefetch(iterator, device, size: int = 2) -> Iterator:
    """The batches of ``iterator`` (numpy arrays or tensors, or tuples,
    lists and dicts of them) as tensors on ``device``, in order, ``size``
    batches ahead of the consumer (the counterpart of
    ``motionbert_tpu/data/datasets.py``'s ``device_prefetch``). On a CUDA
    device each batch goes through pinned host memory and a non-blocking
    copy on a side stream; the consuming stream waits on the copy's event
    before it receives the batch, and the batch's memory is recorded on
    that stream for the caching allocator; under a profiler each hand-over
    is a ``data.feed`` span: the next host batch, its pinning and copy,
    and the wait on the batch it yields. On the CPU the arrays become
    tensors sharing their memory."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield _tree_map(torch.as_tensor, batch)
        return
    side = torch.cuda.Stream(device)
    ahead: deque = deque()
    source, size = iter(iterator), max(size, 1)

    def load(host):
        pinned = torch.as_tensor(host).pin_memory()
        return pinned.to(device, non_blocking=True)

    def hand_over():
        batch, copied = ahead.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(copied)
        _tree_map(lambda t: t.record_stream(consumer), batch)
        return batch

    while True:
        with annotate("data.feed"):
            for host in source:
                with torch.cuda.stream(side):
                    ahead.append((_tree_map(load, host),
                                  side.record_event()))
                if len(ahead) >= size:
                    break
            if not ahead:
                return
            batch = hand_over()
        yield batch
