"""The native clip store: one flat float32 file (``.mbcs``) per split, packed
from a pose3d clip directory (``write_clipstore``, or ``tools/pack_clips.py``
with the JAX package's writer of the same layout), served
by ``mmap`` and a C++ thread pool that gathers a batch without Python per
item (``native/clipstore.cpp``).

The port's own ctypes binding of that source (``motionbert_tpu/data/
clipstore.py`` is the JAX package's). The shared library is built with
``g++`` at first use into ``build/clipstore/`` at the repository root (listed
in ``.gitignore``; the file name carries a hash of the source), never beside
the source. The file layout: a 64-byte header (magic "MBCS", version 1, the
clip count, whether an input stream is present, T, J, C), then the inputs
(when present) and the labels, each (n, T, J, C) float32.

    write_clipstore("train.mbcs", labels, inputs)
    store = ClipStore("train.mbcs")
    inputs, labels = store.gather([3, 1, 4])
    ds = ClipStoreDataset3D("train.mbcs")   # MotionDataset3D's items

The pose3d driver takes ``<data_root>/<subset>/<split>.mbcs`` when it is
there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from motionbert_tpu_torch.data.datasets import EpochSeededRNG
from motionbert_tpu_torch.geometry.transforms import crop_scale_3d

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "clipstore.cpp"
BUILD_DIR = ROOT / "build" / "clipstore"

MAGIC = 0x5343424D  # "MBCS"
HEADER_BYTES = 64

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def write_clipstore(path: str, labels: np.ndarray,
                    inputs: Optional[np.ndarray] = None) -> None:
    """Pack (n, T, J, C) float32 clips into one ``.mbcs`` file: the header
    (magic, version 1, n as uint64, 1 when inputs are given, T, J, C as
    uint32, zeros to 64 bytes), then the inputs, if any, and the labels."""
    labels = np.ascontiguousarray(labels, np.float32)
    n, T, J, C = labels.shape
    if inputs is not None:
        inputs = np.ascontiguousarray(inputs, np.float32)
        if inputs.shape != labels.shape:
            raise ValueError(f"inputs {inputs.shape} and labels "
                             f"{labels.shape} differ in shape")
    header = np.zeros(HEADER_BYTES, np.uint8)
    header[0:4].view(np.uint32)[0] = MAGIC
    header[4:8].view(np.uint32)[0] = 1
    header[8:16].view(np.uint64)[0] = n
    header[16:20].view(np.uint32)[0] = inputs is not None
    header[20:32].view(np.uint32)[:] = (T, J, C)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        header.tofile(f)
        if inputs is not None:
            inputs.tofile(f)
        labels.tofile(f)


def build_native() -> Path:
    """Compile native/clipstore.cpp once per source version; returns the
    library's path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libclipstore-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-pthread",
                        "-shared", "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_native()))
            vp, u32p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)
            lib.mbcs_open.restype = vp
            lib.mbcs_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.mbcs_info.argtypes = [vp, ctypes.POINTER(ctypes.c_uint64),
                                      u32p, u32p, u32p, u32p]
            lib.mbcs_gather.restype = ctypes.c_int
            lib.mbcs_gather.argtypes = [
                vp, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, vp, vp]
            lib.mbcs_close.argtypes = [vp]
            _lib = lib
        return _lib


class ClipStore:
    """An open ``.mbcs`` file: ``len`` clips of ``shape`` (T, J, C)."""

    def __init__(self, path: str, n_threads: int = 8):
        self._lib = _load_lib()
        self._h = self._lib.mbcs_open(os.fsencode(path), n_threads)
        if not self._h:
            raise OSError(f"cannot open clip store {path!r}")
        n = ctypes.c_uint64()
        T, J, C, has_input = (ctypes.c_uint32() for _ in range(4))
        self._lib.mbcs_info(self._h, ctypes.byref(n), ctypes.byref(T),
                            ctypes.byref(J), ctypes.byref(C),
                            ctypes.byref(has_input))
        self.n_clips = int(n.value)
        self.shape = (int(T.value), int(J.value), int(C.value))
        self.has_input = bool(has_input.value)

    def __len__(self):
        return self.n_clips

    def gather(self, indices: Sequence[int], want_input: bool = True):
        """(inputs or None, labels), each (B, T, J, C) float32; inputs None
        for a labels-only store or with want_input=False."""
        if self._h is None:  # the native code would dereference a null handle
            raise ValueError("clip store is closed")
        idx = np.ascontiguousarray(indices, np.int64)
        labels = np.empty((len(idx),) + self.shape, np.float32)
        inputs = np.empty_like(labels) if (self.has_input and want_input) \
            else None
        rc = self._lib.mbcs_gather(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), None if inputs is None else inputs.ctypes.data,
            labels.ctypes.data)
        if rc != 0:
            raise IndexError("clip index out of range")
        return inputs, labels

    def close(self):
        if getattr(self, "_h", None):
            self._lib.mbcs_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class ClipStoreDataset3D(EpochSeededRNG):
    """``MotionDataset3D``'s items from a clip store, and ``get_batch``, the
    one-gather batch path that ``BatchLoader`` takes. With ``synthetic`` or
    ``gt_2d`` the training inputs are the labels' xy with confidence 1 (the
    labels crop-scaled first with ``scale_range_pretrain``, from each item's
    RNG); with ``gt_2d`` so are the test inputs."""

    def __init__(self, path: str, synthetic: bool = False,
                 gt_2d: bool = False, scale_range_pretrain=None,
                 data_split: str = "train"):
        self.store = ClipStore(path)
        self.synthetic = synthetic
        self.gt_2d = gt_2d
        self.scale_range_pretrain = scale_range_pretrain
        self.data_split = data_split

    def __len__(self):
        return len(self.store)

    def _substitutes_inputs(self) -> bool:
        if self.data_split == "train":
            return self.synthetic or self.gt_2d
        return self.data_split == "test" and self.gt_2d

    def get_batch(self, indices):
        substitute = self._substitutes_inputs()
        inputs, labels = self.store.gather(indices, want_input=not substitute)
        if substitute:
            if self.data_split == "train" and self.scale_range_pretrain:
                labels = np.stack([
                    crop_scale_3d(m, self.scale_range_pretrain,
                                  rng=self.item_rng(int(i)))
                    for i, m in zip(indices, labels)]).astype(np.float32)
            inputs = np.zeros_like(labels)
            inputs[..., :2] = labels[..., :2]
            inputs[..., 2] = 1.0
        elif inputs is None:
            raise ValueError(
                f"store has no input stream and no synthetic/gt_2d "
                f"substitution applies (split={self.data_split!r}, "
                f"synthetic={self.synthetic}, gt_2d={self.gt_2d})")
        return inputs, labels

    def __getitem__(self, index):
        inputs, labels = self.get_batch([index])
        return inputs[0], labels[0]
