"""The H36M and mesh dataset readers: normalised, clip-sliced 2D inputs
and 3D labels.

The port's own copy of ``motionbert_tpu/data/readers.py``'s
``DataReaderH36M`` (reference datareader_h36m.py) and ``DataReaderMesh``
(reference datareader_mesh.py): the same normalisation, clip slicing and
denormalisation, vectorised over frames. numpy on the host.
"""

from __future__ import annotations

import numpy as np

from motionbert_tpu_torch.core.config import read_pkl
from motionbert_tpu_torch.geometry.transforms import split_clips

# camera id -> (res_w, res_h) (datareader_h36m.py:30-33)
H36M_CAMERA_RES = {
    "54138969": (1000, 1002),
    "60457274": (1000, 1002),
    "55011271": (1000, 1000),
    "58860488": (1000, 1000),
}


def _res_wh(camera_names) -> np.ndarray:
    """(N, 2) float32 (res_w, res_h) per frame."""
    names = np.asarray(camera_names)
    out = np.zeros((len(names), 2), dtype=np.float32)
    matched = np.zeros(len(names), dtype=bool)
    for cam, (w, h) in H36M_CAMERA_RES.items():
        m = names == cam
        out[m] = (w, h)
        matched |= m
    if not matched.all():
        bad = int(np.argmin(matched))
        raise ValueError(f"frame {bad} has an invalid camera name "
                         f"{names[bad]!r}")
    return out


class DataReaderH36M:
    """Reads an h36m_*_cam_source*.pkl and produces normalised clips:
    read_2d, read_3d, read_hw, get_split_id, get_hw, get_sliced_data,
    denormalize."""

    def __init__(self, n_frames, sample_stride, data_stride_train,
                 data_stride_test, read_confidence=True,
                 dt_root="data/motion3d", dt_file="h36m_cpn_cam_source.pkl"):
        self.split_id_train = None
        self.split_id_test = None
        self.test_hw = None
        self.dt_dataset = read_pkl(f"{dt_root}/{dt_file}")
        self.n_frames = n_frames
        self.sample_stride = sample_stride
        self.data_stride_train = data_stride_train
        self.data_stride_test = data_stride_test
        self.read_confidence = read_confidence

    def _norm_2d(self, joints, camera_names):
        """Pixels -> [-1, 1] by res_w; y offset by res_h / res_w."""
        res = _res_wh(camera_names)
        w = res[:, 0:1, None]
        h = res[:, 1:2, None]
        out = joints / w * 2
        out[..., 0] -= 1
        out[..., 1] -= (h / w)[..., 0]
        return out

    def read_2d(self):
        ss = self.sample_stride
        tr, te = self.dt_dataset["train"], self.dt_dataset["test"]
        train = self._norm_2d(tr["joint_2d"][::ss, :, :2].astype(np.float32),
                              tr["camera_name"][::ss])
        test = self._norm_2d(te["joint_2d"][::ss, :, :2].astype(np.float32),
                             te["camera_name"][::ss])
        if self.read_confidence:
            if "confidence" in tr:
                ctrain = tr["confidence"][::ss].astype(np.float32)
                ctest = te["confidence"][::ss].astype(np.float32)
                if ctrain.ndim == 2:
                    ctrain = ctrain[:, :, None]
                    ctest = ctest[:, :, None]
            else:
                ctrain = np.ones_like(train[..., :1])
                ctest = np.ones_like(test[..., :1])
            train = np.concatenate([train, ctrain], axis=2)
            test = np.concatenate([test, ctest], axis=2)
        return train.astype(np.float32), test.astype(np.float32)

    def _norm_3d(self, joints, camera_names):
        res = _res_wh(camera_names)
        w = res[:, 0:1, None]
        h = res[:, 1:2, None]
        out = joints.copy()
        out[..., :2] = joints[..., :2] / w * 2
        out[..., 0] -= 1
        out[..., 1] -= (h / w)[..., 0]
        out[..., 2:] = joints[..., 2:] / w * 2
        return out

    def read_3d(self):
        ss = self.sample_stride
        tr, te = self.dt_dataset["train"], self.dt_dataset["test"]
        train = self._norm_3d(tr["joint3d_image"][::ss, :, :3].astype(np.float32),
                              tr["camera_name"][::ss])
        test = self._norm_3d(te["joint3d_image"][::ss, :, :3].astype(np.float32),
                             te["camera_name"][::ss])
        return train.astype(np.float32), test.astype(np.float32)

    def read_hw(self):
        if self.test_hw is None:
            self.test_hw = _res_wh(
                self.dt_dataset["test"]["camera_name"][::self.sample_stride])
        return self.test_hw

    def get_split_id(self):
        """Clip index lists of the train and test splits. The tail-resample
        branch of split_clips draws from a RandomState pinned to 0, as the
        JAX package pins it, so repeated evaluations slice alike."""
        if self.split_id_train is None or self.split_id_test is None:
            ss = self.sample_stride
            self.split_id_train = split_clips(
                self.dt_dataset["train"]["source"][::ss], self.n_frames,
                data_stride=self.data_stride_train,
                rng=np.random.RandomState(0))
            self.split_id_test = split_clips(
                self.dt_dataset["test"]["source"][::ss], self.n_frames,
                data_stride=self.data_stride_test,
                rng=np.random.RandomState(0))
        return self.split_id_train, self.split_id_test

    def get_hw(self):
        test_hw = self.read_hw()
        _, split_id_test = self.get_split_id()
        return test_hw[split_id_test][:, 0, :]

    def get_sliced_data(self):
        train_data, test_data = self.read_2d()
        train_labels, test_labels = self.read_3d()
        split_train, split_test = self.get_split_id()
        return (train_data[split_train], test_data[split_test],
                train_labels[split_train], test_labels[split_test])

    def denormalize(self, test_data):
        """[-1, 1] -> pixels per test clip (datareader_h36m.py:125-136)."""
        n_clips = test_data.shape[0]
        test_hw = self.get_hw()
        data = test_data.reshape(n_clips, -1, 17, 3).copy()
        assert len(data) == len(test_hw)
        w = test_hw[:, 0][:, None, None]
        h = test_hw[:, 1][:, None, None]
        data[..., 0] = (data[..., 0] + 1) * w / 2
        data[..., 1] = (data[..., 1] + h / w) * w / 2
        data[..., 2] = data[..., 2] * w / 2
        return data


class DataReaderMesh:
    """Reader of the mesh pickles, with a fixed resolution per dataset
    (reference datareader_mesh.py:7-57: COCO 640 x 640, 3DPW 1920 x 1920):
    read_2d, get_split_id; the SMPL parameters stay in ``dt_dataset``."""

    def __init__(self, n_frames, sample_stride, data_stride_train,
                 data_stride_test, read_confidence=True, dt_root="data/mesh",
                 dt_file="mesh_det_h36m.pkl", res=(640, 640)):
        self.split_id_train = None
        self.split_id_test = None
        self.dt_dataset = read_pkl(f"{dt_root}/{dt_file}")
        self.n_frames = n_frames
        self.sample_stride = sample_stride
        self.data_stride_train = data_stride_train
        self.data_stride_test = data_stride_test
        self.read_confidence = read_confidence
        self.res = res

    def read_2d(self):
        """Pixels -> [-1, 1] by the resolution's width, y offset by
        height / width; the confidences as a third channel."""
        ss = self.sample_stride
        res_w, res_h = self.res
        offset = np.array([1, res_h / res_w])
        out = []
        for split in ("train", "test"):
            d = self.dt_dataset[split]
            xy = d["joint_2d"][::ss, :, :2].astype(np.float32) / res_w * 2 \
                - offset
            if self.read_confidence:
                conf = d["confidence"][::ss].astype(np.float32)
                if conf.ndim == 2:
                    conf = conf[:, :, None]
                xy = np.concatenate([xy, conf], axis=2)
            out.append(xy.astype(np.float32))
        return tuple(out)

    def get_split_id(self):
        """Clip index lists of the train and test splits, with split_clips'
        tail resampling pinned to RandomState(0) as in DataReaderH36M (mesh
        sources such as 3DPW and COCO do have videos shorter than a clip)."""
        if self.split_id_train is None:
            ss = self.sample_stride
            self.split_id_train = split_clips(
                self.dt_dataset["train"]["source"][::ss], self.n_frames,
                data_stride=self.data_stride_train,
                rng=np.random.RandomState(0))
            self.split_id_test = split_clips(
                self.dt_dataset["test"]["source"][::ss], self.n_frames,
                data_stride=self.data_stride_test,
                rng=np.random.RandomState(0))
        return self.split_id_train, self.split_id_test
