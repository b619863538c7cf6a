"""The port's renderer (``motionbert_tpu_torch/viz/render.py``), its video
metadata reader (``infer.read_video_meta``) and the wild command lines'
rendering, against the JAX package's ``motionbert_tpu/viz/render.py`` on
the CPU.

Each case of ``tests/test_render.py`` is held against the JAX function: the
2D frames pixel-equal (the JAX frames captured by replacing its
``_save_video``, the port's by replacing ``save_video``, before any codec
touches them). The 3D skeleton and the mesh are drawn with OpenCV from an
explicit projection where the JAX module uses matplotlib: they are held to
the JAX frames' count and size, and to drawn pixels where the projection
puts a joint or a vertex. Videos are written with ``cv2.VideoWriter`` and
read back with ``cv2.VideoCapture``.
"""

import os

import cv2
import numpy as np
import pytest

from motionbert_tpu.viz import render as jrender
from motionbert_tpu_torch.viz import render as trender

COLORS = "#F96706#FB8D43#FDB381"


def _motion2d(T=4, J=17, seed=0):
    rs = np.random.RandomState(seed)
    return rs.uniform(-0.8, 0.8, (T, J, 2)).astype(np.float32)


def _capture(monkeypatch):
    """Replace both modules' video writers by frame collectors: returns
    {"jax": [...], "port": [...]}, one list of frames per call."""
    seen = {"jax": [], "port": []}

    def keep(side):
        def save(frames, save_path, fps):
            seen[side].append([np.asarray(f) for f in frames])
            return save_path
        return save

    monkeypatch.setattr(jrender, "_save_video", keep("jax"))
    monkeypatch.setattr(trender, "save_video", keep("port"))
    return seen


def _equal_frames(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _read_frames(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


# ---------------------------------------------------------------------------
# the cases of tests/test_render.py
# ---------------------------------------------------------------------------

def test_hex2rgb():
    assert trender.hex2rgb(COLORS) == jrender.hex2rgb(COLORS) == [
        [0xF9, 0x67, 0x06], [0xFB, 0x8D, 0x43], [0xFD, 0xB3, 0x81]]
    assert trender.rgb2rgba((1, 2, 3)) == jrender.rgb2rgba((1, 2, 3))


def test_pixel2world_vis_motion_reference_formula():
    rs = np.random.RandomState(1)
    for dim in (2, 3):
        m = rs.uniform(-1, 1, (17, dim, 5)).astype(np.float32)
        np.testing.assert_array_equal(
            trender.pixel2world_vis_motion(m, dim=dim),
            jrender.pixel2world_vis_motion(m, dim=dim))
    np.testing.assert_array_equal(trender.pixel2world_vis_motion(
        np.zeros((17, 3, 5), np.float32), dim=3)[:, 2], 0.0)
    pose = rs.uniform(-1, 1, (17, 2))
    np.testing.assert_array_equal(trender.pixel2world_vis(pose),
                                  jrender.pixel2world_vis(pose))


@pytest.mark.parametrize("nr_joints", [15, 17, 49])
def test_joints2image_topologies(nr_joints):
    rs = np.random.RandomState(1)
    pose = rs.uniform(100, 400, (nr_joints, 2)).astype(np.float32)
    colors = trender.hex2rgb(COLORS)
    got = trender.joints2image(pose, colors, H=512, W=512)
    want = jrender.joints2image(pose, colors, H=512, W=512)
    assert got[0].shape == (512, 512, 3) and (got[0] != 255).any()
    _equal_frames(got, want)


def test_joints2image_confidence_and_modes():
    rs = np.random.RandomState(2)
    pose = rs.uniform(100, 400, (17, 3)).astype(np.float32)
    pose[:, 2] = 1.0
    pose[3, 2] = 0.0  # zero-confidence joint is skipped
    colors = trender.hex2rgb(COLORS)
    for kw in (dict(H=512, W=512), dict(H=256, W=256, transparency=True),
               dict(H=256, W=256, grayscale=True),
               dict(H=256, W=300, bg_color=(10, 20, 30))):
        _equal_frames(trender.joints2image(pose, colors, **kw),
                      jrender.joints2image(pose, colors, **kw))
    canvas, _ = trender.joints2image(pose, colors, H=512, W=512)
    full, _ = trender.joints2image(np.concatenate(
        [pose[:, :2], np.ones((17, 1), np.float32)], 1), colors, H=512,
        W=512)
    assert (canvas != full).any()  # the skipped limb changes the image


def test_motion2video_with_target_comparison(tmp_path):
    m = _motion2d(T=3)
    jm = np.transpose(np.concatenate(
        [(m + 1) * 256, np.ones((3, 17, 1), np.float32)], -1), (1, 2, 0))
    tgt = jm.copy()
    tgt[:, :2] += 30.0
    colors = trender.hex2rgb(COLORS)
    for t in (tgt, None):
        got = trender.motion2video(jm, str(tmp_path / "p.mp4"), colors,
                                   motion_tgt=t, as_array=True)
        want = jrender.motion2video(jm, str(tmp_path / "j.mp4"), colors,
                                    motion_tgt=t, as_array=True)
        assert got.shape == want.shape == (3, 512, 512, 3)
        np.testing.assert_array_equal(got, want)
    assert not os.listdir(tmp_path)   # as_array writes nothing
    out = trender.motion2video(jm, str(tmp_path / "v.mp4"), colors,
                               motion_tgt=tgt, fps=7, save_frame=True)
    assert len(_read_frames(out)) == 3
    assert sorted(os.listdir(tmp_path / "v-frames")) == [
        "0000.png", "0001.png", "0002.png"]


def test_render_and_save_2d_ellipse(tmp_path, monkeypatch):
    m = _motion2d()
    out = trender.render_and_save(m, str(tmp_path / "v2d.mp4"), fps=5)
    frames = _read_frames(out)
    assert len(frames) == 4 and frames[0].shape == (512, 512, 3)
    seen = _capture(monkeypatch)
    trender.render_and_save(m, str(tmp_path / "p.mp4"), fps=5)
    jrender.render_and_save(m, str(tmp_path / "j.mp4"), fps=5)
    _equal_frames(seen["port"][0], seen["jax"][0])


def test_render_and_save_2d_with_conf_and_tgt(tmp_path, monkeypatch):
    m = _motion2d()
    m3 = np.concatenate([m, np.ones((*m.shape[:2], 1), np.float32)], -1)
    m3[1, 5, 2] = 0.0
    out = trender.render_and_save(m3, str(tmp_path / "v.mp4"), fps=5,
                                  with_conf=True, motion_tgt=m)
    assert len(_read_frames(out)) == 4
    seen = _capture(monkeypatch)
    kw = dict(fps=5, with_conf=True, motion_tgt=m)
    trender.render_and_save(m3, str(tmp_path / "p.mp4"), **kw)
    jrender.render_and_save(m3, str(tmp_path / "j.mp4"), **kw)
    _equal_frames(seen["port"][0], seen["jax"][0])


def test_vis_data_batch(tmp_path, monkeypatch):
    rs = np.random.RandomState(3)
    data_input = rs.uniform(-1, 1, (3, 2, 17, 3)).astype(np.float32)
    data_label = rs.uniform(-1, 1, (3, 2, 17, 3)).astype(np.float32)
    trender.vis_data_batch(data_input, data_label, n_render=2,
                           save_path=str(tmp_path / "batch"))
    assert sorted(os.listdir(tmp_path / "batch")) == [
        "gt_0.mp4", "gt_1.mp4", "input_0.mp4", "input_1.mp4"]
    seen = _capture(monkeypatch)
    trender.vis_data_batch(data_input, data_label, n_render=2,
                           save_path=str(tmp_path / "p"))
    jrender.vis_data_batch(data_input, data_label, n_render=2,
                           save_path=str(tmp_path / "j"))
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for i, (got, want) in enumerate(zip(seen["port"], seen["jax"])):
        if i % 2 == 0:   # the inputs: 2D, pixel-equal
            _equal_frames(got, want)
        else:            # the labels: 3D, the JAX frames' count and size
            assert [f.shape for f in got] == [f.shape for f in want]


def test_bounding_box():
    img = np.zeros((10, 10, 3), np.uint8)
    img[2:5, 3:7] = 1
    assert trender.bounding_box(img) == jrender.bounding_box(img) \
        == (2, 4, 3, 6)
    empty = np.zeros((4, 4), np.uint8)
    assert trender.bounding_box(empty) == jrender.bounding_box(empty)


# ---------------------------------------------------------------------------
# 3D, mesh and the line renderer
# ---------------------------------------------------------------------------

def _drawn(frame, xy) -> bool:
    """A pixel of the 3 x 3 neighbourhood of xy differs from white."""
    x, y = int(round(xy[0])), int(round(xy[1]))
    patch = frame[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2]
    return patch.size > 0 and bool((patch != 255).any())


def test_3d_skeleton_frames_follow_the_projection(monkeypatch, tmp_path):
    rs = np.random.RandomState(4)
    motion = rs.normal(0, 0.3, (3, 17, 3)).astype(np.float32)
    seen = _capture(monkeypatch)
    trender.render_and_save(motion, str(tmp_path / "p.mp4"))
    jrender.render_and_save(motion, str(tmp_path / "j.mp4"))
    got, want = seen["port"][0], seen["jax"][0]
    assert [f.shape for f in got] == [f.shape for f in want] \
        == [(trender.FRAME_SIZE,) * 2 + (3,)] * 3
    lim = np.abs(motion).max() * 1.1 + 1e-6
    xy, _ = trender.project(motion, lim, "skeleton")
    assert ((xy > 0) & (xy < trender.FRAME_SIZE)).all()
    for t, frame in enumerate(got):
        assert all(_drawn(frame, xy[t, j]) for j in range(17))


def _small_mesh(T=2, seed=5):
    """A closed triangulated sphere of 66 vertices, in mm, moving."""
    lat, lon = np.linspace(0.2, np.pi - 0.2, 6), np.linspace(
        0, 2 * np.pi, 11)[:-1]
    pts = [(np.sin(a) * np.cos(b), np.sin(a) * np.sin(b), np.cos(a))
           for a in lat for b in lon] + [(0, 0, 1), (0, 0, -1)]
    pts = np.asarray(pts) * 300.0
    faces = []
    for i in range(5):
        for j in range(10):
            a, b = i * 10 + j, i * 10 + (j + 1) % 10
            faces += [(a, b, a + 10), (b, b + 10, a + 10)]
    faces += [(60, j, (j + 1) % 10) for j in range(10)]
    faces += [(61, 50 + (j + 1) % 10, 50 + j) for j in range(10)]
    rs = np.random.RandomState(seed)
    verts = pts[None] + rs.normal(0, 20, (T, 1, 3)) + [0, 0, 2000]
    return verts.astype(np.float32), np.asarray(faces, np.int64)


@pytest.mark.parametrize("with_faces", [True, False])
def test_mesh_frames_follow_the_projection(monkeypatch, tmp_path, with_faces):
    verts, faces = _small_mesh()
    faces = faces if with_faces else None
    seen = _capture(monkeypatch)
    trender.motion2video_mesh(verts, str(tmp_path / "p.mp4"), faces=faces)
    jrender.motion2video_mesh(verts, str(tmp_path / "j.mp4"), faces=faces)
    got, want = seen["port"][0], seen["jax"][0]
    assert [f.shape for f in got] == [f.shape for f in want]
    lim = np.abs(verts).max() * 1.1 + 1e-6
    xy, depth = trender.project(verts, lim, "mesh")
    np.testing.assert_allclose(depth, verts[..., 2])
    shown = range(verts.shape[1]) if with_faces else range(
        0, verts.shape[1], 10)
    for t, frame in enumerate(got):
        assert all(_drawn(frame, xy[t, v]) for v in shown)
    if with_faces:   # shaded: more than one grey level
        assert len(np.unique(got[0][..., 0])) > 3


def test_mesh_render_of_the_body_model_size(tmp_path):
    """(T, 6890, 3) dispatches to the mesh renderer; the frame rate and the
    frame count reach the file."""
    rs = np.random.RandomState(6)
    verts = rs.normal(0, 300, (2, 6890, 3)).astype(np.float32)
    faces = rs.randint(0, 6890, (13776, 3))
    out = trender.render_and_save(verts, str(tmp_path / "m.mp4"), fps=12,
                                  faces=faces)
    from motionbert_tpu_torch.infer import read_video_meta

    assert read_video_meta(out) == (12.0, (trender.FRAME_SIZE,) * 2)
    assert len(_read_frames(out)) == 2


def test_line_renderer_frames_match_jax(monkeypatch, tmp_path):
    motion = (_motion2d(T=3) + 1) * 200
    seen = _capture(monkeypatch)
    trender.motion2video_2d(motion, str(tmp_path / "p.mp4"))
    jrender.motion2video_2d(motion, str(tmp_path / "j.mp4"))
    _equal_frames(seen["port"][0], seen["jax"][0])


def test_a_video_that_cannot_be_written_raises(tmp_path):
    frames = [np.zeros((8, 8, 3), np.uint8)] * 2
    with pytest.raises(OSError):
        trender.save_video(frames, str(tmp_path / "missing" / "v.mp4"), 5)
    with pytest.raises(ValueError, match="no frames"):
        trender.save_video([], str(tmp_path / "v.mp4"), 5)
    with pytest.raises(ValueError, match="frame 1"):
        trender.save_video([frames[0], np.zeros((4, 8, 3), np.uint8)],
                           str(tmp_path / "v.mp4"), 5)


# ---------------------------------------------------------------------------
# video metadata and the wild command lines
# ---------------------------------------------------------------------------

def _write_video(path, fps=24.0, size=(96, 64), n=5):
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    for i in range(n):
        w.write(np.full((size[1], size[0], 3), 40 * i, np.uint8))
    w.release()
    return path


class _CvReader:
    """imageio's reader interface over cv2 (``get_meta_data`` gives fps and
    size, as imageio's ffmpeg reader does): this sandbox's imageio has no
    video backend."""

    def __init__(self, path):
        self.cap = cv2.VideoCapture(path)

    def get_meta_data(self):
        return {"fps": self.cap.get(cv2.CAP_PROP_FPS),
                "size": (int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                         int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))}

    def close(self):
        self.cap.release()


def test_read_video_meta_matches_jax(tmp_path, monkeypatch):
    import imageio

    from motionbert_tpu.infer import read_video_meta as jread
    from motionbert_tpu_torch.infer import read_video_meta

    path = _write_video(str(tmp_path / "v.mp4"))
    monkeypatch.setattr(imageio, "get_reader", _CvReader)
    got = read_video_meta(path)
    assert got == (24.0, (96, 64))
    fps, size = jread(path)
    assert (float(fps), tuple(size)) == got
    with pytest.raises(OSError, match="cannot open"):
        read_video_meta(str(tmp_path / "none.mp4"))


def _write_wild_json(path, n_frames):
    """Halpe-26 AlphaPose detections of one person from a numpy seed."""
    import json

    rs = np.random.RandomState(0)
    xy = rs.uniform(200, 400, (1, 26, 2)) + rs.normal(0, 3, (n_frames, 26, 2))
    conf = rs.uniform(0.5, 1.0, (n_frames, 26, 1))
    with open(path, "w") as fh:
        json.dump([{"image_id": f"{f}.jpg", "idx": 0, "score": 2.5,
                    "keypoints": np.concatenate([xy[f], conf[f]], 1)
                    .ravel().tolist()} for f in range(n_frames)], fh)
    return str(path)


def test_run_wild_pose_renders_x3d(tmp_path):
    """A tiny model through run_wild_pose(render=True): X3D.mp4 holds the
    clip's frames at the given rate."""
    import torch

    from motionbert_tpu_torch.core.config import ConfigDict
    from motionbert_tpu_torch.infer import read_video_meta
    from motionbert_tpu_torch.infer.wild_pose import run_wild_pose
    from motionbert_tpu_torch.models.factory import load_backbone

    CLIP_LEN, N_FRAMES = 16, 40
    json_path = _write_wild_json(tmp_path / "a.json", N_FRAMES)
    model = load_backbone(ConfigDict(dim_feat=32, dim_rep=32, depth=1,
                                     num_heads=4, mlp_ratio=2, maxlen=CLIP_LEN,
                                     num_joints=17), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    out = run_wild_pose(ConfigDict(rootrel=True), json_path=json_path,
                        out_path=str(tmp_path / "o"), model=model,
                        clip_len=CLIP_LEN, focus=0, fps_in=15.0)
    video = str(tmp_path / "o" / "X3D.mp4")
    assert out.shape == (N_FRAMES, 17, 3)
    assert read_video_meta(video) == (15.0, (trender.FRAME_SIZE,) * 2)
    assert len(_read_frames(video)) == N_FRAMES
