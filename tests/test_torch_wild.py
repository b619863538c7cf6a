"""The port's in-the-wild pose path (skeleton remaps, the AlphaPose JSON
dataset, ``run_wild_pose`` and its command line) against the JAX package's
on the same JSON and the same weights."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from motionbert_tpu.core.config import ConfigDict as JConfigDict
from motionbert_tpu.data import dataset_wild as jwild
from motionbert_tpu.geometry import skeleton as jskel
from motionbert_tpu.infer.wild_pose import run_wild_pose as jrun_wild_pose
from motionbert_tpu.models.dstformer import DSTformer as JDSTformer
from motionbert_tpu_torch.core.config import ConfigDict
from motionbert_tpu_torch.data import dataset_wild as twild
from motionbert_tpu_torch.geometry import skeleton as tskel
from motionbert_tpu_torch.infer import wild_pose as twp
from motionbert_tpu_torch.models import dstformer as tmodel
from motionbert_tpu_torch.models.convert import state_dict_from_jax
from motionbert_tpu_torch.models.factory import load_backbone

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens", "geometry.npz")
N_FRAMES, CLIP_LEN = 40, 16
CFG = dict(dim_feat=32, dim_rep=32, depth=1, num_heads=4, mlp_ratio=2,
           num_joints=17, maxlen=CLIP_LEN)


def _write_wild_json(path, n_frames=N_FRAMES, n_people=2, seed=0):
    """Halpe-26 AlphaPose detections from a numpy seed: smooth tracks in a
    640 x 480 frame, the people's entries one after the other."""
    rs = np.random.RandomState(seed)
    t = np.arange(n_frames)[:, None, None] / n_frames
    results = []
    for person in range(n_people):
        rest = rs.uniform(-80, 80, size=(1, 26, 2)) + (320.0, 240.0)
        amp = rs.uniform(5, 30, size=(1, 26, 2))
        xy = rest + amp * np.sin(2 * np.pi * (t + rs.uniform(size=(1, 26, 2))))
        conf = rs.uniform(0.5, 1.0, size=(n_frames, 26, 1))
        for f in range(n_frames):
            results.append({
                "image_id": f"{f}.jpg", "idx": person, "score": 2.5,
                "keypoints": np.concatenate([xy[f], conf[f]], 1).ravel().tolist()})
    with open(path, "w") as fh:
        json.dump(results, fh)
    return str(path)


@pytest.fixture(scope="module")
def wild_json(tmp_path_factory):
    return _write_wild_json(tmp_path_factory.mktemp("wild") / "alphapose.json")


@pytest.mark.parametrize("name", ["halpe", "coco"])
def test_remap_matches_goldens_and_jax(name):
    z = np.load(GOLDENS)
    fn, jfn = getattr(tskel, f"{name}2h36m"), getattr(jskel, f"{name}2h36m")
    out = fn(z[f"{name}_in"])
    np.testing.assert_allclose(out, z[f"{name}_out"], atol=1e-6)
    np.testing.assert_array_equal(out, jfn(z[f"{name}_in"]))
    # an integer input keeps the fractional mixing weights
    ints = np.arange(2 * z[f"{name}_in"].shape[-2] * 3).reshape(
        2, -1, 3).astype(np.int64)
    np.testing.assert_array_equal(fn(ints), jfn(ints))
    assert fn(ints).dtype == np.float64


@pytest.mark.parametrize("vid_size,scale_range,focus", [
    (None, [1, 1], None), ((640, 480), None, 0), ((640, 480), None, 1),
    ((640, 480), [1, 1], None)])
def test_read_input_equals_jax(wild_json, vid_size, scale_range, focus):
    want = jwild.read_input(wild_json, vid_size, scale_range, focus)
    got = twild.read_input(wild_json, vid_size, scale_range, focus)
    assert got.dtype == np.float32
    assert got.shape == ((N_FRAMES if focus is not None else 2 * N_FRAMES),
                         17, 3)
    np.testing.assert_array_equal(got, want)


def test_wild_dataset_equals_jax(wild_json):
    kw = dict(clip_len=CLIP_LEN, vid_size=(640, 480), focus=0)
    ds, jds = twild.WildDetDataset(wild_json, **kw), \
        jwild.WildDetDataset(wild_json, **kw)
    assert len(ds) == len(jds) == 3     # 16 + 16 + 8
    assert [ds[i].shape[0] for i in range(3)] == [16, 16, 8]
    for i in range(3):
        np.testing.assert_array_equal(ds[i], jds[i])


def _models(dim_in=3):
    """A small JAX model, its parameters, and the port's model holding the
    same weights."""
    jmodel = JDSTformer(dim_in=dim_in, dim_out=3, attn_impl="xla", **CFG)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, CLIP_LEN, 17, dim_in)))["params"]
    model = load_backbone(ConfigDict(CFG), device="cpu", dim_in=dim_in)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmodel, params, model


@pytest.mark.parametrize("keys,pixel", [
    (dict(rootrel=False, flip=True), False),
    (dict(rootrel=True, flip=False, infer_batch_size=2), False),
    (dict(rootrel=False, flip=True, gt_2d=True), True),
    (dict(rootrel=True, no_conf=True), True)])
def test_run_wild_pose_matches_jax(wild_json, tmp_path, keys, pixel):
    """fp32 on both sides, a small model with converted weights: 1e-5 of the
    normalised output (1e-5 times half the frame's short side in pixels)."""
    jmodel, params, model = _models(dim_in=2 if keys.get("no_conf") else 3)
    kw = dict(json_path=wild_json, clip_len=CLIP_LEN, focus=0, pixel=pixel,
              vid_size=(640, 480) if pixel else None, render=False)
    want = jrun_wild_pose(JConfigDict(keys), out_path=str(tmp_path / "jax"),
                          params=params, model=jmodel, **kw)
    got = twp.run_wild_pose(ConfigDict(keys), out_path=str(tmp_path / "port"),
                            model=model, **kw)
    assert got.shape == (N_FRAMES, 17, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * (240.0 if pixel else 1.0))
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "X3D.npy"), got)
    if not pixel:
        if keys["rootrel"]:
            assert np.all(got[:, 0] == 0)
        else:   # frame-0 root depth of every clip
            assert np.all(got[::CLIP_LEN, 0, 2] == 0)
            assert np.any(got[1::CLIP_LEN, 0, 2] != 0)


def test_render_raises_until_the_renderer_is_ported(wild_json, tmp_path):
    """The renderer is ported: a video that cannot be written raises (here
    X3D.mp4 is a directory), and nothing is saved."""
    _, _, model = _models()
    os.makedirs(tmp_path / "X3D.mp4")
    with pytest.raises(OSError, match="X3D.mp4"):
        twp.run_wild_pose(ConfigDict(), json_path=wild_json,
                          out_path=str(tmp_path), model=model,
                          clip_len=CLIP_LEN, render=True)
    assert not os.path.exists(tmp_path / "X3D.npy")
    with pytest.raises(ValueError, match="vid_size"):
        twp.run_wild_pose(ConfigDict(), json_path=wild_json,
                          out_path=str(tmp_path), model=model,
                          clip_len=CLIP_LEN, pixel=True)


def _write_config(path, **extra):
    cfg = dict(CFG, flip=True, rootrel=True, **extra)
    path.write_text("\n".join(f"{k}: {json.dumps(v)}"
                              for k, v in cfg.items()) + "\n")
    return str(path)


@pytest.mark.parametrize("key,flag,want", [
    ("pallas_q8", None, "kernel_q8"), ("xla", None, "plain"),
    (None, "kernel_q8", "kernel_q8"), ("pallas_q8", "plain", "plain")])
def test_cli_runs_and_resolves_attn_impl(wild_json, tmp_path, monkeypatch,
                                         key, flag, want):
    """The command line on the CPU: X3D.npy is written, and the config's
    ``attn_impl`` key or ``--attn_impl`` picks the pair functions."""
    cfg = _write_config(tmp_path / "cfg.yaml",
                        **({"attn_impl": key} if key else {}))
    seen = {}
    real = twp.run_wild_pose

    def spy(args, **kw):
        seen["impls"] = {b.attn_impl for b in kw["model"].blocks_st}
        return real(args, **kw)

    monkeypatch.setattr(twp, "run_wild_pose", spy)
    out_dir = tmp_path / "out"
    argv = ["--config", cfg, "-j", wild_json, "-o", str(out_dir),
            "--clip_len", str(CLIP_LEN), "--focus", "1", "--device", "cpu"]
    out = twp.main(argv + (["--attn_impl", flag] if flag else []))
    assert seen["impls"] == {want} and want in tmodel.PAIR_IMPLS
    assert out.shape == (N_FRAMES, 17, 3)
    np.testing.assert_array_equal(np.load(out_dir / "X3D.npy"), out)


def test_cli_refuses_pixel_without_size_and_stream_kernels(wild_json,
                                                           tmp_path,
                                                           monkeypatch):
    cfg = _write_config(tmp_path / "cfg.yaml")
    base = ["--config", cfg, "-j", wild_json, "-o", str(tmp_path / "o"),
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="vid_size"):
        twp.main(base + ["--pixel"])
    # the stream kernels used to be refused: the flag now reaches them
    calls = []
    monkeypatch.setattr(tmodel, "STREAM_IMPLS", {
        k: tuple((lambda f: lambda *a: calls.append(f.__name__) or f(*a))(f)
                 for f in fns) for k, fns in tmodel.STREAM_IMPLS.items()})
    out = twp.main(base + ["--attn_impl", "pallas_stream_q8", "--clip_len",
                           str(CLIP_LEN), "--focus", "1"])
    assert out.shape == (N_FRAMES, 17, 3) and np.isfinite(out).all()
    assert set(calls) == {"fused_stream_block_q8",
                          "fused_gated_stream_block_q8"}


def test_cli_needs_the_card_unless_told(wild_json, tmp_path):
    """Without --device the command line runs on the card; with no CUDA
    device it raises instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _write_config(tmp_path / "cfg.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twp.main(["--config", cfg, "-j", wild_json, "-o",
                  str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")


def test_cli_help_says_it_does_not_render(capsys):
    """It renders unless --no_render, and takes --vid_path or --vid_size."""
    with pytest.raises(SystemExit):
        twp.parse_args(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "X3D.mp4 video out" in text and "--no_render" in text
    assert "--vid_path" in text and "--vid_size W H" in text
    with pytest.raises(SystemExit):
        twp.parse_args(["-j", "a.json", "-o", "o", "--vid_path", "v.mp4",
                        "--vid_size", "4", "3"])
