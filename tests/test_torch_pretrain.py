"""The port's pretraining pieces against the JAX package on the CPU: the 2D
corruption (``data/augment.py``), the PoseTrack remap and the 2D datasets,
the 2D loss, the train step on 2D data and the epoch driver on the synthetic
pretraining set.

Inputs come from numpy seeds and go to both packages. The two packages'
random generators give different numbers from one seed, so where the
corruption is compared value for value both sides are fed the same numpy
draws (the test replaces ``jax.random.uniform`` / ``normal`` and the port's
``_uniform`` / ``_normal`` for its duration; neither package changes).
Tolerances: 1e-6 for fp32 elementwise arithmetic in another order (5e-6 for
the whole corruption and 2e-5 for the keyframe interpolation of
unit-variance test data, see there); exact
equality for numpy code that is the same on both sides.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionbert_tpu.data import augment as jaug
from motionbert_tpu_torch.core.config import ConfigDict, get_config
from motionbert_tpu_torch.data import augment as aug

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAIN = os.path.join(ROOT, "configs", "pretrain",
                        "MB_pretrain_synth_smoke.yaml")
NOISE = (os.path.join(ROOT, "params", "synthetic_noise.npz"),
         os.path.join(ROOT, "params", "d2c_params.pkl"))
MOTION2D = os.path.join(ROOT, "data", "synthetic", "motion2d")


def _np(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale).astype(
        np.float32)


def _params():
    return aug.NoiseParams.load(*NOISE), jaug.NoiseParams.load(*NOISE)


def _same_noise_params(port, ref):
    for name in ("mean", "std", "weight"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for name in ("uniform_range", "a", "b", "m", "s"):
        assert getattr(port, name) == getattr(ref, name)


def test_noise_params_load_matches_jax(tmp_path):
    """The .npz, and the reference's .pth format (a dict of tensors and a
    number, written here with torch.save), through both loaders."""
    _same_noise_params(*_params())
    z = np.load(NOISE[0])
    pth = str(tmp_path / "synthetic_noise.pth")
    torch.save({"mean": torch.from_numpy(z["mean"]),
                "std": torch.from_numpy(z["std"]),
                "weight": torch.from_numpy(z["weight"]),
                "uniform_range": 0.05}, pth)
    port = aug.NoiseParams.load(pth, NOISE[1])
    _same_noise_params(port, jaug.NoiseParams.load(pth, NOISE[1]))
    assert port.uniform_range == 0.05
    np.testing.assert_array_equal(port.mean, _params()[0].mean)


@pytest.mark.parametrize("frames", [1, 16, 27, 81, 243])
def test_interp_keyframes_matches_jax(frames):
    delta = _np((2, aug.NUM_KEYFRAMES, 17, 2), 0)
    got = aug._interp_keyframes(torch.from_numpy(delta), frames)
    want = jaug._interp_keyframes(jnp.asarray(delta), frames)
    assert got.shape == (2, frames, 17, 2)
    # the frame positions run up to 26, where an fp32 ulp is 1.9e-6, and the
    # two linspaces round them differently; that error multiplies keyframe
    # differences of a few units here (of ~0.05 in the corruption itself)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    if frames > 1:  # align_corners: the end keyframes are kept
        np.testing.assert_allclose(got[:, -1].numpy(), delta[:, -1], atol=1e-6)


def test_dis2conf_deterministic_part_matches_jax():
    """With the shift's spread at 0 the draw does not count."""
    port, ref = _params()
    port = aug.NoiseParams(**{**port.__dict__, "s": 0.0})
    ref = jaug.NoiseParams(**{**ref.__dict__, "s": 0.0})
    dis = np.abs(_np((3, 8, 17), 1, 0.05))
    got = aug.dis2conf(torch.Generator().manual_seed(0),
                       torch.from_numpy(dis), port)
    want = jaug.dis2conf(jax.random.PRNGKey(0), jnp.asarray(dis), ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _same_draws(monkeypatch, seed):
    """Feed both packages one numpy stream each, from the same seed."""
    streams = [np.random.RandomState(seed), np.random.RandomState(seed)]

    def draw(rs, kind, shape):
        a = rs.uniform(size=shape) if kind == "uniform" else \
            rs.normal(size=shape)
        return a.astype(np.float32)

    for kind in ("uniform", "normal"):
        monkeypatch.setattr(
            jax.random, kind, lambda key, shape, *a, kind=kind, **kw:
            jnp.asarray(draw(streams[0], kind, shape)))
        monkeypatch.setattr(
            aug, f"_{kind}", lambda shape, generator, kind=kind:
            torch.from_numpy(draw(streams[1], kind, tuple(shape))))


@pytest.mark.parametrize("noise,mask", [(True, False), (False, True),
                                        (True, True)])
def test_augment2d_matches_jax_on_the_same_draws(monkeypatch, noise, mask):
    port, ref = _params()
    _same_draws(monkeypatch, 4)
    x = np.concatenate([_np((3, 16, 17, 2), 2, 0.5),
                        np.ones((3, 16, 17, 1), np.float32)], -1)
    got = aug.augment2d(torch.Generator().manual_seed(0), torch.from_numpy(x),
                        port, noise=noise, mask=mask, mask_ratio=0.2,
                        mask_T_ratio=0.25)
    want = jaug.augment2d(jax.random.PRNGKey(0), jnp.asarray(x), ref,
                          noise=noise, mask=mask, mask_ratio=0.2,
                          mask_T_ratio=0.25)
    assert got.shape == (3, 16, 17, 3) and got.dtype == torch.float32
    # a few fp32 ulps of values up to ~1: the interpolation weights, the
    # square root and the division round differently in the two packages
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6)
    assert not np.array_equal(got.numpy(), x)


def test_augment2d_ranges_rates_and_seeding():
    port, _ = _params()
    x = np.concatenate([_np((16, 81, 17, 2), 3, 0.5),
                        np.ones((16, 81, 17, 1), np.float32)], -1)
    xt = torch.from_numpy(x)
    run = lambda seed, **kw: aug.augment2d(
        torch.Generator().manual_seed(seed), xt, port,
        **{**dict(noise=True, mask=True, mask_ratio=0.1, mask_T_ratio=0.2),
           **kw})
    out = run(0)
    assert torch.equal(out, run(0)) and not torch.equal(out, run(1))
    noisy = run(0, mask=False)
    conf = noisy[..., 2]
    assert 0.0 <= conf.min() and conf.max() <= 1.0 and conf.std() > 0.05
    delta = (noisy[..., :2] - xt[..., :2]).abs()
    assert 0 < delta.mean() < 0.05          # detector-like jitter
    masked = run(0, noise=False)
    gone = (masked == 0).all(-1)                        # (N, T, J)
    frame_gone = gone.all(0).all(-1)                    # (T,)
    # 81 frame draws at 0.2 (std 0.044) and ~17,000 joint draws at 0.1
    assert 0.02 <= frame_gone.float().mean() <= 0.38
    assert 0.09 <= gone[:, ~frame_gone].float().mean() <= 0.11
    assert torch.equal(masked[~gone], xt[~gone])
    assert aug.augment2d(torch.Generator(), xt, None, noise=False,
                         mask=False) is xt


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_posetrack2h36m_matches_jax(dtype):
    from motionbert_tpu.geometry.skeleton import posetrack2h36m as jremap
    from motionbert_tpu_torch.geometry.skeleton import posetrack2h36m

    x = (_np((5, 17, 3), 5) * 100).astype(dtype)
    got, want = posetrack2h36m(x), jremap(x)
    assert got.dtype == want.dtype and got.shape == (5, 17, 3)
    np.testing.assert_array_equal(got, want)
    # the root's confidence is the weaker hip's
    np.testing.assert_array_equal(got[:, 0, 2],
                                  np.minimum(x[:, 11, 2], x[:, 12, 2]))


def test_2d_datasets_match_jax():
    from motionbert_tpu.data.datasets import InstaVDataset2D as JInstaV
    from motionbert_tpu.data.datasets import PoseTrackDataset2D as JPoseTrack
    from motionbert_tpu_torch.data.datasets import (
        InstaVDataset2D, PoseTrackDataset2D)

    root = os.path.join(MOTION2D, "posetrack", "train") + os.sep
    port, ref = PoseTrackDataset2D(data_root=root), JPoseTrack(data_root=root)
    assert len(port) == len(ref) > 0
    np.testing.assert_array_equal(port.motions_2d, ref.motions_2d)
    a, b = port[0]
    assert a is b and a.shape == (30, 17, 3) and a.dtype == np.float32

    root = os.path.join(MOTION2D, "instav")
    port, ref = InstaVDataset2D(data_root=root), JInstaV(data_root=root)
    assert len(port) == len(ref) > 0
    for ds in (port, ref):
        ds.set_seed(7)
        ds.set_epoch(3)
    for i in (0, len(port) - 1):
        for got, want in zip(port[i], ref[i]):
            assert got.shape == (81, 17, 3) and got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    port.set_epoch(4)   # another epoch, another crop scale
    assert not np.array_equal(port[0][0], ref[0][0])
    with pytest.raises(FileNotFoundError):
        PoseTrackDataset2D(data_root=os.path.join(MOTION2D, "missing"))
    with pytest.raises(FileNotFoundError):
        InstaVDataset2D(data_root=os.path.join(MOTION2D, "missing"))


@pytest.mark.parametrize("rootrel", [True, False])
@pytest.mark.parametrize("no_conf", [True, False])
def test_preprocess_batch_2d_matches_jax(rootrel, no_conf):
    from motionbert_tpu.train.pose3d import preprocess_batch as jprep
    from motionbert_tpu_torch.train.pose3d import preprocess_batch

    x = _np((2, 6, 17, 3), 6)
    got = preprocess_batch(torch.from_numpy(x), torch.from_numpy(x),
                           rootrel=rootrel, no_conf=no_conf, has_3d=False)
    want = jprep(jnp.asarray(x), jnp.asarray(x), rootrel=rootrel,
                 no_conf=no_conf, has_3d=False)
    assert got[2].shape == (2, 6, 17, 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert preprocess_batch(torch.from_numpy(x), torch.from_numpy(x),
                            rootrel=rootrel, no_conf=no_conf)[2] is None


def test_loss_2d_weighted_matches_jax():
    from motionbert_tpu.losses import loss_2d_weighted as jloss
    from motionbert_tpu_torch.losses.pose import loss_2d_weighted

    pred, gt = _np((2, 6, 17, 3), 7), _np((2, 6, 17, 3), 8)
    conf = np.random.RandomState(9).uniform(size=(2, 6, 17, 1)).astype(
        np.float32)
    conf[0, 0] = 0      # unseen joints: zero weight, zero (not NaN) gradient
    p = torch.from_numpy(pred).requires_grad_()
    loss = loss_2d_weighted(p, torch.from_numpy(gt), torch.from_numpy(conf))
    loss.backward()
    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(pred), jnp.asarray(gt),
                                       jnp.asarray(conf))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), atol=1e-7)
    assert torch.isfinite(p.grad).all() and not p.grad[..., 2].any()


CFG = dict(dim_in=3, dim_out=3, dim_feat=32, dim_rep=32, depth=1,
           num_heads=4, mlp_ratio=2, num_joints=17, maxlen=9)


def test_train_step_on_2d_data():
    """has_3d False: the 2D loss on the confidence-weighted reprojection,
    equal to the JAX functions on the same parameters; has_gt False keeps
    the noise off; the generator is needed only where something draws."""
    from motionbert_tpu.losses import loss_2d_weighted as jloss
    from motionbert_tpu.models.dstformer import DSTformer
    from motionbert_tpu_torch.models.convert import state_dict_from_jax
    from motionbert_tpu_torch.models.factory import load_backbone
    from motionbert_tpu_torch.train.pose3d import make_train_step
    from motionbert_tpu_torch.train.state import make_adamw

    jmodel = DSTformer(**CFG)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 9, 17, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rs = np.random.RandomState(0)
    m = np.concatenate([rs.uniform(-1, 1, (4, 9, 17, 2)),
                        rs.uniform(0, 1, (4, 9, 17, 1))], -1).astype(np.float32)
    want = jloss(jmodel.apply({"params": params}, jnp.asarray(m)),
                 jnp.asarray(m - m[:, :, 0:1]), jnp.asarray(m[..., 2:]))

    def build():
        model = load_backbone(ConfigDict(CFG), device="cpu")
        model.load_state_dict(state_dict_from_jax(params), strict=True)
        return model, make_adamw(model.parameters(), 1e-3, 0.01)

    model, opt = build()
    before = [p.detach().clone() for p in model.parameters()]
    step = make_train_step(model, opt, {}, rootrel=True, no_conf=False)
    x = torch.from_numpy(m)
    terms = step(x, x, has_3d=False, has_gt=False)
    assert set(terms) == {"2d_proj", "total"}
    np.testing.assert_allclose(terms["2d_proj"].item(), float(want), rtol=1e-5)
    assert any(not torch.equal(a, b)
               for a, b in zip(before, model.parameters()))

    port_noise, _ = _params()
    with pytest.raises(ValueError, match="generator"):
        make_train_step(model, opt, {}, rootrel=True, no_conf=False,
                        use_mask=True, mask_ratio=0.1, mask_T_ratio=0.1)
    with pytest.raises(ValueError, match="noise_params"):
        make_train_step(model, opt, {}, rootrel=True, no_conf=False,
                        use_noise=True, generator=torch.Generator())
    # the noise applies only where has_gt: without it the first step's loss
    # is the clean one, with it another
    losses = {}
    for has_gt in (False, True):
        model, opt = build()
        step = make_train_step(model, opt, {}, rootrel=True, no_conf=False,
                               use_noise=True, noise_params=port_noise,
                               generator=torch.Generator().manual_seed(0))
        losses[has_gt] = step(x, x, has_3d=False, has_gt=has_gt)["2d_proj"]
    np.testing.assert_allclose(losses[False].item(), float(want), rtol=1e-5)
    assert losses[True].item() != losses[False].item()


def _args(**kw):
    args = get_config(PRETRAIN)
    for key in ("data_root", "dt_root", "posetrack_root", "instav_root",
                "noise_path", "d2c_params_path"):
        args[key] = os.path.join(ROOT, args[key])
    args.update(kw)
    return args


def _opts(ckpt):
    return types.SimpleNamespace(checkpoint=str(ckpt), pretrained="",
                                 resume="", evaluate="", selection="", seed=0)


def test_pretrain_cli_trains_2d_epochs_and_resumes(tmp_path, capsys):
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint
    from motionbert_tpu_torch.train.pose3d import main, train_with_config

    full = main(["--config", PRETRAIN, "-c", str(tmp_path / "a"),
                 "--device", "cpu"])
    hist = full["history"]
    assert [h["epoch"] for h in hist] == [0, 1]
    # curriculum 1: epoch 0 is 3D only, the 2D sets join at epoch 1
    assert "2d_proj" not in hist[0]["losses"]
    assert {"2d_proj", "3d_pos", "total"} <= set(hist[1]["losses"])
    assert all(np.isfinite(list(h["losses"].values()) + [h["e1"], h["e2"]]).all()
               for h in hist)
    assert sorted(os.listdir(tmp_path / "a")) == [
        "best_epoch.ckpt", "epoch_1.ckpt", "latest_epoch.ckpt", "logs"]
    tags = {json.loads(l)["tag"] for l in
            open(tmp_path / "a" / "logs" / "scalars.jsonl")}
    assert {"Error P1", "loss_2d_proj", "loss_3d_pos", "loss_total"} <= tags
    assert "WARNING" not in capsys.readouterr().out

    # one epoch, then a resumed second one: the generator ends where the
    # uninterrupted run's does, so the resumed epoch drew the flips, the
    # corruption and the masks that run drew
    train_with_config(_args(epochs=1), _opts(tmp_path / "b"), device="cpu")
    first = load_checkpoint(str(tmp_path / "b" / "latest_epoch.ckpt"))
    resumed = train_with_config(_args(), _opts(tmp_path / "b"), device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert "2d_proj" in resumed["history"][0]["losses"]
    a = load_checkpoint(str(tmp_path / "a" / "latest_epoch.ckpt"))
    b = load_checkpoint(str(tmp_path / "b" / "latest_epoch.ckpt"))
    assert a["epoch"] == b["epoch"] == 2
    assert torch.equal(a["rng"], b["rng"])
    assert not torch.equal(a["rng"], first["rng"])


def test_pretrain_driver_skips_a_missing_2d_set(tmp_path, capsys):
    from motionbert_tpu_torch.train.pose3d import train_with_config

    out = train_with_config(
        _args(epochs=1, pretrain_3d_curriculum=0, no_eval=True,
              posetrack_root=os.path.join(MOTION2D, "missing")),
        _opts(tmp_path), device="cpu")
    assert "WARNING: 2D dataset PoseTrackDataset2D unavailable" in \
        capsys.readouterr().out
    losses = out["history"][0]["losses"]     # InstaVariety still trains
    assert {"2d_proj", "3d_pos"} <= set(losses)
    assert out["history"][0]["e1"] is None
