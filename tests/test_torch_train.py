"""The port's pose3d training path against the JAX package's: losses, the
AdamW optimizer, the whole train step, the data pipeline, evaluation and the
epoch driver with its checkpoints. Inputs are made with numpy and given to
both packages; JAX runs on the CPU."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from motionbert_tpu_torch.core.config import ConfigDict, get_config
from motionbert_tpu_torch.models.convert import (
    jax_from_state_dict, state_dict_from_jax)
from motionbert_tpu_torch.models.factory import load_backbone

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "pose3d", "MB_train_synth_smoke.yaml")
LAMBDAS = dict(lambda_scale=0.5, lambda_3d_velocity=20.0, lambda_lv=0.3,
               lambda_lg=0.2, lambda_a=0.4, lambda_av=0.6)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _pose_pair(seed, root_relative):
    rs = np.random.RandomState(seed)
    pred = rs.normal(size=(2, 6, 17, 3)).astype(np.float32)
    gt = rs.normal(size=(2, 6, 17, 3)).astype(np.float32)
    if root_relative:
        pred[:, :, 0] = 0
        gt[:, :, 0] = 0
    return pred, gt


@pytest.mark.parametrize("root_relative", [False, True])
def test_losses_and_their_gradient_match_jax(root_relative):
    from motionbert_tpu.losses import pose3d_total_loss as jloss
    from motionbert_tpu_torch.losses.pose import pose3d_total_loss

    pred, gt = _pose_pair(0, root_relative)
    (jtotal, jterms), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jnp.asarray(gt), LAMBDAS), has_aux=True))(
            jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    total, terms = pose3d_total_loss(tp, torch.from_numpy(gt), LAMBDAS)
    total.backward()
    assert set(terms) == set(jterms) and len(terms) == 8
    for k in terms:
        np.testing.assert_allclose(terms[k].item(), float(jterms[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # root-relative rows put zero-length differences into every norm: the
    # gradient stays finite (safe_norm's zero subgradient) and equals JAX's
    assert torch.isfinite(tp.grad).all()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-6)


def test_safe_norm_has_a_zero_gradient_at_zero():
    from motionbert_tpu_torch.losses.pose import safe_norm

    x = torch.tensor([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0]], requires_grad=True)
    n = safe_norm(x)
    n.sum().backward()
    assert n.tolist() == [0.0, 5.0]
    assert x.grad[0].tolist() == [0.0, 0.0, 0.0]
    np.testing.assert_allclose(x.grad[1].numpy(), [0.6, 0.8, 0.0])


def test_single_frame_clips_give_zero_temporal_terms():
    from motionbert_tpu_torch.losses.pose import pose3d_total_loss

    pred, gt = _pose_pair(1, True)
    _, terms = pose3d_total_loss(torch.from_numpy(pred[:, :1]),
                                 torch.from_numpy(gt[:, :1]), LAMBDAS)
    for k in ("3d_velocity", "lv", "angle_velocity"):
        assert terms[k].item() == 0.0


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_set_and_scale_lr_match_optax():
    from motionbert_tpu.train.state import make_adamw as jadamw
    from motionbert_tpu_torch.train.state import make_adamw, scale_lr, set_lr

    rs = np.random.RandomState(0)
    params = {"a": rs.normal(size=(4, 3)).astype(np.float32),
              "b": rs.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rs.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(4)]
    tx = jadamw(1e-2, 0.05)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_adamw(tp.values(), 1e-2, 0.05)
    for i, g in enumerate(grads):
        if i == 2:  # the epoch loop's decay, then an explicit rate
            js.hyperparams["learning_rate"] = jnp.asarray(1e-2 * 0.9)
            scale_lr(opt, 0.9)
        if i == 3:
            js.hyperparams["learning_rate"] = jnp.asarray(3e-3)
            set_lr(opt, 3e-3)
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    assert opt.param_groups[0]["lr"] == pytest.approx(3e-3)


def test_freeze_except_matches_optax_set_to_zero():
    from motionbert_tpu.train.state import freeze_except as jfreeze
    from motionbert_tpu.train.state import make_adamw as jadamw
    from motionbert_tpu_torch.train.state import freeze_except, make_adamw

    model = torch.nn.ModuleDict({"head": torch.nn.Linear(3, 2),
                                 "body": torch.nn.Linear(3, 3)})
    names = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in names.items()}
    jparams = {k: jnp.asarray(v.numpy()) for k, v in before.items()}
    tx = jfreeze(jadamw(1e-2, 0.1), jparams, ["head"])
    upd, _ = tx.update({k: jnp.ones_like(v) for k, v in jparams.items()},
                       tx.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, upd)

    opt = make_adamw(freeze_except(model, ["head"]), 1e-2, 0.1)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    for k, p in names.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jnew[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        assert torch.equal(p.detach(), before[k]) == (not k.startswith("head"))


# ---------------------------------------------------------------------------
# the whole train step
# ---------------------------------------------------------------------------

# one dual layer: its four pairs and the gate; deeper stacks only repeat them
CFG = dict(dim_in=3, dim_out=3, dim_feat=32, dim_rep=32, depth=1,
           num_heads=4, mlp_ratio=2, num_joints=17, maxlen=9)


def test_train_step_matches_jax():
    """First-step gradients per tensor and three steps' loss terms of the
    port's step (pairs through the autograd Functions, plain on the CPU,
    fp32) against the JAX step (XLA path, fp32) from the same params."""
    from motionbert_tpu.models.dstformer import DSTformer
    from motionbert_tpu.train.pose3d import make_train_step as jstep_fn
    from motionbert_tpu.train.state import TrainState
    from motionbert_tpu.train.state import make_adamw as jadamw
    from motionbert_tpu.losses import pose3d_total_loss as jloss
    from motionbert_tpu_torch.train.pose3d import make_train_step
    from motionbert_tpu_torch.train.state import make_adamw

    lr, wd = 1e-3, 0.01
    jmodel = DSTformer(**CFG)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 9, 17, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rs = np.random.RandomState(0)
    gt = rs.uniform(-1, 1, (4, 9, 17, 3)).astype(np.float32)
    inp = np.concatenate([gt[..., :2], np.ones((4, 9, 17, 1), np.float32)], -1)

    model = load_backbone(ConfigDict(CFG), device="cpu", attn_impl="kernel")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    opt = make_adamw(model.parameters(), lr, wd)
    step = make_train_step(model, opt, LAMBDAS, rootrel=True, no_conf=False)

    # JAX's first-step gradient, as its step takes it
    rel_gt = jnp.asarray(gt - gt[:, :, 0:1])
    jgrads = jax.jit(jax.grad(lambda p: jloss(jmodel.apply(
        {"params": p}, jnp.asarray(inp), deterministic=False),
        rel_gt, LAMBDAS)[0]))(params)
    jstate = TrainState.create(jmodel.apply, params, jadamw(lr, wd))
    jstep = jstep_fn(jmodel, LAMBDAS, rootrel=True, no_conf=False,
                     use_mask=False, use_noise=False, noise_params=None)

    x, y = torch.from_numpy(inp), torch.from_numpy(gt)
    for i in range(3):
        terms = step(x, y)
        jstate, jterms = jstep(jstate, jnp.asarray(inp), jnp.asarray(gt),
                               jax.random.PRNGKey(i))
        for k in jterms:
            np.testing.assert_allclose(terms[k].item(), float(jterms[k]),
                                       rtol=1e-3, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        if i == 0:
            grads = _flat(jax_from_state_dict(
                {k: p.grad for k, p in model.named_parameters()}))
            ref = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
            assert grads.keys() == ref.keys() and len(grads) > 50
            for k in ref:
                np.testing.assert_allclose(grads[k], ref[k], rtol=1e-4,
                                           atol=1e-4, err_msg=k)
    # where the gradient stands well above fp32 noise, both moved the same
    # way; Adam's first steps move every weight by about lr regardless
    got = _flat(jax_from_state_dict(model.state_dict()))
    want = _flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    for k, g in _flat(jax.tree_util.tree_map(np.asarray, jgrads)).items():
        strong = np.abs(g) > 1e-3
        np.testing.assert_allclose(got[k][strong], want[k][strong],
                                   rtol=1e-4, atol=2e-5, err_msg=k)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

SYNTH = dict(n_frames=16, sample_stride=1, data_stride_train=8,
             data_stride_test=16, dt_root=os.path.join(ROOT, "data",
                                                       "synthetic", "motion3d"),
             dt_file="h36m_synth_cam_source.pkl")


def test_reader_matches_jax():
    from motionbert_tpu.data.readers import DataReaderH36M as JReader
    from motionbert_tpu_torch.data.readers import DataReaderH36M

    port, ref = DataReaderH36M(**SYNTH), JReader(**SYNTH)
    for a, b in zip(port.get_sliced_data(), ref.get_sliced_data()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.get_split_id(), ref.get_split_id()):
        assert [list(c) for c in a] == [list(c) for c in b]
    np.testing.assert_array_equal(port.get_hw(), ref.get_hw())
    clips = port.get_sliced_data()[3]
    np.testing.assert_array_equal(port.denormalize(clips),
                                  ref.denormalize(clips))


def _smoke_args():
    args = get_config(SMOKE)
    args.data_root = os.path.join(ROOT, args.data_root)
    args.dt_root = os.path.join(ROOT, args.dt_root)
    return args


def test_dataset_items_and_loader_order_match_jax():
    from motionbert_tpu.core.config import ConfigDict as JConfig
    from motionbert_tpu.data.datasets import BatchLoader as JLoader
    from motionbert_tpu.data.datasets import MotionDataset3D as JDataset
    from motionbert_tpu_torch.data.datasets import BatchLoader, MotionDataset3D

    args = _smoke_args()
    for split in ("train", "test"):
        port = MotionDataset3D(args, args.subset_list, split)
        ref = JDataset(JConfig(dict(args)), args.subset_list, split)
        assert len(port) == len(ref) > 0
        for i in (0, len(port) - 1):
            for a, b in zip(port[i], ref[i]):
                assert a.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    loaders = [BatchLoader(port, 8, shuffle=True, drop_last=True, seed=3),
               JLoader(ref, 8, shuffle=True, drop_last=True, seed=3)]
    for _ in range(2):  # two epochs: the shuffle stream carries over
        got, want = (list(loader) for loader in loaders)
        assert len(got) == len(want) == len(port) // 8
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_item_rng_matches_jax():
    from motionbert_tpu.data.datasets import EpochSeededRNG as JRNG
    from motionbert_tpu_torch.data.datasets import EpochSeededRNG

    port, ref = EpochSeededRNG(), JRNG()
    for r in (port, ref):
        r.set_seed(7)
        r.set_epoch(3)
    assert port.item_rng(11).uniform() == ref.item_rng(11).uniform()


# ---------------------------------------------------------------------------
# evaluation and the epoch driver
# ---------------------------------------------------------------------------

def test_evaluate_matches_jax():
    from motionbert_tpu.data.datasets import BatchLoader as JLoader
    from motionbert_tpu.data.datasets import MotionDataset3D as JDataset
    from motionbert_tpu.core.config import ConfigDict as JConfig
    from motionbert_tpu.data.readers import DataReaderH36M as JReader
    from motionbert_tpu.models.dstformer import DSTformer
    from motionbert_tpu.train.pose3d import evaluate as jevaluate
    from motionbert_tpu_torch.data.datasets import BatchLoader, MotionDataset3D
    from motionbert_tpu_torch.data.readers import DataReaderH36M
    from motionbert_tpu_torch.train.pose3d import evaluate

    args = _smoke_args()
    cfg = dict(CFG, dim_feat=args.dim_feat, dim_rep=args.dim_rep,
               num_heads=args.num_heads, maxlen=args.maxlen)
    jmodel = DSTformer(**cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 16, 17, 3)))["params"]
    jargs = JConfig(dict(args))
    je1, je2, _ = jevaluate(
        jargs, jmodel, params,
        JLoader(JDataset(jargs, args.subset_list, "test"), 8),
        JReader(**SYNTH))
    model = load_backbone(ConfigDict(cfg), device="cpu")
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    e1, e2, results = evaluate(
        args, model, BatchLoader(MotionDataset3D(args, args.subset_list,
                                                 "test"), 8),
        DataReaderH36M(**SYNTH))
    assert results.shape[1:] == (16, 17, 3) and np.all(results[:, :, 0] == 0)
    assert abs(e1 - je1) <= 1e-2 and abs(e2 - je2) <= 1e-2, (e1, je1, e2, je2)


def _opts(ckpt, **kw):
    return types.SimpleNamespace(**dict(dict(
        checkpoint=str(ckpt), pretrained="", resume="", evaluate="",
        selection="", seed=0), **kw))


def test_driver_trains_saves_roles_and_resumes(tmp_path):
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint
    from motionbert_tpu_torch.train.pose3d import train_with_config

    args = _smoke_args()
    full = train_with_config(args, _opts(tmp_path / "a"), device="cpu")
    hist = full["history"]
    assert [h["epoch"] for h in hist] == [0, 1]
    assert hist[1]["losses"]["total"] < hist[0]["losses"]["total"]
    assert all(np.isfinite([h["e1"], h["e2"]]).all() for h in hist)
    assert sorted(os.listdir(tmp_path / "a")) == [
        "best_epoch.ckpt", "epoch_1.ckpt", "latest_epoch.ckpt", "logs"]
    tags = {json.loads(l)["tag"] for l in
            open(tmp_path / "a" / "logs" / "scalars.jsonl")}
    assert {"Error P1", "Error P2", "loss_total"} <= tags

    # one epoch, then a second run that resumes from latest_epoch.ckpt
    args.epochs = 1
    train_with_config(args, _opts(tmp_path / "b"), device="cpu")
    first = load_checkpoint(str(tmp_path / "b" / "latest_epoch.ckpt"))
    assert first["epoch"] == 1 and first["lr"] == pytest.approx(5e-4 * 0.99)
    args.epochs = 2
    resumed = train_with_config(args, _opts(tmp_path / "b"), device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["history"][0]["lr"] == pytest.approx(5e-4 * 0.99)

    a = load_checkpoint(str(tmp_path / "a" / "latest_epoch.ckpt"))
    b = load_checkpoint(str(tmp_path / "b" / "latest_epoch.ckpt"))
    assert a["epoch"] == b["epoch"] == 2
    assert a["lr"] == pytest.approx(b["lr"])
    assert torch.equal(a["rng"], b["rng"])  # the flip stream carried over
    steps = lambda p: [s["step"].item() for s in
                       p["optimizer"]["state"].values()]
    assert steps(a) == steps(b) == [2 * 5] * len(steps(a))
    # the optimizer state restored at the resume is the one epoch 1 saved,
    # and that equals the uninterrupted run's at the same epoch
    assert os.path.exists(tmp_path / "a" / "best_epoch.ckpt")
    resume_from = load_checkpoint(str(tmp_path / "b" / "epoch_0.ckpt")) \
        if os.path.exists(tmp_path / "b" / "epoch_0.ckpt") else first
    for sa, sb in zip(first["optimizer"]["state"].values(),
                      resume_from["optimizer"]["state"].values()):
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
