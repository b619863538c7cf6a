"""The port's mesh task (rotations, the alignment metrics, SMPL, the mesh
head, the mesh loss, the mesh data, the train and eval steps, the epoch
driver and the wild-mesh command line) against the JAX package on the CPU.

Inputs come from numpy seeds, the reference goldens, the synthetic mesh set
(``data/synthetic/mesh/``: a 128-vertex body model and 3DPW-shaped clips) and
``configs/mesh/MB_train_synth_smoke.yaml``. Tolerances: goldens 2e-5; numpy
on both sides equal (the data, the synthetic body model); fp32 SMPL 1e-5 of
the largest value; a depth-1 MeshRegressor and its steps 1e-4 of each
output's largest value and 2e-4 for gradients (summation order only).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionbert_tpu.data import dataset_mesh as jdm
from motionbert_tpu.data import readers as jreaders
from motionbert_tpu.geometry import procrustes as jpro
from motionbert_tpu.geometry import rotations as jrot
from motionbert_tpu.losses import mesh as jmesh_loss
from motionbert_tpu.losses import pose as jpose
from motionbert_tpu.models import smpl as jsmpl
from motionbert_tpu.models.dstformer import DSTformer as JDSTformer
from motionbert_tpu.models.mesh_head import MeshRegressor as JMeshRegressor
from motionbert_tpu.train.action import make_two_group_adamw as j_adamw
from motionbert_tpu.train.mesh import (
    make_mesh_eval_step as j_eval_step, make_mesh_train_step as j_train_step)
from motionbert_tpu.train.state import TrainState
from motionbert_tpu_torch.core.config import ConfigDict, get_config
from motionbert_tpu_torch.data import dataset_mesh as tdm
from motionbert_tpu_torch.data import readers as treaders
from motionbert_tpu_torch.geometry import procrustes as tpro
from motionbert_tpu_torch.geometry import rotations as trot
from motionbert_tpu_torch.infer import wild_mesh as twm
from motionbert_tpu_torch.losses import mesh as tmesh_loss
from motionbert_tpu_torch.losses import pose as tpose
from motionbert_tpu_torch.models import dstformer as tmodel
from motionbert_tpu_torch.models import smpl as tsmpl
from motionbert_tpu_torch.models.convert import (
    jax_batch_stats_from_state_dict, jax_from_state_dict,
    state_dict_from_jax)
from motionbert_tpu_torch.train import action
from motionbert_tpu_torch.train import mesh as tmesh
from motionbert_tpu_torch.train.state import make_two_group_adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
SMOKE = os.path.join(ROOT, "configs", "mesh", "MB_train_synth_smoke.yaml")
SMPL_NPZ = os.path.join(ROOT, "data", "synthetic", "mesh", "smpl_model.npz")
N, T = 4, 8


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The models here are tiny: one intra-op thread runs them faster than a
    pool that contends for the cores with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# rotations, metrics, losses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rot_golden():
    return np.load(os.path.join(GOLDENS, "rotations.npz"))


@pytest.mark.parametrize("fn,inp,out", [
    ("batch_rodrigues", "aa_in", "rodrigues_out"),
    ("quat2mat", "quat_in", "quat2mat_out"),
    ("rot6d_to_rotmat", "rot6d_in", "rot6d_out"),
    ("rotmat_to_angle_axis", "rodrigues_out", "rotmat2aa_out"),
    ("flip_thetas", "thetas_in", "flip_thetas_out")])
def test_rotations_match_the_goldens(rot_golden, fn, inp, out):
    got = getattr(trot, fn)(torch.from_numpy(rot_golden[inp]).float())
    np.testing.assert_allclose(got.numpy(), rot_golden[out], atol=2e-5)
    if fn == "flip_thetas":
        np.testing.assert_array_equal(
            trot.flip_thetas_np(rot_golden[inp]), rot_golden[out])


def _rotmats(n, seed):
    """Rotation matrices that reach every branch of Shepperd's method,
    angles near pi and the identity included."""
    rs = np.random.RandomState(seed)
    aa = rs.normal(size=(n, 3))
    aa /= np.linalg.norm(aa, axis=-1, keepdims=True)
    angles = np.concatenate([rs.uniform(0, np.pi, n - 8),
                             [np.pi - 1e-3, np.pi - 1e-6, np.pi, 0.0, 1e-7,
                              np.pi / 2, 3.0, 3.1]])
    aa = (aa * angles[:, None]).astype(np.float32)
    return np.asarray(jrot.batch_rodrigues(jnp.asarray(aa)))


@pytest.mark.parametrize("fn", ["rotmat_to_quaternion",
                                "quaternion_to_angle_axis",
                                "rotmat_to_angle_axis", "f_normalize",
                                "rot6d_to_rotmat_spin", "rectify_pose"])
def test_rotations_match_jax(fn):
    """The functions the goldens do not cover, against the JAX package's on
    the same inputs (fp32 2e-5; near pi the two may pick the other
    Shepperd branch only where both branches agree to that bar)."""
    R = _rotmats(64, 0)
    rs = np.random.RandomState(1)
    if fn == "rotmat_to_quaternion":
        args = (R,)
    elif fn == "quaternion_to_angle_axis":
        q = rs.normal(size=(64, 4)).astype(np.float32)
        q[:4, 1:] = 0.0                        # the identity branch
        args = (q / np.linalg.norm(q, axis=-1, keepdims=True),)
    elif fn == "rotmat_to_angle_axis":
        args = (R,)
    elif fn == "f_normalize":
        v = rs.normal(size=(16, 6)).astype(np.float32)
        v[0] = 0.0                             # a zero vector maps to zero
        args = (v,)
    elif fn == "rot6d_to_rotmat_spin":
        v = rs.normal(size=(16, 6)).astype(np.float32)
        v[0, ::2] = 0.0                        # a degenerate first column
        args = (v,)
    else:
        pose = rs.normal(0, 0.5, 72).astype(np.float32)
        np.testing.assert_allclose(trot.rectify_pose(pose),
                                   jrot.rectify_pose(pose), atol=2e-5)
        return
    want = np.asarray(getattr(jrot, fn)(*map(jnp.asarray, args)))
    got = getattr(trot, fn)(*map(torch.from_numpy, args)).numpy()
    if fn == "rotmat_to_quaternion":   # q and -q are the same rotation
        got = got * np.sign((got * want).sum(-1, keepdims=True))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_rectify_pose_under_float64_defaults_matches_jax():
    """rectify_pose pins both of its rotations to float32, as the JAX
    package does, so a float64 default dtype changes nothing (it raised a
    dtype mismatch in the product of the two)."""
    pose = np.random.RandomState(2).normal(0, 0.5, 72).astype(np.float32)
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        got = trot.rectify_pose(pose)
    finally:
        torch.set_default_dtype(saved)
    np.testing.assert_allclose(got, jrot.rectify_pose(pose), atol=2e-5)
    np.testing.assert_array_equal(got, trot.rectify_pose(pose))


def test_rotation_gradients_are_finite_at_the_identity():
    eye = torch.eye(3).repeat(4, 1, 1).requires_grad_()
    trot.rotmat_to_angle_axis(eye).sum().backward()
    assert torch.isfinite(eye.grad).all()


def test_mesh_metrics_match_the_golden():
    z = np.load(os.path.join(GOLDENS, "mesh_eval.npz"))
    results = {k: z[k].astype(np.float32)
               for k in ("verts", "verts_gt", "kp_3d", "kp_3d_gt")}
    err = tmesh_loss.evaluate_mesh(results)
    for k in ("mpve", "mpjpe", "pa_mpjpe", "mpjpe_17j", "pa_mpjpe_17j"):
        np.testing.assert_allclose(err[k], float(z[f"em_{k}"]), rtol=2e-5,
                                   err_msg=k)
    assert err["pa_mpjpe"] < 0.1 * err["mpjpe"]
    pred = {"verts": results["verts"], "kp_3d": results["kp_3d"]}
    gt = {"verts": results["verts_gt"], "kp_3d": results["kp_3d_gt"]}
    mpjpe, mpve = tmesh_loss.compute_error(pred, gt)
    np.testing.assert_allclose([mpjpe, mpve],
                               [float(z["ce_mpjpe"]), float(z["ce_mpve"])],
                               rtol=2e-5)
    mpjpes, mpves = tmesh_loss.compute_error_frames(
        {k: torch.from_numpy(v) for k, v in pred.items()}, gt)
    np.testing.assert_allclose(mpjpes, z["cef_mpjpes"], rtol=2e-5)
    np.testing.assert_allclose(mpves, z["cef_mpves"], rtol=2e-5)


def test_procrustes_and_translation_match_jax():
    rs = np.random.RandomState(3)
    A = rs.normal(size=(17, 3))
    B = 1.3 * A @ np.linalg.qr(rs.normal(size=(3, 3)))[0] + 0.5
    for got, want in zip(tpro.rigid_transform_3d(A, B),
                         jpro.rigid_transform_3d(A, B)):
        np.testing.assert_allclose(got, want, atol=1e-10)
    np.testing.assert_allclose(tpro.rigid_align(A, B), B, atol=1e-8)
    S = rs.normal(size=(3, 49, 3)) + [0, 0, 5.0]
    j2d = np.concatenate([rs.uniform(0, 224, (3, 49, 2)),
                          rs.uniform(0.2, 1, (3, 49, 1))], -1)
    np.testing.assert_array_equal(tpro.estimate_translation(S, j2d),
                                  jpro.estimate_translation(S, j2d))
    np.testing.assert_allclose(
        tpro.estimate_translation_np(S[0], j2d[0, :, :2], j2d[0, :, 2]),
        jpro.estimate_translation_np(S[0], j2d[0, :, :2], j2d[0, :, 2]),
        rtol=1e-12)


def test_pose_loss_riders_match_the_golden_and_jax():
    z = np.load(os.path.join(GOLDENS, "losses.npz"))
    got = tpose.weighted_mpjpe(*(torch.from_numpy(z[k])
                                 for k in ("pred", "gt", "w")))
    np.testing.assert_allclose(got.item(), float(z["weighted_mpjpe"]),
                               rtol=2e-5)
    rs = np.random.RandomState(4)
    a, b = rs.uniform(0.5, 2, (2, 4, 9, 16)).astype(np.float32)
    for name in ("weighted_bonelen_loss", "weighted_boneratio_loss"):
        np.testing.assert_allclose(
            getattr(tpose, name)(torch.from_numpy(a), torch.from_numpy(b)),
            float(getattr(jpose, name)(jnp.asarray(a), jnp.asarray(b))),
            rtol=2e-5, err_msg=name)


# ---------------------------------------------------------------------------
# SMPL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_verts,seed", [(128, 0), (6890, 3)])
def test_synthetic_model_equals_jax(num_verts, seed):
    j = jsmpl.SMPLModel.synthetic(num_verts=num_verts, seed=seed)
    t = tsmpl.SMPLModel.synthetic(num_verts=num_verts, seed=seed)
    for name in jsmpl.SMPLModel._ARRAY_FIELDS:
        want = getattr(j, name)
        if want is None:
            assert getattr(t, name) is None, name
        else:
            np.testing.assert_array_equal(t.numpy(name), want, err_msg=name)
    np.testing.assert_array_equal(t.parents, j.parents)
    assert t.state_dict() == {}   # the body model is not a network weight


def test_npz_model_loads_like_jax():
    j, t = jsmpl.SMPLModel.from_npz(SMPL_NPZ), tsmpl.SMPLModel.from_npz(SMPL_NPZ)
    for name in jsmpl.SMPLModel._ARRAY_FIELDS:
        want = getattr(j, name)
        assert (getattr(t, name) is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(t.numpy(name), want, err_msg=name)


@pytest.mark.parametrize("pose2rot", [True, False])
def test_smpl_forward_matches_jax_and_numpy(pose2rot):
    model_j = jsmpl.SMPLModel.from_npz(SMPL_NPZ)
    model_t = tsmpl.SMPLModel.from_npz(SMPL_NPZ)
    rs = np.random.RandomState(5)
    betas = rs.normal(0, 1, (6, 10)).astype(np.float32)
    pose = rs.normal(0, 0.4, (6, 72)).astype(np.float32)
    if pose2rot:
        arg = pose
    else:
        arg = np.asarray(jrot.batch_rodrigues(jnp.asarray(
            pose.reshape(6, 24, 3))))
    want = jax.jit(lambda b, p: jsmpl.smpl_forward(model_j, b, p,
                                                   pose2rot=pose2rot))(
        jnp.asarray(betas), jnp.asarray(arg))
    got = tsmpl.smpl_forward(model_t, torch.from_numpy(betas),
                             torch.from_numpy(arg), pose2rot=pose2rot)
    for k in ("vertices", "joints", "rotmats"):
        assert got[k].dtype == torch.float32
        assert _rel(got[k].numpy(), want[k]) <= 1e-5, k
    oracle = tsmpl.smpl_forward_np(model_t, betas, pose)
    np.testing.assert_array_equal(
        oracle["vertices"], jsmpl.smpl_forward_np(model_j, betas, pose)[
            "vertices"])
    assert _rel(got["vertices"].numpy(), oracle["vertices"]) <= 1e-5
    np.testing.assert_allclose(
        tsmpl.vertices2joints(model_t.J_regressor_h36m, got["vertices"]),
        np.asarray(jsmpl.vertices2joints(model_j.J_regressor_h36m,
                                         want["vertices"])), atol=1e-5)


# ---------------------------------------------------------------------------
# the mesh model and its steps
# ---------------------------------------------------------------------------

BACKBONE = dict(dim_feat=32, dim_rep=32, depth=1, num_heads=4, mlp_ratio=2,
                num_joints=17, maxlen=T)
LAMBDAS = dict(lambda_3d=0.5, lambda_scale=0.1, lambda_3dv=10, lambda_lv=0.1,
               lambda_lg=0.1, lambda_a=0.1, lambda_av=0.1, lambda_pose=1000,
               lambda_shape=1, lambda_norm=20)


@pytest.fixture(scope="module")
def nets():
    """A depth-1 JAX MeshRegressor on the synthetic body model, its
    variables moved off their initial values, and the port's model carrying
    them (dropout off on both sides)."""
    jm = jsmpl.SMPLModel.from_npz(SMPL_NPZ)
    jmodel = JMeshRegressor(backbone=JDSTformer(dim_in=3, dim_out=3,
                                                **BACKBONE),
                            smpl_model=jm, dim_rep=32, hidden_dim=64,
                            dropout_ratio=0.0)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, T, 17, 3)))
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rs.normal(size=a.shape) * 0.02).astype(
            np.float32), variables["params"])
    stats = {"head": {bn: {"mean": rs.normal(size=64).astype(np.float32),
                           "var": rs.uniform(0.5, 1.5, 64).astype(np.float32)}
                      for bn in ("bn1", "bn2")}}
    cfg = ConfigDict(BACKBONE, hidden_dim=64, dropout=0.0)
    model = tmesh.build_mesh_model(cfg, tsmpl.SMPLModel.from_npz(SMPL_NPZ),
                                   device="cpu")
    return jmodel, jm, params, stats, model


def _fresh(nets):
    jmodel, jm, params, stats, model = nets
    action.load_action_state(model, state_dict_from_jax(params, stats))
    return jmodel, jm, params, stats, model


def _mesh_batch(jm, seed=2):
    """Inputs and SMPL ground truth of an (N, T) batch."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (N, T, 17, 3)).astype(np.float32)
    pose = rs.normal(0, 0.3, (N, T, 72)).astype(np.float32)
    shape = rs.normal(0, 1, (N, T, 10)).astype(np.float32)
    out = jsmpl.smpl_forward_np(jm, shape.reshape(-1, 10),
                                pose.reshape(-1, 72))
    verts = out["vertices"].reshape(N, T, -1, 3) * 1000.0
    kp = np.einsum("jv,btvc->btjc", jm.J_regressor_h36m, verts)
    gt = {"theta": np.concatenate([pose, shape], -1),
          "kp_3d": (kp - kp[:, :, :1]).astype(np.float32),
          "verts": (verts - kp[:, :, :1]).astype(np.float32)}
    return x, gt


def test_mesh_state_converts_both_ways(nets):
    _, _, params, stats, model = _fresh(nets)
    sd = state_dict_from_jax(params, stats)
    assert set(model.state_dict()) - set(sd) == set(action.JAX_MISSING_KEYS)
    assert {k for k in sd if k.startswith("head.bn")} == {
        f"head.{bn}.{leaf}" for bn in ("bn1", "bn2") for leaf in (
            "weight", "bias", "running_mean", "running_var",
            "num_batches_tracked")}
    back = _flatten(jax_from_state_dict(model.state_dict()))
    for k, v in _flatten(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    for k, v in _flatten(stats).items():
        np.testing.assert_array_equal(
            _flatten(jax_batch_stats_from_state_dict(model.state_dict()))[k],
            v, err_msg=k)


def test_jax_mesh_checkpoint_loads_with_its_batch_stats(nets, tmp_path):
    """A JAX mesh training checkpoint (params and batch_stats) loads into the
    port's MeshRegressor, BatchNorm buffers included; a port checkpoint
    keeps them too."""
    from motionbert_tpu.core.checkpoint import save_checkpoint
    from motionbert_tpu_torch.core.checkpoint import (
        CheckpointManager, load_state_dict)

    _, _, params, stats, model = _fresh(nets)
    path = str(tmp_path / "jax.ckpt")
    save_checkpoint(path, epoch=1, lr=1e-4, params=params,
                    extra_vars={"batch_stats": stats}, best_metric=90.0)
    sd = load_state_dict(path)
    for bn in ("bn1", "bn2"):
        np.testing.assert_array_equal(sd[f"head.{bn}.running_var"].numpy(),
                                      stats["head"][bn]["var"])
    action.load_action_state(model, sd)
    CheckpointManager(str(tmp_path / "port")).save_epoch(0, 1e-4, model)
    back = load_state_dict(str(tmp_path / "port" / "latest_epoch.ckpt"))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("training", [False, True])
def test_mesh_regressor_matches_jax(nets, training):
    """Evaluation mode (running statistics), and one training-mode forward
    (the batch's statistics, the running averages updated as flax does)."""
    jmodel, jm, params, stats, model = _fresh(nets)
    x, _ = _mesh_batch(jm)
    variables = {"params": params, "batch_stats": stats}
    if training:
        want, upd = jax.jit(lambda v, a: jmodel.apply(
            v, a, deterministic=False, mutable=["batch_stats"]))(
                variables, jnp.asarray(x))
        model.train()
    else:
        want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
        model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("theta", "verts", "kp_3d"):
        assert got[k].dtype == torch.float32
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k].numpy(), want[k]) <= 1e-4, k
    if training:
        new = _flatten(jax_batch_stats_from_state_dict(model.state_dict()))
        for k, v in _flatten(upd["batch_stats"]).items():
            np.testing.assert_allclose(new[k], v, atol=1e-5, rtol=1e-5,
                                       err_msg=k)


# A BatchNorm in training mode takes the batch mean out of the layer before
# it, so that layer's bias gets a gradient of rounding only; it is held
# against the BatchNorm bias's gradient.
VANISHING = {"head/fc1/bias": "head/bn1/bias", "head/fc2/bias": "head/bn2/bias"}


def _first_step_grads(new_state):
    """The gradients of a JAX two-group AdamW state after its first step:
    Adam's first moment is then (1 - 0.9) * g."""
    inner = new_state.opt_state.inner_states
    return {g: jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1,
        inner[g].inner_state.inner_state[0].mu[g])
        for g in ("backbone", "head")}


def test_mesh_train_step_matches_jax(nets):
    """One step: every loss term, the train-time MPJPE / MPVE, every
    gradient and the BatchNorm statistics after it."""
    jmodel, jm, params, stats, model = _fresh(nets)
    x, gt = _mesh_batch(jm)
    state = TrainState.create(jmodel.apply, params, j_adamw(1e-3, 1e-2, 0.01),
                              extra_vars={"batch_stats": stats})
    new_state, jterms = j_train_step(jmodel, LAMBDAS, "L1")(
        state, jnp.asarray(x), {k: jnp.asarray(v) for k, v in gt.items()},
        jax.random.PRNGKey(0), jm.array_pytree())
    jgrads = _flatten(_first_step_grads(new_state))

    opt = make_two_group_adamw(model, 1e-3, 1e-2, 0.01)
    grads = {}
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
             for n, p in model.named_parameters()]
    terms = tmesh.make_mesh_train_step(model, opt, LAMBDAS, "L1")(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in gt.items()})
    for h in hooks:
        h.remove()
    assert set(terms) == set(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(terms[k].item(), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    got = _flatten(jax_from_state_dict(grads))
    assert got.keys() == jgrads.keys()
    for k, want in jgrads.items():
        if k in VANISHING:   # rounding only: held against its BatchNorm's
            ref = np.abs(jgrads[VANISHING[k]]).max()
            assert np.abs(got[k] - want).max() <= 2e-4 * ref, k
        else:
            assert _rel(got[k], want) <= 2e-4, k
    new = _flatten(jax_batch_stats_from_state_dict(model.state_dict()))
    for k, v in _flatten(new_state.extra_vars["batch_stats"]).items():
        np.testing.assert_allclose(new[k], v, atol=1e-5, rtol=1e-5, err_msg=k)


def test_flip_tta_eval_step_matches_jax(nets):
    jmodel, jm, params, stats, model = _fresh(nets)
    x, _ = _mesh_batch(jm, seed=6)
    want = j_eval_step(jmodel, jm, flip_tta=True)(
        params, {"batch_stats": stats}, jnp.asarray(x), jm.array_pytree())
    got = tmesh.make_mesh_eval_step(model, flip_tta=True)(torch.from_numpy(x))
    for k in ("theta", "verts", "kp_3d"):
        assert _rel(got[k].numpy(), want[k]) <= 1e-4, k
    one = tmesh.make_mesh_eval_step(model, flip_tta=False)(torch.from_numpy(x))
    assert not torch.equal(one["verts"], got["verts"])


def test_mesh_loss_needs_every_lambda(nets):
    _, jm, _, _, _ = nets
    _, gt = _mesh_batch(jm)
    gt = {k: torch.from_numpy(v) for k, v in gt.items()}
    total, terms = tmesh_loss.mesh_total_loss(gt, gt, LAMBDAS, "L2")
    jgt = {k: jnp.asarray(v.numpy()) for k, v in gt.items()}
    want = jax.jit(lambda a: jmesh_loss.mesh_total_loss(a, a, LAMBDAS,
                                                        "L2")[0])(jgt)
    np.testing.assert_allclose(total.item(), float(want), atol=1e-4)
    with pytest.raises(KeyError, match="lambda_norm"):
        tmesh_loss.mesh_total_loss(gt, gt, {k: v for k, v in LAMBDAS.items()
                                            if k != "lambda_norm"})


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _data_args(flip=True):
    return dict(clip_len=16, sample_stride=1, data_stride=8,
                data_root=os.path.join(ROOT, "data", "synthetic", "mesh"),
                dt_file_pw3d="mesh_synth.pkl", flip=flip)


def test_mesh_reader_matches_jax():
    kw = dict(n_frames=16, sample_stride=1, data_stride_train=8,
              data_stride_test=16,
              dt_root=os.path.join(ROOT, "data", "synthetic", "mesh"),
              dt_file="mesh_synth.pkl", res=(1920, 1920))
    t, j = treaders.DataReaderMesh(**kw), jreaders.DataReaderMesh(**kw)
    for a, b in zip(t.read_2d(), j.read_2d()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.get_split_id(), j.get_split_id()):
        assert [list(c) for c in a] == [list(c) for c in b]


@pytest.mark.parametrize("split", ["train", "test"])
def test_motion_smpl_matches_jax(split):
    """Items and get_batch against the JAX dataset: the same clips, the same
    per-(epoch, index) flips, the fp32 SMPL ground truth."""
    jm, tm = jsmpl.SMPLModel.from_npz(SMPL_NPZ), \
        tsmpl.SMPLModel.from_npz(SMPL_NPZ)
    jds = jdm.MotionSMPL(ConfigDict(_data_args()), split, "pw3d", jm)
    tds = tdm.MotionSMPL(ConfigDict(_data_args()), split, "pw3d", tm)
    assert len(tds) == len(jds) > 4
    for ds in (jds, tds):
        ds.set_epoch(3)
    idx = list(range(len(tds)))
    jx, jgt = jds.get_batch(idx)
    tx, tgt = tds.get_batch(idx)
    np.testing.assert_array_equal(tx, jx)
    for k in ("theta", "kp_3d", "verts"):
        np.testing.assert_allclose(tgt[k], jgt[k], atol=1e-4, err_msg=k)
    for i in (0, 3):
        item_x, item_gt = tds[i]
        np.testing.assert_array_equal(item_x, tx[i])
        for k in item_gt:
            np.testing.assert_allclose(item_gt[k], tgt[k][i], atol=1e-4)


# ---------------------------------------------------------------------------
# the epoch driver and the wild-mesh command line
# ---------------------------------------------------------------------------

def _opts(ck):
    return types.SimpleNamespace(checkpoint=ck, pretrained="", resume="",
                                 evaluate="", selection="", seed=0,
                                 print_freq=100)


def test_mesh_cli_trains_checkpoints_resumes_and_evaluates(tmp_path):
    ck = str(tmp_path / "ck")
    first = tmesh.main(["--config", SMOKE, "-c", ck, "--device", "cpu"])
    assert [h["epoch"] for h in first["history"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["pw3d_mpjpe"])
               for h in first["history"])
    assert {"latest_epoch.ckpt", "best_epoch.ckpt", "epoch_1.ckpt"} <= set(
        os.listdir(ck))
    args = get_config(SMOKE)
    args.epochs = 3
    resumed = tmesh.train_with_config(args, _opts(ck), device="cpu")
    hist = resumed["history"]
    assert [h["epoch"] for h in hist] == [2]
    np.testing.assert_allclose(hist[0]["lr"], args.lr_backbone * 0.98 ** 2)
    assert resumed["best_jpe"] <= first["best_jpe"]
    ev = tmesh.main(["--config", SMOKE, "-c", str(tmp_path / "ev"), "-e",
                     os.path.join(ck, "latest_epoch.ckpt"), "--device",
                     "cpu"])
    assert set(ev) == {"pw3d"} and 0 < ev["pw3d"]["mpjpe"] < 9999.0


def test_mesh_driver_validates_pw3d_without_training_on_it(tmp_path):
    args = get_config(SMOKE)
    args.update(train_pw3d=False, epochs=1)
    out = tmesh.train_with_config(args, _opts(str(tmp_path)), device="cpu")
    assert out["history"][0]["loss"] is None
    assert out["best_jpe"] < tmesh.NO_METRIC


def _write_wild_json(path, n_frames=40, seed=0):
    """Halpe-26 AlphaPose detections of one person from a numpy seed."""
    rs = np.random.RandomState(seed)
    t = np.arange(n_frames)[:, None, None] / n_frames
    xy = rs.uniform(-80, 80, (1, 26, 2)) + (320.0, 240.0) \
        + 20 * np.sin(2 * np.pi * (t + rs.uniform(size=(1, 26, 2))))
    conf = rs.uniform(0.5, 1.0, (n_frames, 26, 1))
    with open(path, "w") as fh:
        json.dump([{"image_id": f"{f}.jpg", "idx": 1, "score": 2.5,
                    "keypoints": np.concatenate([xy[f], conf[f]], 1)
                    .ravel().tolist()} for f in range(n_frames)], fh)
    return str(path)


def test_wild_mesh_cli_runs_the_stream_kernels(tmp_path, monkeypatch):
    """The command line with --attn_impl pallas_stream: one stream call per
    block and stream and clip batch; each clip equal to a direct flip-TTA
    eval step; the reference trajectory placed by the fitted scale;
    rendering refused."""
    calls = []
    monkeypatch.setattr(tmodel, "STREAM_IMPLS", {
        k: tuple((lambda f: lambda *a: calls.append(f.__name__) or f(*a))(f)
                 for f in fns) for k, fns in tmodel.STREAM_IMPLS.items()})
    json_path = _write_wild_json(tmp_path / "alphapose.json")
    out_dir = tmp_path / "out"
    verts = twm.main(["--config", SMOKE, "-j", json_path, "-o", str(out_dir),
                      "--clip_len", "16", "--attn_impl", "pallas_stream",
                      "--device", "cpu"])
    assert verts.shape == (40, 128, 3) and np.isfinite(verts).all()
    np.testing.assert_array_equal(np.load(out_dir / "mesh_verts.npy"), verts)
    # clips of 16, 16 and 8 frames: two batches, depth 1
    assert sorted(set(calls)) == ["fused_gated_stream_block",
                                  "fused_stream_block"] and len(calls) == 8

    from motionbert_tpu_torch.data.dataset_wild import WildDetDataset

    args = get_config(SMOKE)
    model = tmesh.build_mesh_model(
        args, tsmpl.SMPLModel.from_npz(tmesh.smpl_model_path(args)),
        device="cpu", attn_impl="pallas_stream")
    model.init_weights(torch.Generator().manual_seed(0))
    step = tmesh.make_mesh_eval_step(model, flip_tta=True)
    ds = WildDetDataset(json_path, clip_len=16, scale_range=[1, 1])
    assert [len(ds[i]) for i in range(len(ds))] == [16, 16, 8]
    outs = [step(torch.from_numpy(np.stack([ds[i] for i in batch])))
            for batch in ((0, 1), (2,))]   # the CLI's batches of one length
    direct = np.concatenate([o["verts"].numpy().reshape(-1, 128, 3)
                             for o in outs])
    kp = np.concatenate([o["kp_3d"].numpy().reshape(-1, 17, 3) for o in outs])
    np.testing.assert_array_equal(verts, direct)

    ref = np.random.RandomState(7).normal(0, 0.3, (40, 17, 3))
    np.save(tmp_path / "x3d.npy", ref)
    fitted = []
    monkeypatch.setattr(twm, "solve_scale", lambda x, y, f=twm.solve_scale:
                        fitted.append((x, y, f(x, y))) or fitted[-1][2])
    placed, reg = twm.run_wild_mesh(
        args, json_path=json_path, out_path=str(out_dir), model=model,
        clip_len=16, ref_3d_motion_path=str(tmp_path / "x3d.npy"))
    np.testing.assert_array_equal(reg, kp)
    (x, y, scale), = fitted
    np.testing.assert_array_equal(x, ref - ref[:, :1])
    np.testing.assert_array_equal(y, kp - kp[:, :1])
    np.testing.assert_allclose(placed, direct - kp[:, :1] + ref[:, :1]
                               * scale, rtol=1e-6, atol=1e-4)
    with pytest.raises(NotImplementedError, match="A.4"):
        twm.run_wild_mesh(args, json_path=json_path, out_path=str(out_dir),
                          model=model, clip_len=16, render=True)


def test_mesh_entry_points_need_the_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    args = get_config(SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.build_mesh_model(args, tsmpl.SMPLModel.from_npz(SMPL_NPZ))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twm.main(["--config", SMOKE, "-j", _write_wild_json(
            tmp_path / "a.json"), "-o", str(tmp_path / "o")])
