"""The port's mesh finetune step against the plain reference
(``benchmark/reference/mesh.py``: float32 PyTorch written from the
published recipe, importing nothing of the port), the targets the step
skins on the device against the loader's numpy ones, the step's spans, and
the meters the epoch loop keeps on the device.

Sizes are small (dim 64, depth 2, a 128-vertex body model that the
reference draws (``draw_body``) and the port gets through its
``SMPLModel`` constructor, 4 clips of 8 frames). Both sides run float32 on the CPU from the same seeded
weights, body model, batches, flips and dropout masks, so they differ by
the order of their sums alone: the reference skins with 4 x 4 homogeneous
transforms where the port keeps 3 x 4, regresses joints by other
contractions and sums its loss terms in another order. Tolerances:
outputs and loss terms 1e-5 of their largest value; first gradients 1e-4
of each parameter's largest (the error of the forward, carried back
through BatchNorm's division by the batch's spread and the 24-joint
chain); the two biases before a training-mode BatchNorm, whose exact
gradient is 0, are rounding on both sides: sums over rows whose own
gradients exceed the BatchNorm bias's by the inverse of the batch's spread
(the shape branch normalises over 4 rows), so they are held to 1e-3 of
their BatchNorm bias's gradient (read: 1.1e-4). The parameters' change
over three AdamW steps is compared as the benchmark compares it
(``compare.train_readings``), where elements whose exact gradient is 0
move by Adam's sign-like first steps of rounding and are left out.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from benchmark.compare import train_readings
from benchmark.reference import mesh as ref
from motionbert_tpu_torch.core import profiling as tprof
from motionbert_tpu_torch.core.config import ConfigDict
from motionbert_tpu_torch.core.metrics import AverageMeter, DeviceMeters
from motionbert_tpu_torch.data import dataset_mesh as tdm
from motionbert_tpu_torch.geometry.rotations import flip_thetas_np
from motionbert_tpu_torch.geometry.skeleton import flip_data_np
from motionbert_tpu_torch.losses.mesh import LAMBDA_KEYS
from motionbert_tpu_torch.models.smpl import SMPLModel
from motionbert_tpu_torch.train import mesh as tmesh
from motionbert_tpu_torch.train.state import make_two_group_adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMPL_NPZ = os.path.join(ROOT, "data", "synthetic", "mesh", "smpl_model.npz")
N, T, STEPS, SEED = 4, 8, 3, 7
SMALL = dict(dim_feat=64, dim_rep=64, depth=2, num_heads=2, hidden_dim=64,
             maxlen=16)
# summation order alone (see the module's docstring)
OUT_TOL, GRAD_TOL, UPDATE_TOL, ROUNDING_TOL = 1e-5, 1e-4, 1e-4, 1e-3
VANISHING = {"head.fc1.bias": "head.bn1.bias",
             "head.fc2.bias": "head.bn2.bias"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _config(**over):
    with open(os.path.join(ROOT, "configs", "mesh", "MB_ft_h36m.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(SMALL, **over)
    return cfg


def _batches(seed=0):
    """STEPS unflipped batches (2D input (N, T, 17, 3), theta (N, T, 82))
    and a flip draw per step."""
    rs = np.random.default_rng(seed)
    out, flips = [], []
    for _ in range(STEPS):
        x = rs.normal(0, 0.3, (N, T, 17, 3)).astype(np.float32)
        pose = rs.normal(0, 0.3, (N, 1, 72)) + np.cumsum(
            rs.normal(0, 0.05, (N, T, 72)), axis=1)
        betas = np.repeat(rs.normal(0, 1, (N, 1, 10)), T, axis=1)
        out.append((x, np.concatenate([pose, betas], -1).astype(np.float32)))
        flips.append(np.array([True, False, True, False]))
    return out, flips


def _body(num_verts=128, seed=3):
    """The reference's seeded body model, and the port's ``SMPLModel`` of
    the same tables, handed over in the official files' layout."""
    body = ref.draw_body(num_verts, 10, seed, "cpu")
    return body, SMPLModel(**{k: v.numpy() for k, v in body.items()})


def _flipped(x, theta, fl):
    x, theta = x.copy(), theta.copy()
    x[fl] = flip_data_np(x[fl])
    theta[fl, :, :72] = flip_thetas_np(
        theta[fl, :, :72].reshape(-1, T, 24, 3)).reshape(-1, T, 72)
    return x, theta


@pytest.fixture(scope="module")
def both():
    """The port's first forward, loss terms, gradients and parameter change
    over three steps on the card's path (theta in, targets skinned by the
    step), and the reference's over the same inputs."""
    cfg = _config()
    body, smpl = _body()
    model = tmesh.build_mesh_model(ConfigDict(cfg), smpl, device="cpu",
                                   attn_impl="plain")
    model.load_state_dict(ref.draw_weights(cfg, 10, SEED, "cpu"))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_two_group_adamw(model, cfg["lr_backbone"], cfg["lr_head"],
                               cfg["weight_decay"])
    step = tmesh.make_mesh_train_step(
        model, opt, {k: cfg[k] for k in LAMBDA_KEYS}, cfg["loss_type"],
        torch.Generator().manual_seed(5))
    batches, flips = _batches()
    seen, grads, losses, terms1 = {}, {}, [], None

    def keep(module, args, out):
        seen.setdefault("out", {k: v.detach().clone()
                                for k, v in out.items()})

    hooks = [model.register_forward_hook(keep)] + [
        p.register_hook(lambda g, n=n: grads.setdefault(n, g.clone()))
        for n, p in model.named_parameters()]
    for (x, theta), fl in zip(batches, flips):
        x, theta = _flipped(x, theta, fl)
        terms = step(torch.from_numpy(x), {"theta": torch.from_numpy(theta)})
        losses.append(float(terms["total"]))
        terms1 = terms1 or {k: float(v) for k, v in terms.items()}
        for h in hooks:
            h.remove()
        hooks = []
    port = {"out": seen["out"], "terms": terms1, "loss": losses,
            "grads": grads,
            "delta": {n: p.detach() - start[n]
                      for n, p in model.named_parameters()}}
    rm = ref.build(cfg, 10, "cpu")
    rm.load_state_dict(ref.draw_weights(cfg, 10, SEED, "cpu"))
    r = ref.train_steps(
        rm, body, [(torch.from_numpy(x), torch.from_numpy(t))
                   for x, t in batches],
        [torch.from_numpy(f) for f in flips],
        torch.Generator().manual_seed(5), cfg)
    return port, r


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("key", ["verts", "kp_3d", "theta"])
def test_first_forward_matches_the_reference(both, key):
    port, r = both
    assert port["out"][key].shape == r["out"][key].shape
    assert _rel(port["out"][key], r["out"][key]) <= OUT_TOL


@pytest.mark.parametrize("term", list(ref.LAMBDAS))
def test_every_loss_term_matches_the_reference(both, term):
    port, r = both
    assert port["terms"][term] == pytest.approx(r["terms"][term],
                                                rel=OUT_TOL, abs=1e-7)


def test_each_step_loss_matches_the_reference(both):
    port, r = both
    assert port["loss"] == pytest.approx(r["loss"], rel=OUT_TOL)


def test_first_gradients_match_the_reference(both):
    port, r = both
    want = dict(zip(r["names"], r["grad1"]))
    assert set(want) == set(port["grads"]) - {
        n for n in port["grads"] if n.startswith("backbone.head.")}
    for n, g in want.items():
        got = port["grads"][n]
        if n in VANISHING:
            scale = want[VANISHING[n]].abs().max()
            assert float((got - g).abs().max()) <= ROUNDING_TOL * scale, n
        else:
            assert _rel(got, g) <= GRAD_TOL, n


def test_the_update_matches_the_reference(both):
    port, r = both
    program = {"loss": port["loss"],
               "grad_norm": {n: float(g.norm())
                             for n, g in port["grads"].items()},
               "delta": port["delta"]}
    got = train_readings(program, r)
    assert got["update_norm_gap"] <= UPDATE_TOL
    assert got["grad_norm_gap"] <= GRAD_TOL
    assert set(got["_left_out"]) <= set(VANISHING)


# -- the targets skinned on the device ----------------------------------------

def _data_args(flip):
    return ConfigDict(clip_len=16, sample_stride=1, data_stride=8,
                      data_root=os.path.join(ROOT, "data", "synthetic",
                                             "mesh"),
                      dt_file_pw3d="mesh_synth.pkl", flip=flip)


@pytest.mark.parametrize("flip", [False, True])
def test_device_targets_equal_the_loaders_numpy_ones(flip):
    """The train step's ``mesh_targets`` from the theta a ``skin_on_host=
    False`` loader hands over equal what ``get_batch`` skins on the host,
    flipped clips included (their draws come from the same per-(epoch,
    index) generators)."""
    smpl = SMPLModel.from_npz(SMPL_NPZ)
    host = tdm.MotionSMPL(_data_args(flip), "train", "pw3d", smpl)
    lean = tdm.MotionSMPL(_data_args(flip), "train", "pw3d", smpl,
                          skin_on_host=False)
    for ds in (host, lean):
        ds.set_epoch(2)
    idx = list(range(len(host)))
    x, gt = host.get_batch(idx)
    lx, lgt = lean.get_batch(idx)
    assert set(lgt) == {"theta"}
    np.testing.assert_array_equal(lx, x)
    np.testing.assert_array_equal(lgt["theta"], gt["theta"])
    got = tmesh.mesh_targets(smpl, torch.from_numpy(lgt["theta"]))
    assert got["verts"].dtype == torch.float32
    for k in ("kp_3d", "verts"):
        assert got[k].shape == gt[k].shape, k
        # mm, a few hundred at most: float32 sums in another order
        np.testing.assert_allclose(got[k].numpy(), gt[k], atol=2e-3,
                                   err_msg=k)
    np.testing.assert_array_equal(got["kp_3d"][:, :, 0].numpy(), 0.0)


def test_device_targets_equal_the_references():
    body, smpl = _body()
    _, theta = _batches(seed=4)[0][0]
    theta = torch.from_numpy(theta)
    got = tmesh.mesh_targets(smpl, theta)
    want = ref.targets(body, theta)
    for k in ("kp_3d", "verts", "theta"):
        assert _rel(got[k], want[k]) <= OUT_TOL, k


def test_a_step_takes_targets_or_skins_them():
    """Given theta alone the step skins the targets itself: the same terms
    as a step handed the loader's host-skinned ones."""
    cfg = _config(depth=1)
    smpl = SMPLModel.synthetic(num_verts=128, seed=3)
    x, theta = _batches(seed=5)[0][0]
    out = []
    for given in ("theta", "all"):
        model = tmesh.build_mesh_model(ConfigDict(cfg), smpl, device="cpu",
                                       attn_impl="plain")
        model.load_state_dict(ref.draw_weights(cfg, 10, SEED, "cpu"))
        opt = make_two_group_adamw(model, 1e-3, 1e-2, 0.01)
        step = tmesh.make_mesh_train_step(
            model, opt, {k: cfg[k] for k in LAMBDA_KEYS}, "L1",
            torch.Generator().manual_seed(1))
        th = torch.from_numpy(theta)
        gt = ({"theta": th} if given == "theta"
              else tmesh.mesh_targets(smpl, th))
        out.append(step(torch.from_numpy(x), gt))
    assert out[0].keys() == out[1].keys()
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


# -- spans --------------------------------------------------------------------

def _tiny_step():
    cfg = _config(depth=1, dim_feat=32, dim_rep=32, hidden_dim=32)
    smpl = SMPLModel.synthetic(num_verts=64, seed=1)
    model = tmesh.build_mesh_model(ConfigDict(cfg), smpl, device="cpu",
                                   attn_impl="plain")
    model.load_state_dict(ref.draw_weights(cfg, 10, SEED, "cpu"))
    step = tmesh.make_mesh_train_step(
        model, make_two_group_adamw(model, 1e-3, 1e-2, 0.01),
        {k: cfg[k] for k in LAMBDA_KEYS}, "L1",
        torch.Generator().manual_seed(1))
    x, theta = _batches(seed=6)[0][0]
    return step, torch.from_numpy(x), torch.from_numpy(theta)


def test_mesh_step_spans_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    step, x, theta = _tiny_step()
    tprof.reset()
    step(x, {"theta": theta})
    assert tprof.recorded() == {"spans": [], "device": [], "samples": []}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            step(x, {"theta": theta})
    rec = tprof.recorded()
    tprof.reset()
    by = {}
    for s in rec["spans"]:
        by.setdefault(s["name"], []).append(s)
    steps = by["train.step"]
    assert len(steps) == 2
    ids = {s["id"]: s for s in rec["spans"]}
    for name, parent in (("train.forward", "train.step"),
                         ("train.backward", "train.step"),
                         ("train.optimizer", "train.step"),
                         ("mesh.targets", "train.step"),
                         ("mesh.smpl", "train.forward")):
        assert len(by[name]) == 2, name
        for s in by[name]:
            assert ids[s["parent"]]["name"] == parent, name
    # the targets come before the forward, the SMPL layer inside it
    for t, f in zip(by["mesh.targets"], by["train.forward"]):
        assert t["end_ns"] <= f["start_ns"]
    assert sorted({d["name"] for d in rec["device"]}) == sorted(
        ["train.step", "train.forward", "train.backward", "train.optimizer",
         "mesh.targets", "mesh.smpl"])
    assert all(d["ms"] >= 0 for d in rec["device"])


# -- the meters on the device -------------------------------------------------

def test_device_meters_read_what_float_meters_build():
    """``DeviceMeters`` keeps the sums on the device and copies them once a
    read; its meters equal those a ``float()`` of every term at every step
    builds, bit for bit."""
    rs = np.random.default_rng(0)
    dev, host = DeviceMeters(), {}
    assert dev.read() == {}
    for i in range(7):
        terms = {k: torch.tensor(rs.normal(0, 100), dtype=torch.float32)
                 for k in ("loss_3d_pos", "total", "mpjpe")}
        n = int(rs.integers(1, 200))
        dev.update(terms, n)
        for k, v in terms.items():
            host.setdefault(k, AverageMeter()).update(float(v), n)
        got = dev.read()
        assert list(got) == list(host)
        for k, m in host.items():
            assert (got[k].val, got[k].sum, got[k].count, got[k].avg) == \
                (m.val, m.sum, m.count, m.avg), (i, k)


def test_index_tables_reach_a_device_once(monkeypatch):
    """The SMPL parent index and the pose losses' limb and angle tables are
    made on a device once: a copy from host memory would wait for the
    card's whole queue at every step. A first call under inference mode (an
    eval step) leaves tables that a later training step can backward
    through."""
    from motionbert_tpu_torch.losses import pose
    from motionbert_tpu_torch.models import smpl as tsmpl

    dev = torch.device("cpu")
    monkeypatch.setattr(tsmpl, "_PARENT_INDEX", {})
    monkeypatch.setattr(pose, "_ON_DEVICE", {})
    parents = tsmpl.SMPL_PARENTS
    with torch.inference_mode():
        up = tsmpl._parent_index(parents, dev)
        limbs = pose._on(pose._LIMBS, dev)
    assert not up.is_inference() and not limbs.is_inference()
    assert up is tsmpl._parent_index(parents.copy(), dev)
    assert up.tolist() == parents[1:].tolist()
    for table in (pose._LIMBS, pose._ANGLES):
        assert pose._on(table, dev) is pose._on(table, dev)
        assert torch.equal(pose._on(table, dev), table)
    smpl = SMPLModel.synthetic(num_verts=64, seed=2)
    betas = torch.zeros(2, 10, requires_grad=True)
    out = tsmpl.smpl_forward(smpl, betas, torch.full((2, 72), 0.1))
    out["vertices"].sum().backward()
    assert betas.grad is not None and torch.isfinite(betas.grad).all()


def test_the_drawn_body_model_has_smpls_layout():
    """``draw_body``'s tables: the official files' shapes, skinning weights
    on four joints a vertex summing to 1, joint regressors summing to 1,
    the same tables from the same seed and others from another."""
    body = ref.draw_body(128, 10, 3, "cpu")
    shapes = {k: tuple(v.shape) for k, v in body.items()}
    assert shapes == {
        "v_template": (128, 3), "shapedirs": (128, 3, 10),
        "posedirs": (128, 3, 207), "J_regressor": (24, 128),
        "lbs_weights": (128, 24), "J_regressor_h36m": (17, 128),
        "mean_pose": (144,), "mean_shape": (10,)}
    w = body["lbs_weights"]
    assert ((w > 0).sum(1) == 4).all() and (w >= 0).all()
    for k in ("lbs_weights", "J_regressor", "J_regressor_h36m"):
        torch.testing.assert_close(body[k].sum(1), torch.ones(
            body[k].shape[0]), msg=k)
    again, other = ref.draw_body(128, 10, 3, "cpu"), ref.draw_body(
        128, 10, 4, "cpu")
    for k in ref.BODY_KEYS:
        assert torch.equal(again[k], body[k]), k
        assert not torch.equal(other[k], body[k]), k
