"""The port's action task (datasets, sampler, SupCon, top-k accuracy,
ActionNet, the train steps and both drivers) and its clip-store reader,
against the JAX package on the CPU.

Inputs come from numpy seeds, the reference goldens and the synthetic sets
(``data/synthetic/action/ntu_synth.pkl``, and a one-shot pickle from
``tools/make_synthetic_data.make_action_pickle``). Tolerances: dataset items
and samplers are equal (numpy on both sides, the same draws); SupCon 1e-5
relative, as the JAX package's own golden test; a depth-1 ActionNet in fp32
1e-4 for logits, loss and updated weights and 2e-4 for gradients (two
stacked sub-blocks and the head, summation order only).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionbert_tpu.core.checkpoint import save_checkpoint
from motionbert_tpu.data import dataset_action as jda
from motionbert_tpu.data.clipstore import (
    ClipStoreDataset3D as JClipStoreDataset3D, write_clipstore)
from motionbert_tpu.losses.supcon import supcon_loss as j_supcon
from motionbert_tpu.models.action_heads import ActionNet as JActionNet
from motionbert_tpu.models.dstformer import DSTformer as JDSTformer
from motionbert_tpu.train.action import (
    make_action_train_step as j_action_step, make_two_group_adamw as j_adamw)
from motionbert_tpu.train.action_1shot import (
    make_supcon_train_step as j_supcon_step)
from motionbert_tpu.train.state import TrainState
from motionbert_tpu_torch.core.checkpoint import load_state_dict
from motionbert_tpu_torch.core.config import ConfigDict, get_config
from motionbert_tpu_torch.core.metrics import accuracy_topk
from motionbert_tpu_torch.data import dataset_action as tda
from motionbert_tpu_torch.data.clipstore import ClipStore, ClipStoreDataset3D
from motionbert_tpu_torch.data.datasets import BatchLoader
from motionbert_tpu_torch.losses.supcon import supcon_loss
from motionbert_tpu_torch.models.convert import (
    jax_from_state_dict, state_dict_from_jax)
from motionbert_tpu_torch.train import action, action_1shot
from motionbert_tpu_torch.train.state import freeze_except, make_two_group_adamw
from tools.make_synthetic_data import make_action_pickle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
SMOKE = os.path.join(ROOT, "configs", "action", "MB_train_synth_smoke.yaml")


@pytest.fixture(scope="module")
def action_pkl(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("action"), "ntu_synth.pkl")
    make_action_pickle(path)
    return path


@pytest.fixture(scope="module")
def oneshot_pkl(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("oneshot"), "oneshot.pkl")
    make_action_pickle(path, split_names=("oneshot_train", "oneshot_val"))
    return path


def _items(ds):
    return (np.stack([ds[i][0] for i in range(len(ds))]),
            np.array([ds[i][1] for i in range(len(ds))]))


# ---------------------------------------------------------------------------
# data, sampler, loss, metric
# ---------------------------------------------------------------------------

def test_nturgbd_items_equal_the_golden_and_the_jax_dataset(action_pkl):
    g = np.load(os.path.join(GOLDENS, "action_dataset.npz"))
    kw = dict(data_path=action_pkl, data_split="xsub_val", n_frames=24,
              random_move=False, scale_range=[2, 2])
    motions, labels = _items(tda.NTURGBD(**kw))
    np.testing.assert_array_equal(labels, g["labels"])
    np.testing.assert_allclose(motions, g["motions"], atol=1e-6)
    jm, jl = _items(jda.NTURGBD(**kw))
    np.testing.assert_array_equal(motions, jm)
    np.testing.assert_array_equal(labels, jl)


@pytest.mark.parametrize("epoch", [0, 3])
def test_training_items_draw_like_the_jax_dataset(action_pkl, epoch):
    """The random resample at construction (global RNG after seed 0) and
    random_move + crop_scale per item (the item's RNG) give the same
    arrays."""
    kw = dict(data_path=action_pkl, data_split="xsub_train", n_frames=30,
              random_move=True, scale_range=[1, 3])
    port, ref = tda.NTURGBD(**kw), jda.NTURGBD(**kw)
    np.testing.assert_array_equal(port.motions, ref.motions)
    port.set_epoch(epoch)
    ref.set_epoch(epoch)
    for a, b in zip(_items(port), _items(ref)):
        np.testing.assert_array_equal(a, b)


def test_oneshot_dataset_filters_and_relabels_like_jax(oneshot_pkl):
    kw = dict(data_path=oneshot_pkl, data_split="", n_frames=24,
              random_move=False, scale_range=[1, 1], check_split=False)
    port, ref = tda.NTURGBD1Shot(**kw), jda.NTURGBD1Shot(**kw)
    assert tda.ONESHOT_CLASSES == jda.ONESHOT_CLASSES
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(port.motions, ref.motions)
    # synthetic labels 0..5: class 0 is held out, 1..5 become 0..4
    assert sorted(set(port.labels)) == [0, 1, 2, 3, 4]


def test_action_names_read_like_jax(tmp_path):
    path = str(tmp_path / "ntu_actions.txt")
    with open(path, "w") as f:
        f.write("A1. drink water\nA2. eat meal/snack\nA60. walking apart\n")
    names = tda.get_action_names(path)
    assert names == jda.get_action_names(path)
    assert names == ["drink water", "eat meal/snack", "walking apart"]


def test_mperclass_sampler_draws_the_jax_batches():
    labels = np.repeat(np.arange(10), 8)
    port = tda.MPerClassSampler(labels, m=2, batch_size=8, length=75, seed=3)
    ref = jda.MPerClassSampler(labels, m=2, batch_size=8, length=75, seed=3)
    for _ in range(2):                       # two epochs: the state carries
        a, b = list(iter(port)), list(iter(ref))
        assert a == b and len(a) == len(port) == 72
    for start in range(0, 72, 8):
        _, counts = np.unique(labels[a[start:start + 8]], return_counts=True)
        assert (counts == 2).all()
    assert len(BatchLoader(None, 8, sampler=port, drop_last=True)) == 9


def test_supcon_matches_the_goldens_and_the_no_positive_guard():
    g = np.load(os.path.join(GOLDENS, "supcon.npz"))
    loss = supcon_loss(torch.from_numpy(g["feats"]),
                       torch.from_numpy(g["labels"]), temperature=0.1,
                       base_temperature=0.07)
    np.testing.assert_allclose(loss.item(), float(g["loss"]), rtol=1e-5)
    feats = torch.from_numpy(g["feats_mpc"])
    loss = supcon_loss(feats.reshape(feats.shape[0], -1, feats.shape[-1]),
                       torch.from_numpy(g["labels_mpc"]), temperature=0.1,
                       base_temperature=0.07)
    np.testing.assert_allclose(loss.item(), float(g["loss_mpc"]), rtol=1e-5)
    # an anchor with no positive contributes 0 (one view, a unique label)
    rs = np.random.RandomState(0)
    f = rs.normal(size=(4, 1, 8)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    lab = np.array([0, 0, 1, 2])
    got = supcon_loss(torch.from_numpy(f), torch.from_numpy(lab))
    want = j_supcon(jnp.asarray(f), jnp.asarray(lab))
    assert torch.isfinite(got)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # SimCLR without labels, two views
    f2 = rs.normal(size=(3, 2, 8)).astype(np.float32)
    f2 /= np.linalg.norm(f2, axis=-1, keepdims=True)
    np.testing.assert_allclose(supcon_loss(torch.from_numpy(f2)).item(),
                               float(j_supcon(jnp.asarray(f2))), rtol=1e-5)


def test_accuracy_topk_breaks_ties_like_jax():
    from motionbert_tpu.core.metrics import accuracy_topk as j_accuracy

    logits = np.zeros((8, 60), np.float32)           # every class tied
    labels = np.arange(1, 9)
    assert accuracy_topk(logits, labels, topk=(1, 5)) == [0.0, 50.0]
    rs = np.random.RandomState(0)
    logits = rs.randint(0, 4, size=(50, 10)).astype(np.float32)  # many ties
    labels = rs.randint(0, 10, 50)
    assert accuracy_topk(logits, labels, (1, 3, 5)) == j_accuracy(
        logits, labels, (1, 3, 5))


# ---------------------------------------------------------------------------
# ActionNet and the train steps against the JAX package
# ---------------------------------------------------------------------------

BACKBONE = dict(dim_feat=32, dim_rep=32, depth=1, num_heads=4, mlp_ratio=2,
                num_joints=17, maxlen=16)


def _nets(version):
    """A depth-1 JAX ActionNet, its variables, and the port's model carrying
    them (dropout off on both sides)."""
    jmodel = JActionNet(backbone=JDSTformer(dim_in=3, dim_out=3, **BACKBONE),
                        dim_rep=32, num_classes=6, dropout_ratio=0.0,
                        version=version, hidden_dim=64)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 2, 16, 17, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rs = np.random.RandomState(1)                  # move the gate and stats
    params = jax.tree_util.tree_map(
        lambda a: (a + rs.normal(size=a.shape) * 0.05).astype(np.float32),
        variables["params"])
    stats = variables.get("batch_stats")
    if stats is not None:
        stats = {"head": {"bn": {
            "mean": rs.normal(size=64).astype(np.float32) * 0.1,
            "var": rs.uniform(0.5, 1.5, 64).astype(np.float32)}}}
    cfg = ConfigDict(BACKBONE, hidden_dim=64, action_classes=6,
                     dropout_ratio=0.0, model_version=version)
    model = action.build_action_model(cfg, device="cpu")
    action.load_action_state(model, state_dict_from_jax(params, stats))
    return jmodel, params, stats, model


def _batch(n=8):
    rs = np.random.RandomState(2)
    return (rs.normal(size=(n, 2, 16, 17, 3)).astype(np.float32),
            np.repeat(np.arange(n // 2), 2))


def test_jax_actionnet_state_loads_and_lacks_only_the_backbone_head():
    _, params, stats, model = _nets("class")
    sd = state_dict_from_jax(params, stats)
    assert set(model.state_dict()) - set(sd) == set(action.JAX_MISSING_KEYS)
    assert set(sd) <= set(model.state_dict())
    np.testing.assert_array_equal(model.head.bn.running_var.numpy(),
                                  stats["head"]["bn"]["var"])
    with pytest.raises(RuntimeError, match="does not fit"):
        action.load_action_state(model, {**sd, "head.extra": torch.zeros(1)})


@pytest.mark.parametrize("version", ["class", "embed"])
def test_actionnet_matches_jax_in_evaluation(version):
    jmodel, params, stats, model = _nets(version)
    x, _ = _batch()
    variables = {"params": params}
    if stats is not None:
        variables["batch_stats"] = stats
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    if version == "embed":
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-5)


def _first_step_grads(new_state):
    """The gradients of a JAX two-group AdamW state after its first step:
    Adam's first moment is then (1 - 0.9) * g."""
    inner = new_state.opt_state.inner_states
    return {g: jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1,
        inner[g].inner_state.inner_state[0].mu[g])
        for g in ("backbone", "head")}


def _check_updated(model, new_params, jgrads, lrs):
    """The weights after the first AdamW step. Its update is lr * g / (|g| +
    1e-8) + lr * wd * p, which turns summation-order noise in a gradient
    within ~1e-6 of zero into an O(lr) difference; there the update is only
    held to lr in size, elsewhere to 1e-4."""
    new = _flatten(jax_from_state_dict(model.state_dict()))
    grads = _flatten(jgrads)
    for k, v in _flatten(jax.tree_util.tree_map(np.asarray,
                                                new_params)).items():
        if k.startswith("backbone/head/"):
            continue
        sure = np.abs(grads[k]) >= 1e-5
        np.testing.assert_allclose(new[k][sure], v[sure], atol=1e-4,
                                   rtol=1e-4, err_msg=k)
        lr = lrs[k.split("/")[0]]
        assert np.all(np.abs(new[k] - v) <= 2.1 * lr + 1e-6), k


def test_classification_step_matches_jax():
    """One step: loss, accuracies, every gradient, the BatchNorm statistics
    (biased batch variance) and the weights after the two-group AdamW
    update."""
    jmodel, params, stats, model = _nets("class")
    x, y = _batch()
    lrs = {"backbone": 1e-3, "head": 1e-2}
    state = TrainState.create(jmodel.apply, params,
                              j_adamw(lrs["backbone"], lrs["head"], 0.01),
                              extra_vars={"batch_stats": stats})
    new_state, metrics = j_action_step(jmodel)(
        state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    jgrads = _first_step_grads(new_state)

    opt = make_two_group_adamw(model, lrs["backbone"], lrs["head"], 0.01)
    assert [g["lr"] for g in opt.param_groups] == [1e-3, 1e-2]
    assert sum(p.numel() for p in opt.param_groups[1]["params"]) == sum(
        p.numel() for p in model.head.parameters())
    grads = {}
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
             for n, p in model.named_parameters()]
    m = action.make_action_train_step(model, opt)(torch.from_numpy(x),
                                                  torch.from_numpy(y))
    for h in hooks:
        h.remove()
    for key in ("loss", "top1", "top5"):
        np.testing.assert_allclose(m[key].item(), float(metrics[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)
    got = _flatten(jax_from_state_dict(grads))
    want = {k: v for k, v in _flatten(jgrads).items()
            if not k.startswith("backbone/head/")}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=2e-4,
                                   err_msg=k)
    new_stats = new_state.extra_vars["batch_stats"]["head"]["bn"]
    for buf, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(model.head.bn, buf).numpy(),
                                   np.asarray(new_stats[key]), atol=1e-5,
                                   rtol=1e-5, err_msg=buf)
    assert model.head.bn.num_batches_tracked.item() == 1
    _check_updated(model, new_state.params, jgrads, lrs)


def test_supcon_step_matches_jax():
    jmodel, params, _, model = _nets("embed")
    x, y = _batch()
    lrs = {"backbone": 1e-3, "head": 1e-2}
    state = TrainState.create(jmodel.apply, params,
                              j_adamw(lrs["backbone"], lrs["head"], 0.01))
    new_state, jloss = j_supcon_step(jmodel, hidden_dim=64, temperature=0.1)(
        state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    opt = make_two_group_adamw(model, lrs["backbone"], lrs["head"], 0.01)
    loss = action_1shot.make_supcon_train_step(model, opt, 64, 0.1)(
        torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    _check_updated(model, new_state.params, _first_step_grads(new_state), lrs)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_freeze_within_the_backbone_keeps_the_head():
    _, _, _, model = _nets("class")
    train = freeze_except(model, ["blocks_ts"], scope="backbone")
    names = {n for n, p in model.named_parameters() if p.requires_grad}
    assert all(n.startswith(("head.", "backbone.blocks_ts")) for n in names)
    assert any(n.startswith("head.") for n in names)
    assert len(train) == len(names)
    opt = make_two_group_adamw(model, 1e-3, 1e-2, 0.0)
    assert sum(len(g["params"]) for g in opt.param_groups) == len(names)


def test_batchnorm_running_variance_is_the_biased_one():
    from motionbert_tpu_torch.models.action_heads import BatchNorm1d

    bn = BatchNorm1d(3).train()
    x = torch.from_numpy(np.random.RandomState(0).normal(size=(32, 3)).astype(
        np.float32))
    bn(x)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * x.var(0, unbiased=False).numpy(),
                               rtol=1e-5)


def test_jax_action_checkpoint_keeps_its_batch_stats(tmp_path):
    _, params, stats, model = _nets("class")
    path = os.path.join(tmp_path, "jax_action.ckpt")
    save_checkpoint(path, epoch=3, lr=1e-4, params=params,
                    extra_vars={"batch_stats": stats}, best_metric=50.0)
    sd = load_state_dict(path)
    np.testing.assert_array_equal(sd["head.bn.running_mean"].numpy(),
                                  stats["head"]["bn"]["mean"])
    np.testing.assert_array_equal(sd["head.bn.running_var"].numpy(),
                                  stats["head"]["bn"]["var"])
    action.load_action_state(model, sd)


# ---------------------------------------------------------------------------
# the drivers and their command lines
# ---------------------------------------------------------------------------

def test_action_cli_trains_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    first = action.main(["--config", SMOKE, "-c", ck, "--device", "cpu"])
    assert [h["epoch"] for h in first["history"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in first["history"])
    assert {"latest_epoch.ckpt", "best_epoch.ckpt", "epoch_0.ckpt",
            "epoch_1.ckpt"} <= set(os.listdir(ck))
    args = get_config(SMOKE)
    args.epochs = 3
    opts = types.SimpleNamespace(checkpoint=ck, pretrained="", resume="",
                                 evaluate="", selection="", seed=0,
                                 print_freq=100)
    resumed = action.train_with_config(args, opts, device="cpu")
    hist = resumed["history"]
    assert [h["epoch"] for h in hist] == [2]
    np.testing.assert_allclose(hist[0]["lr"], args.lr_backbone * 0.99 ** 2)
    np.testing.assert_allclose(hist[0]["lr_head"], args.lr_head * 0.99 ** 2)
    assert resumed["top1"] >= first["top1"]
    ev = action.main(["--config", SMOKE, "-c", str(tmp_path / "ev"), "-e",
                      os.path.join(ck, "latest_epoch.ckpt"), "--device",
                      "cpu"])
    assert 0.0 <= ev["top1"] <= 100.0 and ev["history"] == []


def test_oneshot_driver_trains_and_resumes(tmp_path, oneshot_pkl):
    args = get_config(SMOKE)
    args.update(data_path=oneshot_pkl, data_path_1shot=oneshot_pkl,
                n_views=2, temp=0.1, epochs=1, dropout_ratio=0.1)
    opts = lambda: types.SimpleNamespace(
        checkpoint=str(tmp_path), pretrained="", resume="", evaluate="",
        selection="", seed=0, print_freq=100)
    first = action_1shot.train_with_config(args, opts(), device="cpu")
    args.epochs = 2
    second = action_1shot.train_with_config(args, opts(), device="cpu")
    hist = first["history"] + second["history"]
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and 0.0 <= h["acc"] <= 1.0
               for h in hist)
    assert "latest_epoch.ckpt" in os.listdir(tmp_path)


def test_oneshot_cli_evaluates(tmp_path, oneshot_pkl):
    import yaml

    cfg = dict(get_config(SMOKE), data_path=oneshot_pkl,
               data_path_1shot=oneshot_pkl, n_views=2, epochs=1)
    path = str(tmp_path / "oneshot.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = action_1shot.main(["--config", path, "-c", str(tmp_path / "ck"),
                             "--device", "cpu"])
    assert len(out["history"]) == 1
    ev = action_1shot.main(["--config", path, "-c", str(tmp_path / "ev"),
                            "-e", str(tmp_path / "ck" / "latest_epoch.ckpt"),
                            "--device", "cpu"])
    assert 0.0 <= ev["acc"] <= 1.0


def test_validate_1shot_with_identical_anchors_is_perfect():
    class Embed(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

        def forward(self, x):
            return x[:, 0, 0, 0, :2] + self.w

    feats = np.random.RandomState(0).normal(size=(10, 2, 4, 17, 3)).astype(
        np.float32)
    loader = [(feats, np.arange(10))]
    assert action_1shot.validate_1shot(loader, loader, Embed()) == 1.0


# ---------------------------------------------------------------------------
# the clip-store reader
# ---------------------------------------------------------------------------

def test_clipstore_reads_what_the_jax_writer_packed(tmp_path):
    rs = np.random.RandomState(0)
    labels = rs.normal(size=(12, 16, 17, 3)).astype(np.float32)
    inputs = rs.normal(size=labels.shape).astype(np.float32)
    both, only = str(tmp_path / "both.mbcs"), str(tmp_path / "labels.mbcs")
    write_clipstore(both, labels, inputs)
    write_clipstore(only, labels)
    store = ClipStore(both)
    assert (len(store), store.shape, store.has_input) == (12, (16, 17, 3),
                                                          True)
    gi, gl = store.gather([3, 0, 11])
    np.testing.assert_array_equal(gi, inputs[[3, 0, 11]])
    np.testing.assert_array_equal(gl, labels[[3, 0, 11]])
    with pytest.raises(IndexError):
        store.gather([12])
    store.close()
    with pytest.raises(ValueError, match="closed"):
        store.gather([0])
    assert ClipStore(only).gather([1])[0] is None
    for kw in (dict(data_split="test"),
               dict(synthetic=True, scale_range_pretrain=[1, 1.5]),
               dict(gt_2d=True, data_split="test")):
        path = only if kw.get("synthetic") else both
        port, ref = ClipStoreDataset3D(path, **kw), JClipStoreDataset3D(
            path, **kw)
        port.set_epoch(2)
        ref.set_epoch(2)
        for a, b in zip(port.get_batch([5, 1]), ref.get_batch([5, 1])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(port[4], ref[4]):
            np.testing.assert_array_equal(a, b)
    loader = BatchLoader(ClipStoreDataset3D(both, data_split="test"), 5)
    batches = list(loader)
    assert [len(b[0]) for b in batches] == [5, 5, 2]
    np.testing.assert_array_equal(np.concatenate([b[1] for b in batches]),
                                  labels)
    with open(str(tmp_path / "bad.mbcs"), "wb") as f:
        f.write(b"not a clip store" * 8)
    with pytest.raises(OSError):
        ClipStore(str(tmp_path / "bad.mbcs"))


def test_pose3d_driver_takes_a_packed_store(tmp_path):
    from motionbert_tpu_torch.train.pose3d import build_dataset_3d

    sub = tmp_path / "H36M"
    sub.mkdir()
    labels = np.random.RandomState(1).normal(size=(4, 8, 17, 3)).astype(
        np.float32)
    write_clipstore(str(sub / "train.mbcs"), labels)
    args = ConfigDict(data_root=str(tmp_path), subset_list=["H36M"],
                      synthetic=True)
    ds = build_dataset_3d(args, "train")
    assert isinstance(ds, ClipStoreDataset3D) and len(ds) == 4
    np.testing.assert_array_equal(ds[2][1], labels[2])


def test_port_write_clipstore_is_the_jax_writers_file(tmp_path):
    """The port's writer gives the JAX writer's bytes, with and without an
    input stream, and its own reader gathers them back."""
    from motionbert_tpu_torch.data.clipstore import (
        write_clipstore as port_write_clipstore)

    rs = np.random.RandomState(3)
    labels = rs.normal(size=(5, 8, 17, 3)).astype(np.float64)
    inputs = rs.normal(size=labels.shape).astype(np.float32)
    for name, extra in (("both", (inputs,)), ("labels", ())):
        port, ref = str(tmp_path / f"p_{name}.mbcs"), str(
            tmp_path / "j" / f"{name}.mbcs")
        port_write_clipstore(port, labels, *extra)
        write_clipstore(ref, labels, *extra)
        assert open(port, "rb").read() == open(ref, "rb").read()
    store = ClipStore(str(tmp_path / "p_both.mbcs"))
    gi, gl = store.gather([4, 2])
    np.testing.assert_array_equal(gi, inputs[[4, 2]])
    np.testing.assert_array_equal(gl, labels[[4, 2]].astype(np.float32))
    store.close()
    with pytest.raises(ValueError, match="differ in shape"):
        port_write_clipstore(str(tmp_path / "bad.mbcs"), labels, inputs[:2])
