"""The port's data parallelism (``motionbert_tpu_torch/parallel/mesh.py``, the
four trainers' steps and drivers under a process group, ``device_prefetch``)
against the JAX package's mesh and against the port at world size 1, on the
CPU.

World size 2 runs in two spawned processes on a gloo group started on a
``file://`` store under the test's temporary directory (never a TCP port:
the suite runs on several workers), with a 60 s timeout, one intra-op
thread, and a deadline on the join that kills the processes. One spawn runs
every world-2 case and saves its numbers; the tests hold them:

- against the JAX step on ``make_mesh()`` (the 8 virtual CPU devices of the
  conftest) at global batch 8, for the pose3d step, the action step with its
  BatchNorm in training mode (running statistics too), the SupCon step and
  the mesh step, random draws off (the frameworks' generators differ, as
  ``tests/test_train_infra.py`` turns them off): the loss of each step to
  ``rtol=2e-5`` and the parameters after two steps to 5e-5, the JAX
  package's own bars (``tests/test_train_infra.py:313-318``,
  ``tests/test_action.py:126-131``);
- against the port at world size 1 with every random draw on (flip, the
  2D mask and noise, dropout, drop-path, the heads' dropout), at the same
  bars: the draws are the global batch's on every rank;
- a checkpoint saved at world size 2 resumes at world size 1 and at world
  size 2 to the same next step, and holds no ``module.`` key;
- the four drivers, one epoch each at world size 2, against the same
  epoch at world size 1: the epoch's losses and metrics to 2e-3.

The parameter bar applies to every element whose first-step gradient
stands above rounding: above 1e-5 of the model's largest gradient. Below
it are gradients that are zero in exact arithmetic (the key third of every
qkv bias, which the softmax ignores; the bias of a Linear before a
BatchNorm in training mode) and a few that round to as little; AdamW moves
each such element by about the learning rate in the direction of its
rounding noise, whichever framework or world size computes it, so those
are held to AdamW's step bound (``STEPS`` times twice the learning rate).
The drivers' epochs run several such steps, hence their wider bar. A
BatchNorm's running mean takes in its Linear's bias, so after the second
step it is held to the momentum (0.1) times that bias's bound after the
first; its running variance, which the bias does not reach, to 1e-5.

Inputs come from numpy seeds; the models are small (depth 1 or 2, width
32).
"""

import multiprocessing
import os
import time
import types
from datetime import timedelta

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMPL_NPZ = os.path.join(ROOT, "data", "synthetic", "mesh", "smpl_model.npz")
NOISE = (os.path.join(ROOT, "params", "synthetic_noise.npz"),
         os.path.join(ROOT, "params", "d2c_params.pkl"))
WORLD = 2
BATCH, STEPS = 8, 2
FRAMES, MESH_FRAMES = 9, 8
LR, LR_HEAD, WD = 1e-3, 1e-2, 0.01
POSE = dict(dim_in=3, dim_out=3, dim_feat=32, dim_rep=32, depth=1,
            num_heads=4, mlp_ratio=2, num_joints=17, maxlen=FRAMES)
BACKBONE = dict(dim_feat=32, dim_rep=32, depth=1, num_heads=4, mlp_ratio=2,
                num_joints=17, maxlen=16)
LAMBDAS = dict(lambda_scale=0.5, lambda_3d_velocity=20.0, lambda_lv=0.3,
               lambda_lg=0.2, lambda_a=0.4, lambda_av=0.6)
MESH_LAMBDAS = dict(lambda_3d=0.5, lambda_scale=0.5, lambda_3dv=10,
                    lambda_lv=0.1, lambda_lg=0.1, lambda_a=0.1,
                    lambda_av=0.1, lambda_pose=1000, lambda_shape=1,
                    lambda_norm=20)
# the draws-on cases: drop-path (depth 2: layer 1's rate), dropout, the
# flip, the 2D mask and noise, and the heads' dropout
DRAWS = dict(drop_path_rate=0.4, drop_rate=0.1)
HEAD_DROPOUT = 0.5
LOSS_RTOL, PARAM_TOL = 2e-5, 5e-5
JOIN_SECONDS = 300


# ---------------------------------------------------------------------------
# the cases, run at any world size (torch and the port only: the spawned
# processes import this module)
# ---------------------------------------------------------------------------

def pose_model(draws: bool):
    from motionbert_tpu_torch.core.config import ConfigDict
    from motionbert_tpu_torch.models.factory import load_backbone

    cfg = ConfigDict(POSE, depth=2) if draws else ConfigDict(POSE)
    model = load_backbone(cfg, device="cpu", **(DRAWS if draws else {}))
    return model.init_weights(torch.Generator().manual_seed(0))


def action_model(version: str, dropout: float = 0.0):
    from motionbert_tpu_torch.core.config import ConfigDict
    from motionbert_tpu_torch.train.action import build_action_model

    cfg = ConfigDict(BACKBONE, hidden_dim=64, action_classes=6,
                     dropout_ratio=dropout, model_version=version)
    model = build_action_model(cfg, device="cpu")
    return model.init_weights(torch.Generator().manual_seed(0))


def mesh_model(dropout: float = 0.0):
    from motionbert_tpu_torch.core.config import ConfigDict
    from motionbert_tpu_torch.models.smpl import SMPLModel
    from motionbert_tpu_torch.train.mesh import build_mesh_model

    cfg = ConfigDict(BACKBONE, hidden_dim=64, dropout=dropout)
    model = build_mesh_model(cfg, SMPLModel.from_npz(SMPL_NPZ), device="cpu")
    return model.init_weights(torch.Generator().manual_seed(0))


def pose_batches():
    rs = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        gt = rs.uniform(-1, 1, (BATCH, FRAMES, 17, 3)).astype(np.float32)
        conf = rs.uniform(0.5, 1, (BATCH, FRAMES, 17, 1)).astype(np.float32)
        out.append((np.concatenate([gt[..., :2], conf], -1), gt))
    return out


def action_batches():
    rs = np.random.RandomState(2)
    return [(rs.normal(size=(BATCH, 2, 16, 17, 3)).astype(np.float32),
             np.repeat(np.arange(BATCH // 2), 2)) for _ in range(STEPS)]


def mesh_batches():
    from motionbert_tpu_torch.models.smpl import SMPLModel, smpl_forward_np

    smpl = SMPLModel.from_npz(SMPL_NPZ)
    rs = np.random.RandomState(4)
    out = []
    for _ in range(STEPS):
        n, t = BATCH, MESH_FRAMES
        x = rs.uniform(-1, 1, (n, t, 17, 3)).astype(np.float32)
        pose = rs.normal(0, 0.3, (n, t, 72)).astype(np.float32)
        shape = rs.normal(0, 1, (n, t, 10)).astype(np.float32)
        verts = smpl_forward_np(smpl, shape.reshape(-1, 10),
                                pose.reshape(-1, 72))["vertices"]
        verts = verts.reshape(n, t, -1, 3) * 1000.0
        kp = np.einsum("jv,btvc->btjc", smpl.numpy("J_regressor_h36m"), verts)
        out.append((x, {"theta": np.concatenate([pose, shape], -1),
                        "kp_3d": (kp - kp[:, :, :1]).astype(np.float32),
                        "verts": (verts - kp[:, :, :1]).astype(np.float32)}))
    return out


def _state(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def make_step(kind: str, model, generator):
    """(optimizer, the train step through the DDP wrap) of one case."""
    from motionbert_tpu_torch.data.augment import NoiseParams
    from motionbert_tpu_torch.parallel.mesh import wrap_ddp
    from motionbert_tpu_torch.train import action, action_1shot, mesh, pose3d
    from motionbert_tpu_torch.train.state import (
        make_adamw, make_two_group_adamw)

    cpu = torch.device("cpu")
    if kind.startswith("pose"):
        draws = kind == "pose_draws"
        opt = make_adamw(model.parameters(), LR, WD)
        step = pose3d.make_train_step(
            wrap_ddp(model, cpu), opt, LAMBDAS, rootrel=True, no_conf=False,
            use_mask=draws, use_noise=draws,
            noise_params=NoiseParams.load(*NOISE) if draws else None,
            mask_ratio=0.2, mask_T_ratio=0.2, flip_aug=draws,
            generator=generator)
        return opt, lambda x, y: step(x, y)["total"]
    opt = make_two_group_adamw(model, LR, LR_HEAD, WD)
    ddp = wrap_ddp(model, cpu, ignore=action.JAX_MISSING_KEYS)
    if kind.startswith("action"):
        step = action.make_action_train_step(ddp, opt, generator)
        return opt, lambda x, y: step(x, y.long())["loss"]
    if kind == "supcon":
        step = action_1shot.make_supcon_train_step(ddp, opt, 64, 0.1,
                                                   generator)
        return opt, lambda x, y: step(x, y.long())
    step = mesh.make_mesh_train_step(ddp, opt, MESH_LAMBDAS, "L1", generator)
    return opt, lambda x, y: step(x, y)["total"]


CASES = {
    "pose": (lambda: pose_model(False), pose_batches),
    "pose_draws": (lambda: pose_model(True), pose_batches),
    "action": (lambda: action_model("class"), action_batches),
    "action_draws": (lambda: action_model("class", HEAD_DROPOUT),
                     action_batches),
    "supcon": (lambda: action_model("embed"), action_batches),
    "mesh": (lambda: mesh_model(), mesh_batches),
    "mesh_draws": (lambda: mesh_model(HEAD_DROPOUT), mesh_batches),
}


def run_case(kind: str, batches=None, model=None, opt_state=None,
             generator=None) -> dict:
    """STEPS steps of a case on the rank's rows of each global batch:
    {"loss": the global batch's loss per step, "state": the state_dict
    after}. Resumes from a model, optimizer state and generator when
    given."""
    from motionbert_tpu_torch.parallel.mesh import mean_over_ranks, rank_rows

    build, data = CASES[kind]
    model = model if model is not None else build()
    gen = generator or torch.Generator().manual_seed(5)
    opt, step = make_step(kind, model, gen)
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    losses = []
    for x, y in (batches if batches is not None else data()):
        x, y = rank_rows((torch.from_numpy(x), _tensors(y)))
        losses.append(float(mean_over_ranks({"l": step(x, y)})["l"]))
    return {"loss": losses, "state": _state(model), "opt": opt,
            "gen": gen, "model": model}


def _tensors(y):
    if isinstance(y, dict):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in y.items()}
    return torch.from_numpy(np.asarray(y))


def resume_case(path: str) -> dict:
    """The draws-on pose3d case's second step from a checkpoint that the
    first step saved."""
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint

    payload = load_checkpoint(path)
    model = pose_model(True)
    model.load_state_dict(payload["model"], strict=True)
    gen = torch.Generator()
    gen.set_state(payload["rng"])
    return run_case("pose_draws", pose_batches()[1:], model,
                    payload["optimizer"], gen)


def smoke_args(task: str):
    """A driver's synthetic smoke config at depth 1, width 32, one epoch."""
    from motionbert_tpu_torch.core.config import get_config

    args = get_config(os.path.join(ROOT, "configs", task,
                                   "MB_train_synth_smoke.yaml"))
    args.update(depth=1, dim_feat=32, dim_rep=32, num_heads=4, epochs=1)
    for key in ("data_root", "dt_root", "data_path", "smpl_model_path"):
        if key in args:
            args[key] = os.path.join(ROOT, args[key])
    if task == "pose3d":
        args.update(batch_size=8)
    return args


def run_driver(task: str, ckpt: str, oneshot_pkl: str = None) -> dict:
    from motionbert_tpu_torch.train import action, action_1shot, mesh, pose3d

    opts = types.SimpleNamespace(checkpoint=ckpt, pretrained="", resume="",
                                 evaluate="", selection="", seed=0,
                                 print_freq=100)
    if task == "oneshot":
        args = smoke_args("action")
        args.update(data_path=oneshot_pkl, data_path_1shot=oneshot_pkl,
                    n_views=2, temp=0.1)
        return action_1shot.train_with_config(args, opts, device="cpu")
    module = {"pose3d": pose3d, "action": action, "mesh": mesh}[task]
    return module.train_with_config(smoke_args(task), opts, device="cpu")


def _world_cases(out_dir: str, pkls: dict) -> dict:
    """Every world-size-2 case; rank 0's numbers are saved."""
    from motionbert_tpu_torch.core.checkpoint import CheckpointManager
    from motionbert_tpu_torch.parallel.mesh import barrier, is_main

    out = {k: {"loss": r["loss"], "state": r["state"]} for k, r in
           ((k, run_case(k)) for k in CASES)}
    # one step of the draws-on pose3d case, checkpointed, then resumed here
    first = run_case("pose_draws", pose_batches()[:1])
    ckpt = os.path.join(out_dir, "ckpt")
    if is_main():
        CheckpointManager(ckpt).save_epoch(0, LR, first["model"],
                                           first["opt"],
                                           rng=first["gen"].get_state())
    barrier()
    resumed = resume_case(os.path.join(ckpt, "latest_epoch.ckpt"))
    out["resumed"] = {"loss": resumed["loss"], "state": resumed["state"]}
    out["drivers"] = {task: run_driver(task, os.path.join(out_dir, task),
                                       pkls.get(task))
                      for task in ("pose3d", "action", "oneshot", "mesh")}
    return out


def _worker(rank: int, store: str, out_dir: str, pkls: dict) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        out = _world_cases(out_dir, pkls)
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "world2.pt"))
    finally:
        dist.destroy_process_group()


def spawn_world(out_dir: str, pkls: dict) -> dict:
    """Run ``_world_cases`` on WORLD spawned ranks; kill them at the
    deadline. Returns rank 0's numbers."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_worker, args=(r, store, out_dir, pkls))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_SECONDS
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    assert not alive, f"ranks still running after {JOIN_SECONDS} s: killed"
    assert [p.exitcode for p in procs] == [0] * WORLD, \
        [p.exitcode for p in procs]
    return torch.load(os.path.join(out_dir, "world2.pt"), weights_only=False)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models are tiny: one intra-op thread runs them faster than a
    pool that contends for the cores with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def oneshot_pkl(tmp_path_factory):
    from tools.make_synthetic_data import make_action_pickle

    path = str(tmp_path_factory.mktemp("oneshot") / "oneshot.pkl")
    make_action_pickle(path, split_names=("oneshot_train", "oneshot_val"))
    return path


@pytest.fixture(scope="module")
def world2(tmp_path_factory, oneshot_pkl):
    out_dir = str(tmp_path_factory.mktemp("world2"))
    return out_dir, spawn_world(out_dir, {"oneshot": oneshot_pkl})


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_params(state: dict) -> dict:
    from motionbert_tpu_torch.models.convert import jax_from_state_dict
    from motionbert_tpu_torch.train.action import JAX_MISSING_KEYS

    return jax_from_state_dict({k: v for k, v in state.items()
                                if k not in JAX_MISSING_KEYS})


def _jax_run(kind: str) -> dict:
    """The case through the JAX package's step on ``make_mesh()``, from the
    port's initial weights, global batch 8: {"loss", "params",
    "batch_stats"}."""
    import jax
    import jax.numpy as jnp

    from motionbert_tpu.models.action_heads import ActionNet as JActionNet
    from motionbert_tpu.models.dstformer import DSTformer as JDSTformer
    from motionbert_tpu.models import smpl as jsmpl
    from motionbert_tpu.models.mesh_head import MeshRegressor as JMesh
    from motionbert_tpu.parallel import make_mesh, shard_batch, shard_params
    from motionbert_tpu.train import pose3d as jpose3d
    from motionbert_tpu.train.action import (
        make_action_train_step, make_two_group_adamw)
    from motionbert_tpu.train.action_1shot import make_supcon_train_step
    from motionbert_tpu.train.mesh import make_mesh_train_step
    from motionbert_tpu.train.state import TrainState, make_adamw
    from motionbert_tpu_torch.models.convert import (
        jax_batch_stats_from_state_dict)

    assert len(jax.devices()) == 8
    build, data = CASES[kind]
    init = _state(build())
    params = _jax_params(init)
    stats = jax_batch_stats_from_state_dict(init) or None
    extra = {}
    if kind == "pose":
        jmodel = JDSTformer(**POSE)
        step = jpose3d.make_train_step(jmodel, LAMBDAS, rootrel=True,
                                       no_conf=False, use_mask=False,
                                       use_noise=False, noise_params=None)
        tx = make_adamw(LR, WD)
    else:
        tx = make_two_group_adamw(LR, LR_HEAD, WD)
        backbone = JDSTformer(dim_in=3, dim_out=3, **BACKBONE)
        if kind == "mesh":
            jm = jsmpl.SMPLModel.from_npz(SMPL_NPZ)
            jmodel = JMesh(backbone=backbone, smpl_model=jm, dim_rep=32,
                           hidden_dim=64, dropout_ratio=0.0)
            step = make_mesh_train_step(jmodel, MESH_LAMBDAS, "L1")
            extra = {"smpl": jm.array_pytree()}
        else:
            jmodel = JActionNet(backbone=backbone, dim_rep=32, num_classes=6,
                                dropout_ratio=0.0,
                                version="class" if kind == "action"
                                else "embed", hidden_dim=64)
            step = make_action_train_step(jmodel) if kind == "action" \
                else make_supcon_train_step(jmodel, hidden_dim=64,
                                            temperature=0.1)
    mesh = make_mesh()
    state = TrainState.create(jmodel.apply, params, tx,
                              extra_vars=({"batch_stats": stats}
                                          if stats else None))
    state = state.replace(params=shard_params(state.params, mesh))
    losses = []
    for i, (x, y) in enumerate(data()):
        xs, ys = shard_batch(
            (jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, y)), mesh)
        args = (state, xs, ys, jax.random.PRNGKey(i)) + tuple(extra.values())
        state, metrics = step(*args)
        loss = metrics if kind == "supcon" else metrics[
            "loss" if kind == "action" else "total"]
        losses.append(float(loss))
    return {"loss": losses,
            "params": _flat(jax.tree_util.tree_map(np.asarray, state.params)),
            "batch_stats": _flat(jax.tree_util.tree_map(
                np.asarray, (state.extra_vars or {}).get("batch_stats", {})))}


def first_grads(kind: str) -> dict:
    """The first step's gradients of a case in one process, by parameter
    name."""
    build, data = CASES[kind]
    model = build()
    _, step = make_step(kind, model, torch.Generator().manual_seed(5))
    grads = {}
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
             for n, p in model.named_parameters()]
    x, y = data()[0]
    step(torch.from_numpy(x), _tensors(y))
    for h in hooks:
        h.remove()
    return {k: v.numpy() for k, v in grads.items()}


def _hold_params(got: dict, want: dict, grads: dict, lrs, tag: str) -> None:
    """Each parameter to PARAM_TOL where its first-step gradient stands
    above rounding (1e-5 of the largest), elsewhere to AdamW's step bound
    (module note). got, want and grads share keys; lrs(key) is the key's
    learning rate."""
    assert got.keys() == want.keys() <= grads.keys(), tag
    floor = 1e-5 * max(np.abs(g).max() for g in grads.values())
    over = {}
    for k, w in want.items():
        d = np.abs(got[k] - w)
        real = np.abs(grads[k]) > floor
        if not (d[real] < PARAM_TOL).all() or not (
                d <= 2 * STEPS * lrs(k) + 1e-6).all():
            over[k] = float(d[real].max(initial=0.0)), float(d.max())
    assert not over, (tag, over)


def _hold_stat(name: str, got, want) -> None:
    """A BatchNorm buffer after STEPS steps (module note)."""
    if name.endswith("mean"):
        bound = 0.1 * 2 * (STEPS - 1) * LR_HEAD + 1e-6
        assert np.abs(got - want).max() <= bound, name
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _lrs(kind: str):
    if kind.startswith("pose"):
        return lambda k: LR
    return lambda k: LR if k.split(".")[0] == "backbone" or k.startswith(
        "backbone/") else LR_HEAD


# ---------------------------------------------------------------------------
# parallel/mesh.py alone
# ---------------------------------------------------------------------------

class _Loader:
    def __init__(self, sizes):
        rs = np.random.RandomState(0)
        self.batches = [(rs.normal(size=(n, 4, 17, 3)).astype(np.float32),
                         np.arange(n)) for n in sizes]

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("sizes", [(4, 4, 3), (5,), (3, 3, 1)])
def test_padded_eval_batches_match_jax(sizes):
    from motionbert_tpu.parallel.mesh import padded_eval_batches as jpadded
    from motionbert_tpu_torch.parallel.mesh import padded_eval_batches

    loader = _Loader(sizes)
    got, want = list(padded_eval_batches(loader)), list(jpadded(loader))
    assert len(got) == len(want) == len(sizes)
    for (a, b, n), (c, d, m) in zip(got, want):
        assert n == m
        np.testing.assert_array_equal(a, np.asarray(c))
        np.testing.assert_array_equal(b, d)
    # padded to a multiple of the world size, the clips unchanged
    padded = list(padded_eval_batches(loader, multiple=2))
    first = -(-sizes[0] // 2) * 2
    for (a, _, n), (x, _) in zip(padded, loader.batches):
        assert a.shape[0] == first and n == len(x)
        np.testing.assert_array_equal(a[:n], x)
        np.testing.assert_array_equal(a[n:], np.repeat(x[-1:], first - n, 0))


def test_padded_eval_batches_refuse_an_empty_loader_and_a_long_batch():
    from motionbert_tpu_torch.parallel.mesh import padded_eval_batches

    with pytest.raises(ValueError, match="no batch"):
        list(padded_eval_batches(_Loader(())))
    with pytest.raises(ValueError, match="after a first batch"):
        list(padded_eval_batches(_Loader((2, 3))))


def test_one_process_is_the_identity():
    from motionbert_tpu_torch.parallel import mesh

    x = torch.arange(12.0).reshape(6, 2)
    assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_main()
    assert mesh.rank_rows(x) is x and mesh.gather_rows(x) is x
    model = torch.nn.Linear(2, 2)
    assert mesh.wrap_ddp(model, torch.device("cpu")) is model
    gen = torch.Generator().manual_seed(3)
    want = torch.rand((6, 2), generator=torch.Generator().manual_seed(3))
    draw = lambda shape, g: torch.rand(shape, generator=g)
    assert torch.equal(mesh.rank_draw(draw, (6, 2), gen), want)
    assert mesh.init_distributed("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="NCCL"):
        os.environ["WORLD_SIZE"] = "2"
        try:
            mesh.init_distributed("cpu", backend="nccl")
        finally:
            del os.environ["WORLD_SIZE"]


def test_device_prefetch_yields_the_batches_in_order():
    from motionbert_tpu_torch.data.datasets import device_prefetch

    rs = np.random.RandomState(1)
    batches = [(rs.normal(size=(3, 2)).astype(np.float32),
                {"a": rs.normal(size=(3,)), "b": np.arange(3)})
               for _ in range(5)]
    got = list(device_prefetch(iter(batches), "cpu", size=2))
    assert len(got) == len(batches)
    for (x, y), (gx, gy) in zip(batches, got):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        np.testing.assert_array_equal(gx.numpy(), x)
        assert gy.keys() == y.keys()
        for k in y:
            np.testing.assert_array_equal(gy[k].numpy(), y[k])


# ---------------------------------------------------------------------------
# world size 2 against the JAX mesh, draws off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["pose", "action", "supcon", "mesh"])
def test_world2_step_matches_the_jax_mesh(world2, kind):
    port = world2[1][kind]
    want = _jax_run(kind)
    np.testing.assert_allclose(port["loss"], want["loss"], rtol=LOSS_RTOL,
                               err_msg=kind)
    grads = _flat(_jax_params(first_grads(kind)))
    _hold_params(_flat(_jax_params(port["state"])), want["params"], grads,
                 _lrs(kind), kind)
    if want["batch_stats"]:   # the BatchNorm statistics of the global batch
        from motionbert_tpu_torch.models.convert import (
            jax_batch_stats_from_state_dict)

        got = _flat(jax_batch_stats_from_state_dict(port["state"]))
        assert got.keys() == want["batch_stats"].keys()
        for k, v in want["batch_stats"].items():
            _hold_stat(k, got[k], v)


# ---------------------------------------------------------------------------
# world size 2 against world size 1, every draw on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["pose_draws", "action_draws", "mesh_draws"])
def test_world2_draws_what_world1_draws(world2, kind):
    port, one = world2[1][kind], run_case(kind)
    np.testing.assert_allclose(port["loss"], one["loss"], rtol=LOSS_RTOL,
                               err_msg=kind)
    grads = first_grads(kind)
    _hold_params({k: port["state"][k] for k in grads},
                 {k: one["state"][k] for k in grads}, grads, _lrs(kind), kind)
    for k in set(one["state"]) - set(grads):   # BatchNorm statistics
        _hold_stat(k, port["state"][k], one["state"][k])
    # the masks are live: another seed draws another first loss
    other = run_case(kind, generator=torch.Generator().manual_seed(6))
    assert other["loss"][0] != one["loss"][0]


def test_world2_checkpoint_resumes_at_world1_and_world2(world2):
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint

    out_dir, res = world2
    path = os.path.join(out_dir, "ckpt", "latest_epoch.ckpt")
    assert not [k for k in load_checkpoint(path)["model"]
                if k.startswith("module.")]
    one = resume_case(path)
    two = res["resumed"]
    whole = res["pose_draws"]     # the two steps without the checkpoint
    grads = first_grads("pose_draws")
    for tag, ref in (("world 2", two), ("uninterrupted", {
            "loss": whole["loss"][1:], "state": whole["state"]})):
        np.testing.assert_allclose(one["loss"], ref["loss"], rtol=LOSS_RTOL,
                                   err_msg=tag)
        _hold_params(one["state"], ref["state"], grads, _lrs("pose"), tag)


@pytest.mark.parametrize("task", ["pose3d", "action", "oneshot", "mesh"])
def test_world2_driver_trains_the_world1_epoch(world2, task, tmp_path,
                                               oneshot_pkl):
    """One epoch of each driver at world size 2 (rank rows, the DDP wrap,
    evaluation gathered, rank 0's checkpoints) against the same epoch in one
    process."""
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint

    out_dir, res = world2
    two = res["drivers"][task]
    one = run_driver(task, str(tmp_path / task), oneshot_pkl)
    assert len(one["history"]) == len(two["history"]) == 1
    for key, value in one["history"][0].items():
        if key in ("train_s", "step_ms"):    # pose3d's timings, not results
            continue
        if isinstance(value, dict):    # pose3d's loss terms
            for k, v in value.items():
                np.testing.assert_allclose(two["history"][0][key][k], v,
                                           rtol=2e-3, atol=1e-6, err_msg=k)
        elif value is not None:
            np.testing.assert_allclose(two["history"][0][key], value,
                                       rtol=2e-3, atol=1e-6, err_msg=key)
    saved = os.listdir(os.path.join(out_dir, task))
    assert "latest_epoch.ckpt" in saved
    payload = load_checkpoint(os.path.join(out_dir, task,
                                           "latest_epoch.ckpt"))
    ref = load_checkpoint(str(tmp_path / task / "latest_epoch.ckpt"))
    assert payload["epoch"] == ref["epoch"] == 1
    assert payload["model"].keys() == ref["model"].keys()
    assert not [k for k in payload["model"] if k.startswith("module.")]
    assert torch.equal(payload["rng"], ref["rng"])
