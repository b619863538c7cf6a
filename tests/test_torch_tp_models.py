"""Tensor parallelism beyond the pose3d pair path: the action (classifier),
one-shot (embedding) and mesh models' heads, the W8A8 and stream tiers, and
dropout / drop-path on shards (``parallel/mesh.py``'s plan, ``parallel/
tensor.py``'s operators and W8A8 pair on shards, the heads, the trainers'
steps and checkpoints), against the JAX package's DP x TP mesh and against
the port at world size 1, on the CPU.

The grids run as in ``tests/test_torch_tp.py``: spawned processes on a gloo
group over a ``file://`` store under the test's temporary directory, a 60 s
timeout, one intra-op thread, a deadline on the join. One spawn of two ranks
runs the 1 x 2 grid (then, in the same world, the 2 x 1 grid that resumes
its checkpoints) and one of four ranks the 2 x 2 grid (then the 1 x 4 grid
of the W8A8 pair). The backbone is the JAX test's small model (width 32, 4
heads, depth 2, mlp_ratio 2); the heads run at hidden_dim 64, the
classifier with 6 classes. Every weight and BatchNorm statistic is drawn
from a numpy seed in the JAX package's layout and carried through
``state_dict_from_jax``. fp32 on the CPU, where the kernels' wrappers take
their plain twins. Held:

- one step of the action, SupCon and mesh steps (``make_action_train_step``,
  ``make_supcon_train_step``, ``make_mesh_train_step``, two-group AdamW) on
  the 1 x 2 and 2 x 2 grids against the JAX package's step on its 4 x 2
  mesh (``make_mesh(n_data=4, n_model=2)``, ``shard_params``) and against
  the port at world size 1: the loss to rtol 1e-5, the parameters to 5e-5
  where the first step's gradient stands above rounding (1e-5 of the
  largest; below it AdamW's step bound, as ``tests/test_torch_tp.py`` holds
  them), the BatchNorm running statistics to rtol 1e-5; the eval step's
  logits, embeddings and SMPL outputs against world size 1 (2e-5 of the
  largest value) and against the JAX package's (5e-5);
- after a step the replicated parameters (the backbone, the heads' replicated
  layers) agree bit for bit across the model ranks of a data rank: the
  heads' "copy" operator gives every model rank the whole input gradient;
- the grids cut what the rules shard: fc1's rows, the classifier's fc2
  columns, the mesh head's fc2 on its input features, the BatchNorm after
  fc1 with it; ``param_partition_spec`` names the JAX rule's dimension for
  every state_dict name of the three models;
- dropout and drop-path on shards, and the heads' dropout at the configs'
  rates (0.5 for the classifier, 0.1 for the embedding and the mesh head),
  and drop-path alone (the MLP halves on B6_tp / B7_tp without their
  residual): a 1 x 2 step against world size 1's from the same generator
  seed, at the same bars;
- the W8A8 pair on shards: the plain twin (row and column maxima all-reduced
  with MAX, int32 partials summed) equal to the plain unsharded W8A8 pair
  bit for bit at T 2 and 4, gated and not, both modes; the W8A8 tiers' lift
  on both grids equal to world size 1's bit for bit and within
  ``tests/test_torch_q8.py``'s bar (5e-4 of the largest value) of the JAX
  package's ``pallas_q8`` lift on its 4 x 2 mesh; the stream tiers on the
  grids against world size 1 (the lift 2e-5, the step's bars), with no
  stream call made and the W8A8 pairs on shards called;
- a checkpoint of each model saved on the 1 x 2 grid after its step,
  resumed at 1 x 1 and 2 x 1, against the 1 x 2 grid's own next step
  (``tests/test_train_infra.py:230-330``: loss rtol 2e-5, parameters 1e-5
  above the gradient floor), BatchNorm buffers whole in the payload.
"""

import multiprocessing
import os
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

from test_torch_parallel import (
    MESH_LAMBDAS, SMPL_NPZ, _flat, _jax_params, action_batches, mesh_batches)
from test_torch_tp import CFG, LAMBDAS, batches as pose_batches, jax_params

BACKBONE = dict(dim_feat=32, dim_rep=32, depth=2, num_heads=4, mlp_ratio=2,
                num_joints=17, maxlen=16)
HIDDEN, CLASSES, BATCH = 64, 6, 8
LR, LR_HEAD, WD = 1e-3, 1e-2, 0.01
LOSS_RTOL, PARAM_TOL, EVAL_TOL, JAX_EVAL_TOL = 1e-5, 5e-5, 2e-5, 5e-5
RESUME_LOSS_RTOL, RESUME_PARAM_TOL = 2e-5, 1e-5
TASKS = ("action", "supcon", "mesh")
# the heads' dropout at the configs' rates, with the backbone's draws on
HEAD_RATES = {"action": 0.5, "supcon": 0.1, "mesh": 0.1}
DRAWS = dict(drop_path_rate=0.1, drop_rate=0.1)
# drop-path alone: the MLP halves stay on B6_tp / B7_tp without residual
PATH_ONLY = dict(drop_path_rate=0.1)
POSE_KINDS = {"pose": DRAWS, "droppath": PATH_ONLY}
TIERS = ("kernel_q8", "plain_q8", "kernel_stream", "kernel_stream_q8")
# the checkpoint case's learning rates: tests/test_train_infra.py's (its
# resume bar is set at 1e-4), the head's ten times the backbone's
RESUME_LRS = (1e-4, 1e-3)
# the W8A8 lift against the JAX package: its pair path needs C and the
# hidden width multiples of 128 (below that pallas_q8 runs XLA's fp32 pair),
# so tests/test_torch_q8.py's model (depth 1, width 128, 8 heads) at its
# model bars: 1e-2 of max|ref| and 3e-3 relative L2
CFG_Q8 = dict(dim_in=3, dim_out=3, dim_feat=128, dim_rep=128, depth=1,
              num_heads=8, mlp_ratio=2, maxlen=27, num_joints=17)
Q8_JAX_TOL, Q8_JAX_L2 = 1e-2, 3e-3
GRID_TIERS = {2: TIERS, 4: ("kernel_q8", "kernel_stream")}
JOIN_SECONDS = 300


# ---------------------------------------------------------------------------
# the port's side, at any grid (the spawned processes import this module)
# ---------------------------------------------------------------------------

def task_batches(kind: str) -> list:
    kind = kind.replace("_draws", "")
    if kind in POSE_KINDS:
        return pose_batches()
    return mesh_batches() if kind == "mesh" else action_batches()


def task_model(kind: str, sd: dict, draws: bool = False):
    """An ActionNet (action: the classifier, supcon: the embedding) or a
    MeshRegressor on the small backbone, fp32 on the CPU, loaded from sd;
    with draws, the backbone's dropout and drop-path and the head's dropout
    at the config's rate."""
    from motionbert_tpu_torch.core.config import ConfigDict
    from motionbert_tpu_torch.models.action_heads import ActionNet
    from motionbert_tpu_torch.models.factory import load_backbone
    from motionbert_tpu_torch.models.mesh_head import MeshRegressor
    from motionbert_tpu_torch.models.smpl import SMPLModel
    from motionbert_tpu_torch.train.action import load_action_state

    kind = kind.replace("_draws", "")
    torch.manual_seed(0)    # the backbone's unused output head
    backbone = load_backbone(ConfigDict(BACKBONE), device="cpu",
                             **(DRAWS if draws else {}))
    rate = HEAD_RATES[kind] if draws else 0.0
    if kind == "mesh":
        model = MeshRegressor(backbone, SMPLModel.from_npz(SMPL_NPZ),
                              dim_rep=32, hidden_dim=HIDDEN,
                              dropout_ratio=rate)
    else:
        model = ActionNet(backbone, dim_rep=32, num_classes=CLASSES,
                          dropout_ratio=rate, hidden_dim=HIDDEN,
                          version="class" if kind == "action" else "embed")
    load_action_state(model, sd)
    return model


def pose_model(sd: dict, attn_impl: str, rates=None, cfg=CFG):
    from motionbert_tpu_torch.models.dstformer import DSTformer

    model = DSTformer(**cfg, attn_impl=attn_impl, **(rates or {}))
    model.load_state_dict(sd, strict=True)
    return model


def q8_input() -> np.ndarray:
    return np.random.RandomState(3).normal(
        size=(4, 8, 17, 3)).astype(np.float32)


def q8_model_lift(model) -> np.ndarray:
    """The lift (no flip) of q8_input through the width-128 model."""
    from motionbert_tpu_torch.parallel.mesh import eval_rows
    from motionbert_tpu_torch.train.pose3d import make_eval_step

    return eval_rows(make_eval_step(model, no_conf=False, flip_tta=False),
                     q8_input(), torch.device("cpu"), 4)


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def task_step(kind: str, model, generator, lrs=(LR, LR_HEAD)):
    """(optimizer, step(x, y) -> the global batch's loss) of a task, through
    the DDP wrap; lrs the backbone's and the head's learning rates."""
    from motionbert_tpu_torch.parallel.mesh import wrap_ddp
    from motionbert_tpu_torch.train import action, action_1shot, mesh, pose3d
    from motionbert_tpu_torch.train.state import (
        make_adamw, make_two_group_adamw)

    cpu = torch.device("cpu")
    kind = kind.replace("_draws", "")
    if kind in POSE_KINDS:
        opt = make_adamw(model.parameters(), lrs[0], WD)
        step = pose3d.make_train_step(wrap_ddp(model, cpu), opt, LAMBDAS,
                                      rootrel=True, no_conf=False,
                                      generator=generator)
        return opt, lambda x, y: step(x, y)["total"]
    opt = make_two_group_adamw(model, *lrs, WD)
    ddp = wrap_ddp(model, cpu, ignore=action.JAX_MISSING_KEYS)
    if kind == "action":
        step = action.make_action_train_step(ddp, opt, generator)
        return opt, lambda x, y: step(x, y.long())["loss"]
    if kind == "supcon":
        step = action_1shot.make_supcon_train_step(ddp, opt, HIDDEN, 0.1,
                                                   generator)
        return opt, lambda x, y: step(x, y.long())
    step = mesh.make_mesh_train_step(ddp, opt, MESH_LAMBDAS, "L1", generator)
    return opt, lambda x, y: step(x, y)["total"]


def _tensors(y):
    if isinstance(y, dict):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in y.items()}
    return torch.from_numpy(np.asarray(y))


def task_eval(kind: str, model, x: np.ndarray):
    """The eval step's outputs on the global batch x (the data ranks' rows,
    gathered): logits, embeddings, or the mesh outputs."""
    from motionbert_tpu_torch.parallel.mesh import eval_rows
    from motionbert_tpu_torch.train.action import make_action_eval_step
    from motionbert_tpu_torch.train.mesh import make_mesh_eval_step

    if kind == "action":
        step = make_action_eval_step(model)
    elif kind == "supcon":
        def step(batch):
            model.eval()
            with torch.inference_mode():
                return model(batch).float()
    else:
        step = make_mesh_eval_step(model, flip_tta=False)
    return eval_rows(step, x, torch.device("cpu"), x.shape[0])


def run_steps(kind: str, model, batches: list, opt_state=None,
              seed: int = 5, lrs=(LR, LR_HEAD)) -> dict:
    """AdamW steps of a task on the rank's rows of each global batch:
    {"loss" per step, "state" (whole) after, "opt"}."""
    from motionbert_tpu_torch.parallel.mesh import mean_over_ranks, rank_rows

    opt, step = task_step(kind, model, torch.Generator().manual_seed(seed),
                          lrs)
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    losses = []
    for x, y in batches:
        x, y = rank_rows((torch.from_numpy(x), _tensors(y)))
        losses.append(float(mean_over_ranks({"l": step(x, y)})["l"]))
    return {"loss": losses, "state": _state(model), "opt": opt}


def pose_lift(model) -> np.ndarray:
    from motionbert_tpu_torch.parallel.mesh import eval_rows
    from motionbert_tpu_torch.train.pose3d import make_eval_step

    return eval_rows(make_eval_step(model, no_conf=False, flip_tta=True),
                     pose_batches()[0][0], torch.device("cpu"), 8)


def replicated(model) -> dict:
    """The rank's tensors that no plan cuts, as they stand."""
    plan = getattr(model, "tp_plan", {})
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n not in plan}


def pair_shards(p: dict, T: int, r: int) -> dict:
    """Model rank r's shards of T of a pair's weights (the layout of
    ``parallel.mesh.shard_params``)."""
    C, hid = p["x"].shape[-1], p["w1"].shape[0]
    ci, hl = C // T, hid // T
    rows = torch.cat([torch.arange(r * ci, (r + 1) * ci) + i * C
                      for i in range(3)])
    return dict(p, wqkv=p["wqkv"][rows], bqkv=p["bqkv"][rows],
                wproj=p["wproj"][:, r * ci:(r + 1) * ci].contiguous(),
                w1=p["w1"][r * hl:(r + 1) * hl],
                b1=p["b1"][r * hl:(r + 1) * hl],
                w2=p["w2"][:, r * hl:(r + 1) * hl].contiguous())


PAIR_KEYS = ("ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_w",
             "ln2_b", "w1", "b1", "w2", "b2")


def pair_inputs() -> dict:
    """A pair's inputs at the small model's widths, from a numpy seed."""
    rs = np.random.RandomState(11)
    C, hid = 32, 64

    def mk(shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rs.normal(size=shape) * scale
                                 + shift).astype(np.float32))

    return dict(x=mk((2, 5, 17, C)), other=mk((2, 5, 17, C)),
                ln1_w=mk((C,), 0.1, 1.0), ln1_b=mk((C,), 0.1),
                wqkv=mk((3 * C, C), C ** -0.5), bqkv=mk((3 * C,), 0.1),
                wproj=mk((C, C), C ** -0.5), bproj=mk((C,), 0.1),
                ln2_w=mk((C,), 0.1, 1.0), ln2_b=mk((C,), 0.1),
                w1=mk((hid, C), C ** -0.5), b1=mk((hid,), 0.1),
                w2=mk((C, hid), hid ** -0.5), b2=mk((C,), 0.1),
                wg=mk((2, 2 * C), (2 * C) ** -0.5), bg=mk((2,), 0.1, 0.5))


def q8_pair_cases(mesh) -> dict:
    """The plain W8A8 pair on this rank's shards of mesh.n_model against the
    plain unsharded pair: {(gated, mode): equal bit for bit}."""
    from motionbert_tpu_torch.ops import pair_q8 as q8

    p = pair_inputs()
    s = pair_shards(p, mesh.n_model, mesh.model_index)
    heads = 4 // mesh.n_model
    out = {}
    for gated in (False, True):
        for mode in ("temporal", "spatial"):
            g = (p["other"], p["wg"], p["bg"]) if gated else (None,) * 3
            got = q8.pair_block_q8_tp_plain(
                s["x"], g[0], *(s[k] for k in PAIR_KEYS), g[1], g[2], heads,
                0.35, mode, mesh.model_group, mesh.model_group)
            want = (q8.gated_pair_block_q8_plain(
                p["x"], g[0], *(p[k] for k in PAIR_KEYS), g[1], g[2], 4,
                0.35, mode) if gated else q8.pair_block_q8_plain(
                p["x"], *(p[k] for k in PAIR_KEYS), 4, 0.35, mode))
            out[gated, mode] = torch.equal(got, want)
    return out


def tier_case(sd: dict, tier: str, mesh) -> dict:
    """A pose model in a W8A8 or stream tier on the grid: the lift, one
    step, the W8A8 pairs on shards called, and no stream call (the stream
    functions raise if reached)."""
    from motionbert_tpu_torch.models import dstformer
    from motionbert_tpu_torch.parallel import tensor
    from motionbert_tpu_torch.parallel.mesh import shard_params

    calls = {"q8_tp": 0}

    def refuse(*args):
        raise AssertionError("a stream function ran on a grid")

    def counted(fn):
        def wrapper(*args):
            calls["q8_tp"] += 1
            return fn(*args)
        return wrapper

    saved_streams, saved_impls = dstformer.STREAM_IMPLS, tensor.TP_IMPLS
    dstformer.STREAM_IMPLS = {k: (refuse, refuse) for k in saved_streams}
    tensor.TP_IMPLS = {k: v[:5] + (counted(v[5]),)
                       for k, v in saved_impls.items()}
    try:
        model = shard_params(pose_model(sd, tier), mesh)
        out = {"lift": pose_lift(model)}
        out.update(run_steps("pose", model, pose_batches()[:1]))
    finally:
        dstformer.STREAM_IMPLS, tensor.TP_IMPLS = saved_streams, saved_impls
    out.pop("opt")
    out["q8_tp_calls"] = calls["q8_tp"]
    return out


def _grid_cases(world: int, out_dir: str) -> dict:
    """Every case of one spawned world; each rank returns its numbers."""
    import torch.distributed as dist

    from motionbert_tpu_torch.core.checkpoint import (
        CheckpointManager, load_checkpoint)
    from motionbert_tpu_torch.parallel.mesh import (
        make_mesh, shard_optimizer_state, shard_params)

    weights = torch.load(os.path.join(out_dir, "weights.pt"))
    mesh = make_mesh(world // 2, 2)
    out = {"place": (mesh.data_index, mesh.model_index)}
    for kind in TASKS:
        model = shard_params(task_model(kind, weights[kind]), mesh)
        res = {"local_shapes": {n: tuple(t.shape) for n, t in (
                   *model.named_parameters(), *model.named_buffers())
                   if n in model.tp_plan},
               "eval": task_eval(kind, model, task_batches(kind)[0][0])}
        res.update(run_steps(kind, model, task_batches(kind)[:1]))
        res["replicated"] = replicated(model)
        res.pop("opt")
        if world == 2:
            model = shard_params(task_model(kind, weights[kind]), mesh)
            first = run_steps(kind, model, task_batches(kind)[:1],
                              lrs=RESUME_LRS)
            CheckpointManager(os.path.join(out_dir, kind)).save_epoch(
                0, RESUME_LRS[0], model, first["opt"])
            res["next"] = run_steps(kind, model, task_batches(kind)[1:],
                                    first["opt"].state_dict())
            res["next"].pop("opt")
        out[kind] = res
    for tier in GRID_TIERS[world]:
        out[tier] = tier_case(weights["pose"], tier, mesh)
    out["q8_model"] = q8_model_lift(shard_params(
        pose_model(weights["q8"], "kernel_q8", cfg=CFG_Q8), mesh))
    if world == 2:
        for kind in (*TASKS, *POSE_KINDS):
            draws = f"{kind}_draws"
            model = (pose_model(weights["pose"], "kernel", POSE_KINDS[kind])
                     if kind in POSE_KINDS else
                     task_model(kind, weights[kind], True))
            out[draws] = run_steps(draws, shard_params(model, mesh),
                                   task_batches(kind)[:1])
            out[draws].pop("opt")
    out["q8_pair"] = {2: q8_pair_cases(mesh)}
    if world == 2:
        dist.barrier()
        mesh21 = make_mesh(2, 1)
        for kind in TASKS:
            payload = load_checkpoint(os.path.join(out_dir, kind,
                                                   "latest_epoch.ckpt"))
            model = shard_params(task_model(kind, payload["model"]), mesh21)
            opt, _ = task_step(kind, model, torch.Generator())
            state = shard_optimizer_state(payload["optimizer"], opt, model)
            res = run_steps(kind, model, task_batches(kind)[1:], state)
            res.pop("opt")
            out[kind]["resumed_2x1"] = res
    else:
        out["q8_pair"][4] = q8_pair_cases(make_mesh(1, 4))
    return out


def _worker(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        out = _grid_cases(world, out_dir)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_grid(world: int, out_dir: str) -> list:
    """``_grid_cases`` on ``world`` spawned ranks; killed at the deadline.
    Returns every rank's numbers."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_worker, args=(r, world, store, out_dir))
             for r in range(world)]
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
    assert [p.exitcode for p in procs] == [0] * world, \
        [p.exitcode for p in procs]
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the weights, the JAX side and the fixtures
# ---------------------------------------------------------------------------

def draw_leaf(rs, name: str, shape) -> np.ndarray:
    """A leaf of a JAX tree from a numpy seed: LayerNorm and BatchNorm
    scales near 1, kernels by fan-in, running variances near 1 and above
    0, everything else small but not zero."""
    if name == "scale":
        a = 1.0 + 0.1 * rs.normal(size=shape)
    elif name == "kernel":
        a = rs.normal(size=shape) * shape[0] ** -0.5
    elif name == "var":
        a = 1.0 + 0.2 * np.abs(rs.normal(size=shape))
    else:
        a = 0.1 * rs.normal(size=shape)
    return a.astype(np.float32)


def draw_task_state(kind: str, seed: int) -> dict:
    """A task model's params and BatchNorm statistics drawn in the JAX
    layout (the tree ``jax_from_state_dict`` gives of its state_dict), and
    the state_dict ``state_dict_from_jax`` makes of them."""
    from motionbert_tpu_torch.models.convert import (
        jax_batch_stats_from_state_dict, state_dict_from_jax)

    sd = _fresh_task_state(kind)
    rs = np.random.RandomState(seed)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                draw_leaf(rs, k, np.asarray(v).shape)
                for k, v in sorted(tree.items())}

    return state_dict_from_jax(draw(_jax_params(sd)),
                               draw(jax_batch_stats_from_state_dict(sd)))


def _fresh_task_state(kind: str) -> dict:
    """The structure of a task model's state_dict (values unused)."""
    from motionbert_tpu_torch.core.config import ConfigDict
    from motionbert_tpu_torch.models.smpl import SMPLModel
    from motionbert_tpu_torch.train.action import build_action_model
    from motionbert_tpu_torch.train.mesh import build_mesh_model

    if kind == "mesh":
        model = build_mesh_model(ConfigDict(BACKBONE, hidden_dim=HIDDEN),
                                 SMPLModel.from_npz(SMPL_NPZ), device="cpu")
    else:
        model = build_action_model(ConfigDict(
            BACKBONE, hidden_dim=HIDDEN, action_classes=CLASSES,
            model_version="class" if kind == "action" else "embed"),
            device="cpu")
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jax_task_model(kind: str):
    """(JAX model, its train step, the step's extra arguments)."""
    from motionbert_tpu.models import smpl as jsmpl
    from motionbert_tpu.models.action_heads import ActionNet as JActionNet
    from motionbert_tpu.models.dstformer import DSTformer as JDSTformer
    from motionbert_tpu.models.mesh_head import MeshRegressor as JMesh
    from motionbert_tpu.train.action import make_action_train_step
    from motionbert_tpu.train.action_1shot import make_supcon_train_step
    from motionbert_tpu.train.mesh import make_mesh_train_step

    backbone = JDSTformer(dim_in=3, dim_out=3, **BACKBONE)
    if kind == "mesh":
        jm = jsmpl.SMPLModel.from_npz(SMPL_NPZ)
        model = JMesh(backbone=backbone, smpl_model=jm, dim_rep=32,
                      hidden_dim=HIDDEN, dropout_ratio=0.0)
        return (model, make_mesh_train_step(model, MESH_LAMBDAS, "L1"),
                (jm.array_pytree(),))
    model = JActionNet(backbone=backbone, dim_rep=32, num_classes=CLASSES,
                       dropout_ratio=0.0, hidden_dim=HIDDEN,
                       version="class" if kind == "action" else "embed")
    step = make_action_train_step(model) if kind == "action" else \
        make_supcon_train_step(model, hidden_dim=HIDDEN, temperature=0.1)
    return model, step, ()


def jax_task_run(kind: str, sd: dict) -> dict:
    """The task's eval outputs (one device) and one step on the JAX
    package's 4 x 2 mesh from the same weights: {"eval", "loss",
    "params", "batch_stats"} (flat, JAX names)."""
    import jax
    import jax.numpy as jnp

    from motionbert_tpu.parallel import make_mesh, shard_batch, shard_params
    from motionbert_tpu.train.action import make_two_group_adamw
    from motionbert_tpu.train.state import TrainState
    from motionbert_tpu_torch.models.convert import (
        jax_batch_stats_from_state_dict)

    assert len(jax.devices()) == 8
    state_np = {k: v.numpy() for k, v in sd.items()}
    params = _jax_params(state_np)
    stats = jax_batch_stats_from_state_dict(state_np) or None
    model, step, extra = _jax_task_model(kind)
    (x, y), = task_batches(kind)[:1]
    variables = {"params": params, **({"batch_stats": stats} if stats
                                      else {})}
    if kind == "mesh":
        out = model.apply(variables, jnp.asarray(x), deterministic=True,
                          smpl=extra[0])
        ev = {k: np.asarray(v) for k, v in out.items()
              if k in ("theta", "verts", "kp_3d")}
    else:
        ev = np.asarray(model.apply(variables, jnp.asarray(x),
                                    deterministic=True))
    mesh = make_mesh(n_data=4, n_model=2)
    state = TrainState.create(model.apply, params,
                              make_two_group_adamw(LR, LR_HEAD, WD),
                              extra_vars=({"batch_stats": stats}
                                          if stats else None))
    state = state.replace(params=shard_params(state.params, mesh))
    assert any(not p.sharding.is_fully_replicated
               for p in jax.tree_util.tree_leaves(state.params))
    xs, ys = shard_batch(
        (jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, y)), mesh)
    state, metrics = step(state, xs, ys, jax.random.PRNGKey(0), *extra)
    loss = metrics if kind == "supcon" else metrics[
        "loss" if kind == "action" else "total"]
    return {"eval": ev, "loss": float(loss),
            "params": _flat(jax.tree_util.tree_map(np.asarray, state.params)),
            "batch_stats": _flat(jax.tree_util.tree_map(
                np.asarray, (state.extra_vars or {}).get("batch_stats",
                                                         {})))}


def q8_jax_params() -> dict:
    """The width-128 model's params, every leaf from a numpy seed."""
    import jax
    import jax.numpy as jnp

    from motionbert_tpu.models.dstformer import DSTformer as JDSTformer

    tree = JDSTformer(**CFG_Q8).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 16, 17, 3)))["params"]
    rs = np.random.RandomState(7)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: draw_leaf(rs, str(path[-1].key), leaf.shape), tree)


def jax_q8_lift(params) -> np.ndarray:
    """The JAX package's pallas_q8 lift (no flip, Pallas interpreted on the
    CPU) of the width-128 model on its 4 x 2 mesh."""
    import jax
    import jax.numpy as jnp

    from motionbert_tpu.models.dstformer import DSTformer as JDSTformer
    from motionbert_tpu.parallel import make_mesh, shard_batch, shard_params
    from motionbert_tpu.train.pose3d import make_eval_step

    model = JDSTformer(**CFG_Q8, attn_impl="pallas_q8")
    mesh = make_mesh(n_data=4, n_model=2)
    step = make_eval_step(model, no_conf=False, flip_tta=False)
    return np.asarray(step(shard_params(jax.tree_util.tree_map(
        jnp.asarray, params), mesh), shard_batch(jnp.asarray(q8_input()),
                                                 mesh)))


@pytest.fixture(scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights(tmp_path_factory, _one_thread):
    """(the weights of every case, a directory holding them, the width-128
    model's JAX params)."""
    from motionbert_tpu_torch.models.convert import state_dict_from_jax

    params = q8_jax_params()
    sds = {kind: draw_task_state(kind, seed)
           for seed, kind in enumerate(TASKS, 1)}
    sds["pose"] = state_dict_from_jax(jax_params())
    sds["q8"] = state_dict_from_jax(params)
    out_dir = str(tmp_path_factory.mktemp("tp_models"))
    torch.save(sds, os.path.join(out_dir, "weights.pt"))
    return sds, out_dir, params


def _spawn(weights, world: int, name: str) -> tuple:
    out_dir = os.path.join(weights[1], name)
    os.makedirs(out_dir)
    os.link(os.path.join(weights[1], "weights.pt"),
            os.path.join(out_dir, "weights.pt"))
    return out_dir, spawn_grid(world, out_dir)


@pytest.fixture(scope="module")
def grid_1x2(weights):
    return _spawn(weights, 2, "1x2")


@pytest.fixture(scope="module")
def grid_2x2(weights):
    return _spawn(weights, 4, "2x2")


@pytest.fixture(params=["1x2", "2x2"])
def grid(request):
    return request.param, request.getfixturevalue(f"grid_{request.param}")[1]


@pytest.fixture(scope="module")
def world1(weights):
    """The port in one process, computed once a case on first use: the
    eval outputs, one step, the first step's gradients (the parameter bar's
    floor)."""
    cache = {}

    def get(case: str) -> dict:
        if case not in cache:
            cache[case] = _world1_case(weights[0], case)
        return cache[case]
    return get


def _world1_case(sds: dict, case: str) -> dict:
    kind = case.replace("_draws", "")
    draws = case.endswith("_draws")
    if case in TIERS:
        tier = case
        build = lambda: pose_model(sds["pose"], tier)
        data, case = pose_batches(), "pose"
    elif kind in POSE_KINDS:
        build = lambda: pose_model(sds["pose"], "kernel",
                                   POSE_KINDS[kind] if draws else None)
        data = pose_batches()
    else:
        build = lambda: task_model(kind, sds[kind], draws)
        data = task_batches(kind)
    model = build()
    out = {}
    if case == "pose" and not draws:
        out["lift"] = pose_lift(model)
    elif not draws:
        out["eval"] = task_eval(kind, model, data[0][0])
    out.update(run_steps(case, model, data[:1]))
    model = build()
    grads = {}
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
             for n, p in model.named_parameters()]
    run_steps(case, model, data[:1])
    for h in hooks:
        h.remove()
    out["grads"] = grads
    if draws:   # the masks are live: another seed draws another loss
        out["other_seed_loss"] = run_steps(case, build(), data[:1],
                                           seed=6)["loss"]
    return out


@pytest.fixture(scope="module")
def jax_ref(weights):
    cache = {}

    def get(kind: str) -> dict:
        if kind not in cache:
            cache[kind] = (jax_q8_lift(weights[2]) if kind == "q8_lift"
                           else jax_task_run(kind, weights[0][kind]))
        return cache[kind]
    return get


def head_lr(name: str) -> float:
    """A task model's learning rate by parameter name (port or JAX)."""
    return LR_HEAD if name.startswith(("head.", "head/")) else LR


def hold_params(got: dict, want: dict, grads: dict, tol: float, what: str,
                lr=None) -> None:
    """Every parameter in ``grads`` to ``tol`` where its first-step
    gradient stands above rounding (1e-5 of the largest), elsewhere to
    AdamW's step bound, twice its learning rate (module note)."""
    floor = 1e-5 * max(g.abs().max().item() for g in grads.values())
    over = {}
    for k, g in grads.items():
        d = (torch.as_tensor(got[k]).double()
             - torch.as_tensor(want[k]).double()).abs()
        real = g.abs() > floor
        bound = 2 * (lr or head_lr)(k) + 1e-6
        if not (d[real] < tol).all() or not (d <= bound).all():
            over[k] = (d[real].max().item() if real.any() else 0.0,
                       d.max().item())
    assert not over, (what, over)


def hold_stats(got: dict, want: dict, what: str) -> None:
    """The BatchNorm running statistics after one step: the pre-step
    forward's batch statistics, to fp32 summation order."""
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert names, what
    for k in names:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=(what, k))


def rel_max(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _eval_items(ev) -> dict:
    return ev if isinstance(ev, dict) else {"out": ev}


def _jax_names(tensors: dict) -> dict:
    from motionbert_tpu_torch.train.action import JAX_MISSING_KEYS

    return {k: torch.as_tensor(v) for k, v in _flat(_jax_params(
        {k: v.numpy() for k, v in tensors.items()
         if k not in JAX_MISSING_KEYS})).items()}


# ---------------------------------------------------------------------------
# the tests: the heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", TASKS)
def test_task_step_matches_the_jax_4x2_step(grid, jax_ref, world1, kind):
    name, ranks = grid
    ref, one = jax_ref(kind), world1(kind)
    grads = _jax_names(one["grads"])
    for out in ranks:
        got = out[kind]
        np.testing.assert_allclose(got["loss"][0], ref["loss"],
                                   rtol=LOSS_RTOL, err_msg=(name, kind))
        hold_params(_jax_names(got["state"]), ref["params"], grads,
                    PARAM_TOL, f"{name} {kind} against JAX 4x2")
        if kind != "supcon":
            from motionbert_tpu_torch.models.convert import (
                jax_batch_stats_from_state_dict)

            stats = _flat(jax_batch_stats_from_state_dict(
                {k: v.numpy() for k, v in got["state"].items()}))
            assert stats.keys() == ref["batch_stats"].keys()
            for k, v in ref["batch_stats"].items():
                np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=(name, kind, k))
        for k, v in _eval_items(ref["eval"]).items():
            err = rel_max(_eval_items(got["eval"])[k], v)
            assert err <= JAX_EVAL_TOL, (name, kind, k, err)


@pytest.mark.parametrize("kind", TASKS)
def test_task_step_matches_world1(grid, world1, kind):
    name, ranks = grid
    one = world1(kind)
    for out in ranks:
        got = out[kind]
        np.testing.assert_allclose(got["loss"][0], one["loss"][0],
                                   rtol=LOSS_RTOL, err_msg=(name, kind))
        hold_params(got["state"], one["state"], one["grads"], PARAM_TOL,
                    f"{name} {kind} against world 1")
        if kind != "supcon":
            hold_stats(got["state"], one["state"], f"{name} {kind}")
        for k, v in _eval_items(one["eval"]).items():
            err = rel_max(_eval_items(got["eval"])[k], v)
            assert err <= EVAL_TOL, (name, kind, k, err)


@pytest.mark.parametrize("kind", TASKS)
def test_replicated_weights_agree_across_the_model_ranks(grid, kind):
    """After a step every tensor that no plan cuts (the backbone, the
    heads' replicated layers) is the same, bit for bit, on the model ranks
    of a data rank; the sharded ones are really cut."""
    name, ranks = grid
    by_data = {}
    for out in ranks:
        by_data.setdefault(out["place"][0], []).append(out[kind])
    for d, outs in by_data.items():
        assert len(outs) == 2
        a, b = (o["replicated"] for o in outs)
        assert a.keys() == b.keys() and any(
            k.startswith("backbone.") for k in a)
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        assert not differ, (name, kind, d, differ)
        assert outs[0]["local_shapes"], (name, kind)


@pytest.mark.parametrize("kind", TASKS)
def test_grids_shard_the_heads_as_the_rules_do(grid, kind):
    """fc1's rows, the classifier's fc2 columns, the mesh head's fc2 on
    its input features J*C, the BatchNorm after fc1 with it; the pairs as
    in tests/test_torch_tp.py; the state_dict gathers them whole."""
    name, ranks = grid
    JC, half = 17 * 32, HIDDEN // 2
    want = {"head.fc1.weight": (half, JC), "head.fc1.bias": (half,)}
    if kind == "action":
        want.update({f"head.bn.{k}": (half,) for k in (
            "weight", "bias", "running_mean", "running_var")})
        want["head.fc2.weight"] = (CLASSES, half)
    if kind == "mesh":
        want.update({f"head.bn1.{k}": (half,) for k in (
            "weight", "bias", "running_mean", "running_var")})
        want["head.fc2.weight"] = (HIDDEN, JC // 2)
    for out in ranks:
        shapes = out[kind]["local_shapes"]
        heads = {k: v for k, v in shapes.items() if k.startswith("head.")}
        assert heads == want, (name, kind, heads)
        pairs = [k for k in shapes if k.startswith("backbone.blocks")]
        assert len(pairs) == 6 * 4 * BACKBONE["depth"], (name, kind)
        state = out[kind]["state"]
        assert state["head.fc1.weight"].shape == (HIDDEN, JC)
        if kind == "mesh":
            assert state["head.fc2.weight"].shape == (HIDDEN, JC)
            assert state["head.bn2.running_mean"].shape == (HIDDEN,)


@pytest.mark.parametrize("kind", TASKS)
def test_param_partition_spec_matches_jax_for_every_task_name(weights, kind):
    """For each state_dict name of the three models, the port's spec names
    the torch dimension of the JAX spec's "model" axis (a (in, out) kernel's
    axis 1 is nn.Linear's dimension 0); BatchNorm statistics and every
    other name stay replicated, as under the JAX rules."""
    from motionbert_tpu.parallel.mesh import (
        param_partition_spec as jax_spec)
    from motionbert_tpu_torch.models.convert import jax_from_state_dict
    from motionbert_tpu_torch.parallel.mesh import param_partition_spec

    sharded = set()
    for name, t in weights[0][kind].items():
        tree = jax_from_state_dict({name: t})
        want = None
        if tree:
            path = []
            while isinstance(tree, dict):
                (key, tree), = tree.items()
                path.append(key)
            spec = tuple(jax_spec("/".join(path), tree))
            want = spec.index("model") if "model" in spec else None
            if want is not None and t.dim() == 2:
                want = 1 - want
        assert param_partition_spec(name, t) == want, name
        if want is not None:
            sharded.add(name)
    heads = {n for n in sharded if n.startswith("head.")}
    assert heads == {"head.fc1.weight", "head.fc1.bias"} | (
        set() if kind == "supcon" else {"head.fc2.weight"})
    assert len(sharded - heads) == 6 * 4 * BACKBONE["depth"]


@pytest.mark.parametrize("kind", TASKS)
@pytest.mark.parametrize("where", ["1x1", "2x1"])
def test_1x2_task_checkpoint_resumes_on_another_grid(grid_1x2, weights,
                                                     world1, kind, where):
    """Saved whole on the 1 x 2 grid after one step, BatchNorm buffers
    included, resumed on one process and on two data-parallel ranks: the
    same next step as the 1 x 2 grid's own."""
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint

    out_dir, ranks = grid_1x2
    path = os.path.join(out_dir, kind, "latest_epoch.ckpt")
    payload = load_checkpoint(path)
    assert payload["model"]["head.fc1.weight"].shape == (HIDDEN, 17 * 32)
    bn = {"action": "head.bn", "mesh": "head.bn1"}.get(kind)
    if bn:
        assert payload["model"][f"{bn}.running_var"].shape == (HIDDEN,)
    ref = ranks[0][kind]["next"]
    if where == "1x1":
        model = task_model(kind, payload["model"])
        got = run_steps(kind, model, task_batches(kind)[1:],
                        payload["optimizer"])
    else:
        got = ranks[0][kind]["resumed_2x1"]
    np.testing.assert_allclose(got["loss"][0], ref["loss"][0],
                               rtol=RESUME_LOSS_RTOL, err_msg=(kind, where))
    hold_params(got["state"], ref["state"], world1(kind)["grads"],
                RESUME_PARAM_TOL, f"{kind} resumed on {where}")
    if bn:
        hold_stats(got["state"], ref["state"], f"{kind} resumed on {where}")


# ---------------------------------------------------------------------------
# the tests: dropout and drop-path, the tiers, the W8A8 pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [*TASKS, *POSE_KINDS])
def test_draws_on_shards_draw_what_world1_draws(grid_1x2, world1, kind):
    """Dropout and drop-path in the backbone and the heads' dropout at the
    configs' rates, on the 1 x 2 grid, against world size 1 from the same
    generator seed (droppath: drop-path alone, so the MLP halves run B6_tp
    / B7_tp without their residual); another seed draws another loss."""
    case = f"{kind}_draws"
    one = world1(case)
    lr = (lambda k: LR) if kind in POSE_KINDS else head_lr
    for out in grid_1x2[1]:
        got = out[case]
        np.testing.assert_allclose(got["loss"][0], one["loss"][0],
                                   rtol=LOSS_RTOL, err_msg=case)
        hold_params(got["state"], one["state"], one["grads"], PARAM_TOL,
                    case, lr)
        if kind in ("action", "mesh"):
            hold_stats(got["state"], one["state"], case)
    assert one["other_seed_loss"][0] != one["loss"][0]


@pytest.mark.parametrize("name,tier", [
    (name, tier) for name, world in (("1x2", 2), ("2x2", 4))
    for tier in GRID_TIERS[world]])
def test_tiers_on_the_grid_match_world1(request, world1, name, tier):
    """The W8A8 tiers' lift bit for bit, the stream tiers' to 2e-5 of the
    largest value; one step at the step's bars; no stream function runs
    on a grid, and the W8A8 tiers call the pair on shards (four pairs a
    depth, flip-TTA's two lifts and the step's forward)."""
    ranks = request.getfixturevalue(f"grid_{name}")[1]
    # plain_q8's own backward at world size 1 runs autograd through the
    # quantiser; on shards it takes the straight-through backward, kernel_q8's
    one = world1("kernel_q8" if tier == "plain_q8" else tier)
    for out in ranks:
        got = out[tier]
        if "q8" in tier:
            assert np.array_equal(got["lift"], one["lift"]), (name, tier)
            assert got["q8_tp_calls"] == 3 * 4 * CFG["depth"]
        else:
            assert rel_max(got["lift"], one["lift"]) <= 2e-5, (name, tier)
            assert got["q8_tp_calls"] == 0
        np.testing.assert_allclose(got["loss"][0], one["loss"][0],
                                   rtol=LOSS_RTOL, err_msg=(name, tier))
        hold_params(got["state"], one["state"], one["grads"], PARAM_TOL,
                    f"{name} {tier}", lambda k: LR)


def test_q8_lift_on_the_grids_matches_the_jax_4x2_mesh(grid_1x2, grid_2x2,
                                                       weights, jax_ref):
    """The width-128 model's kernel_q8 lift on both grids: bit for bit world
    size 1's, and against the JAX package's pallas_q8 lift on its 4 x 2
    mesh at tests/test_torch_q8.py's model bars (through a model some
    values cross a quantiser boundary: that file measures 2.4e-3..3.7e-3 of
    max|ref|)."""
    ref = jax_ref("q8_lift")
    one = q8_model_lift(pose_model(weights[0]["q8"], "kernel_q8", cfg=CFG_Q8))
    for ranks in (grid_1x2[1], grid_2x2[1]):
        for out in ranks:
            got = out["q8_model"]
            assert np.array_equal(got, one)
            l2 = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel_max(got, ref) <= Q8_JAX_TOL and l2 <= Q8_JAX_L2, \
                (rel_max(got, ref), l2)


@pytest.mark.parametrize("T", [2, 4])
def test_plain_q8_pair_on_shards_equals_the_plain_pair(grid_1x2, grid_2x2,
                                                       T):
    """The plain twin of B9_tp on T model ranks (MAX-reduced scales, int32
    partials summed) equals the plain unsharded W8A8 pair bit for bit,
    gated and not, temporal and spatial, on every rank."""
    ranks = grid_1x2[1] if T == 2 else grid_2x2[1]
    for out in ranks:
        cases = out["q8_pair"][T]
        assert len(cases) == 4 and all(cases.values()), cases


@pytest.mark.parametrize("case,match", [
    ("ok", None), ("narrow head group", "Ci % 64"),
    ("ragged hidden slice", "hidden slice"), ("head dim", "head dim"),
    ("wproj columns", "wproj"), ("fp32 x", "x: expected")])
def test_q8_tp_checks_what_the_kernel_takes(case, match):
    """B9_tp's argument checks (run before any launch on the card) on CPU
    tensors of the flagship's shard shapes: shards of whole 64-column tiles
    pass; a narrower head group, a ragged hidden slice, a head dim the core
    lacks, mismatched shards and a wrong dtype raise."""
    from motionbert_tpu_torch.ops import pair_q8 as q8

    C, hid, T = 512, 1024, 2
    bf = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16)
    p = dict(x=bf(1, 3, 17, C), ln1_w=torch.ones(C), ln1_b=torch.zeros(C),
             wqkv=bf(3 * C, C), bqkv=bf(3 * C), wproj=bf(C, C), bproj=bf(C),
             ln2_w=torch.ones(C), ln2_b=torch.zeros(C), w1=bf(hid, C),
             b1=bf(hid), w2=bf(C, hid), b2=bf(C))
    s = pair_shards(p, 16 if case == "narrow head group" else T, 0)
    heads = 4
    if case == "narrow head group":
        heads = 1
    if case == "ragged hidden slice":
        s.update(w1=s["w1"][:96], b1=s["b1"][:96],
                 w2=s["w2"][:, :96].contiguous())
    if case == "head dim":
        heads = 2
    if case == "wproj columns":
        s["wproj"] = p["wproj"]
    if case == "fp32 x":
        s["x"] = s["x"].float()
    args = (s["x"], None, *(s[k] for k in PAIR_KEYS), None, None, heads,
            "temporal")
    if match is None:
        q8.check_tp_args(*args)
    else:
        with pytest.raises(ValueError, match=match):
            q8.check_tp_args(*args)


# ---------------------------------------------------------------------------
# the operators and the halves alone (one process, no collective)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["temporal", "spatial"])
def test_residual_free_halves_are_the_blocks_without_residual(mode):
    """With no group, the attention half without its residual is B4's
    no-residual mode with LayerNorm (attention_block_plain) and its
    backward B5's (the LayerNorm backward leaves g out); the MLP half's is
    B6 / B7's with LayerNorm and no residual; fp32, to summation order."""
    from motionbert_tpu_torch.ops.attention import (
        attention_block_bwd_plain, attention_block_plain)
    from motionbert_tpu_torch.ops.fused_mlp import (
        mlp_block_bwd_plain, mlp_block_plain)
    from motionbert_tpu_torch.parallel.tensor import (
        TpPlan, tp_attention_branch, tp_mlp_branch)

    p = pair_inputs()
    plan = TpPlan(None, None, 4)
    g = torch.from_numpy(np.random.RandomState(5).normal(
        size=p["x"].shape).astype(np.float32))
    attn = [p[k] for k in PAIR_KEYS[:6]]
    mlp = [p[k] for k in PAIR_KEYS[6:]]
    for half, args, plain, plain_bwd, extra in (
            (lambda x, *a: tp_attention_branch(x, *a, plan, 0.35, mode,
                                               "plain"), attn,
             attention_block_plain, attention_block_bwd_plain,
             (4, 0.35, mode)),
            (lambda x, *a: tp_mlp_branch(x, *a, plan, "plain"), mlp,
             mlp_block_plain, mlp_block_bwd_plain, ())):
        leaves = [t.clone().requires_grad_() for t in (p["x"], *args)]
        out = half(*leaves)
        want = plain(p["x"], *args, *extra, True, False)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        got = torch.autograd.grad(out, leaves, g)
        ref = plain_bwd(p["x"], g, *args[:5], *extra, True, False)
        # (dx, dln_w, dln_b, dW, db, dW2[, db2]) against the leaves' order
        for a, b in zip(got[:6], ref[:6]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(got[6], g.reshape(-1, g.shape[-1]).sum(0),
                                   rtol=1e-5, atol=1e-5)


def test_megatron_operators_without_a_group_are_the_identity():
    from motionbert_tpu_torch.parallel.tensor import (
        copy_to_model, gather_from_model, reduce_from_model)

    x = torch.randn(3, 4)
    assert copy_to_model(x, None) is x
    assert reduce_from_model(x, None) is x
    assert gather_from_model(x, None, 2, 1) is x


@pytest.mark.parametrize("name", ["mbt_pair_q8_tp_attn",
                                  "mbt_pair_q8_tp_partial",
                                  "mbt_pair_q8_tp_mlp", "mbt_pair_q8_tp_out",
                                  "mbt_quant_cols"])
def test_q8_tp_argtypes_match_the_c_entries(name):
    """The ctypes argument types of B9_tp's entries and of the column
    quantisers' entry against their signatures in
    csrc/pair_q8_kernels.cu: a pointer for each pointer (a table's arrays
    too) and the stream, a 32-bit int for each int, a float for the
    scale."""
    import ctypes
    import re
    from pathlib import Path

    from motionbert_tpu_torch.ops import pair_q8 as q8

    code = (Path(q8.__file__).with_name("csrc")
            / "pair_q8_kernels.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in code.splitlines())
    params = re.search(rf'extern "C" int {name}\((.*?)\)\s*{{', code,
                       re.S).group(1)
    kinds = []
    for param in params.split(","):
        param = param.strip()
        kinds.append(ctypes.c_void_p if "*" in param else
                      ctypes.c_float if param.startswith("float") else
                      ctypes.c_int)
    assert {**q8.TP_ARGTYPES,
            "mbt_quant_cols": q8.QUANT_COLS_ARGTYPES}[name] == kinds
