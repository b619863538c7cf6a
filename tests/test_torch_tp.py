"""The port's tensor parallelism (``parallel/mesh.py``'s grid and sharding,
``parallel/tensor.py``'s pairs, the pose3d steps and checkpoints on a
sharded model) against the JAX package's DP x TP mesh and against the port
at world size 1, on the CPU.

The grids run in spawned processes on a gloo group started on a
``file://`` store under the test's temporary directory, with a 60 s
timeout, one intra-op thread and a deadline on the join: one spawn of two
ranks for the 1 x 2 grid (then, in the same world, the 2 x 1 grid that
resumes its checkpoint) and one of four for the 2 x 2 grid. The model is
the JAX test's (``tests/test_train_step.py``'s ``CFG``: width 32, 4 heads,
depth 2, mlp_ratio 2) at batch 8 x 9 frames, its weights drawn from a numpy
seed in the JAX package's layout and carried through ``state_dict_from_jax``,
fp32 on the CPU, where the pairs take the TP modes' plain twins. Held:

- the TP lift (flip-TTA eval step), the first step's loss and the
  parameters after one AdamW step, at both grids, against the JAX
  package's 4 x 2 step (``make_mesh(n_data=4, n_model=2)``, ``shard_params``,
  its XLA path) at its own bars (``tests/test_train_step.py:115-151``: loss
  rtol 1e-5, parameters 5e-5), and against the port's world size 1 at the
  same bars; the lift to 2e-5 of its largest value (the goldens' bar). The
  parameter bar applies to every element whose first-step gradient stands
  above rounding (1e-5 of the largest); below it are gradients that are zero
  in exact arithmetic (the key rows of every qkv bias, which the softmax
  ignores), which AdamW moves by up to its step (twice the learning rate)
  in the direction of their rounding noise, whichever framework, grid or
  summation order computes them (as ``tests/test_torch_parallel.py`` holds
  them);
- that the grids really shard: the model ranks hold qkv (3 C / T, C), proj
  (C, C / T), fc1 (hid / T, C) and fc2 (C, hid / T), and gather them whole;
- a checkpoint written on the 1 x 2 grid after one step, resumed on 1 x 1
  and on 2 x 1 (data parallel only), against the 1 x 2 grid's own next step
  (``tests/test_train_infra.py:230-330``: loss rtol 2e-5, parameters 1e-5
  above the gradient floor);
- a model whose heads do not divide over the model ranks keeps its
  attention whole (and warns) and shards its MLP, and steps as world size 1;
- ``param_partition_spec`` against the JAX package's for every parameter
  name of the pose3d model, the grid's rank layout, its refusal and its
  warning, what stays outside tensor parallelism's scope (attention
  dropout, a stage_para block) raising ValueError, and the tiers, rates
  and task models it covers taking their plans
  (``tests/test_torch_tp_models.py`` runs them on grids).
"""

import multiprocessing
import os
import time
import warnings
from datetime import timedelta

import numpy as np
import pytest
import torch

CFG = dict(dim_in=3, dim_out=3, dim_feat=32, dim_rep=32, depth=2,
           num_heads=4, mlp_ratio=2, num_joints=17, maxlen=27)
LAMBDAS = dict(lambda_scale=0.5, lambda_3d_velocity=20.0, lambda_lv=0.0,
               lambda_lg=0.0, lambda_a=0.0, lambda_av=0.0)
BATCH, FRAMES = 8, 9
LR, WD = 1e-3, 0.01
LOSS_RTOL, PARAM_TOL, LIFT_TOL = 1e-5, 5e-5, 2e-5
RESUME_LOSS_RTOL, RESUME_PARAM_TOL = 2e-5, 1e-5
JOIN_SECONDS = 240


# ---------------------------------------------------------------------------
# the port's side, at any grid (the spawned processes import this module)
# ---------------------------------------------------------------------------

def batches() -> list:
    """Two (input, target) batches, as the JAX tests make them."""
    rs = np.random.RandomState(0)
    out = []
    for _ in range(2):
        gt = rs.uniform(-1, 1, (BATCH, FRAMES, 17, 3)).astype(np.float32)
        inp = np.concatenate(
            [gt[..., :2], np.ones((BATCH, FRAMES, 17, 1), np.float32)], -1)
        out.append((inp, gt))
    return out


def port_model(sd: dict, **kw):
    from motionbert_tpu_torch.models.dstformer import DSTformer

    model = DSTformer(**{**CFG, **kw}, attn_impl="kernel")
    model.load_state_dict(sd, strict=True)
    return model


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def port_run(model, steps, opt_state=None) -> dict:
    """The flip-TTA lift of the first batch (the data ranks' rows, gathered)
    and AdamW steps on the given batches: {"lift", "loss" (per step),
    "state" (the whole state_dict after), "opt"}."""
    from motionbert_tpu_torch.parallel.mesh import (
        eval_rows, mean_over_ranks, rank_rows, wrap_ddp)
    from motionbert_tpu_torch.train.pose3d import (
        make_eval_step, make_train_step)
    from motionbert_tpu_torch.train.state import make_adamw

    cpu = torch.device("cpu")
    lift = eval_rows(make_eval_step(model, no_conf=False, flip_tta=True),
                     steps[0][0], cpu, BATCH)
    opt = make_adamw(model.parameters(), LR, WD)
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    step = make_train_step(wrap_ddp(model, cpu), opt, LAMBDAS, rootrel=True,
                           no_conf=False)
    losses = []
    for x, y in steps:
        xr, yr = rank_rows((torch.from_numpy(x), torch.from_numpy(y)))
        losses.append(float(mean_over_ranks(step(xr, yr))["total"]))
    return {"lift": lift, "loss": losses, "state": _state(model), "opt": opt}


def resume(path: str, mesh) -> dict:
    """The second batch's step from a checkpoint, on ``mesh`` (None: one
    process)."""
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint
    from motionbert_tpu_torch.parallel.mesh import (
        shard_optimizer_state, shard_params)
    from motionbert_tpu_torch.train.state import make_adamw

    payload = load_checkpoint(path)
    model = shard_params(port_model(payload["model"]), mesh)
    opt = make_adamw(model.parameters(), LR, WD)
    state = shard_optimizer_state(payload["optimizer"], opt, model)
    return port_run(model, batches()[1:], state)


def _grid_cases(world: int, out_dir: str) -> dict:
    """Every case of one spawned world; each rank returns its numbers."""
    import torch.distributed as dist

    from motionbert_tpu_torch.core.checkpoint import CheckpointManager
    from motionbert_tpu_torch.parallel.mesh import make_mesh, shard_params

    sd = torch.load(os.path.join(out_dir, "weights.pt"))
    out = {}
    if world == 4:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            small = make_mesh(1, 2)
        out["small_grid"] = (small is None, [str(w.message) for w in caught])
        try:
            make_mesh(3, 2)
            out["too_large"] = None
        except ValueError as e:
            out["too_large"] = str(e)
    n_data = world // 2
    mesh = make_mesh(n_data, 2)
    out["place"] = (mesh.data_index, mesh.model_index, mesh.shape,
                    dist.get_world_size(mesh.model_group),
                    dist.get_world_size(mesh.data_group))
    model = shard_params(port_model(sd), mesh)
    out["local_shapes"] = {n: tuple(p.shape)
                           for n, p in model.named_parameters()}
    first = port_run(model, batches()[:1])
    out.update(lift=first["lift"], loss=first["loss"], state=first["state"])
    if world == 2:
        ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"))
        ckpt.save_epoch(0, LR, model, first["opt"])
        dist.barrier()
        out["next"] = next_step(model, first["opt"])
        out["resumed_2x1"] = resume(ckpt.latest_path, make_mesh(2, 1))
        out["resumed_2x1"].pop("opt")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            whole_attn = shard_params(port_model(sd, num_heads=1),
                                      make_mesh(1, 2))
        out["fallback_warnings"] = [str(w.message) for w in caught]
        out["fallback_shapes"] = {n: tuple(p.shape)
                                  for n, p in whole_attn.named_parameters()}
        fb = port_run(whole_attn, batches()[:1])
        out["fallback"] = {"loss": fb["loss"], "state": fb["state"]}
    return out


def next_step(model, opt) -> dict:
    """The second batch's step on the same grid, model and optimizer: the
    trajectory a resumed run must follow."""
    from motionbert_tpu_torch.parallel.mesh import (
        mean_over_ranks, rank_rows, wrap_ddp)
    from motionbert_tpu_torch.train.pose3d import make_train_step

    step = make_train_step(wrap_ddp(model, torch.device("cpu")), opt,
                           LAMBDAS, rootrel=True, no_conf=False)
    x, y = batches()[1]
    xr, yr = rank_rows((torch.from_numpy(x), torch.from_numpy(y)))
    loss = float(mean_over_ranks(step(xr, yr))["total"])
    return {"loss": [loss], "state": _state(model)}


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
# the JAX side and the fixtures
# ---------------------------------------------------------------------------

def jax_params() -> dict:
    """The JAX model's parameter tree, every leaf drawn from a numpy seed
    (LayerNorm scales near 1, kernels by fan-in, biases small but not
    zero)."""
    import jax
    import jax.numpy as jnp

    from motionbert_tpu.models.dstformer import DSTformer as JDSTformer

    tree = JDSTformer(**CFG).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, FRAMES, 17, 3)))["params"]
    rs = np.random.RandomState(0)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "scale":
            a = 1.0 + 0.1 * rs.normal(size=shape)
        elif name == "kernel":
            a = rs.normal(size=shape) * shape[0] ** -0.5
        else:
            a = 0.1 * rs.normal(size=shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def jax_runs(params) -> dict:
    """The JAX package's lift on one device and its first step on one device
    and on the 4 x 2 mesh (``tests/test_train_step.py``'s recipe)."""
    import jax
    import jax.numpy as jnp

    from motionbert_tpu.models.dstformer import DSTformer as JDSTformer
    from motionbert_tpu.parallel import make_mesh, shard_batch, shard_params
    from motionbert_tpu.train.pose3d import make_eval_step, make_train_step
    from motionbert_tpu.train.state import TrainState, make_adamw
    from motionbert_tpu_torch.models.convert import state_dict_from_jax

    assert len(jax.devices()) == 8
    model = JDSTformer(**CFG)
    x, y = (jnp.asarray(a) for a in batches()[0])
    lift = np.asarray(make_eval_step(model, no_conf=False, flip_tta=True)(
        params, x))
    step = make_train_step(model, LAMBDAS, rootrel=True, no_conf=False,
                           use_mask=False, use_noise=False, noise_params=None)

    def fresh():
        return TrainState.create(model.apply, jax.tree_util.tree_map(
            jnp.asarray, params), make_adamw(LR, WD))

    out = {"lift": lift}
    single, terms = step(fresh(), x, y, jax.random.PRNGKey(5))
    out["single"] = (float(terms["total"]), state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, single.params)))
    mesh = make_mesh(n_data=4, n_model=2)
    state = fresh()
    state = state.replace(
        params=shard_params(state.params, mesh),
        opt_state=jax.device_put(
            state.opt_state,
            jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())))
    assert any(not p.sharding.is_fully_replicated
               for p in jax.tree_util.tree_leaves(state.params))
    xs, ys = shard_batch((x, y), mesh)
    sharded, terms = step(state, xs, ys, jax.random.PRNGKey(5))
    out["4x2"] = (float(terms["total"]), state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, sharded.params)))
    return out


@pytest.fixture(scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights(tmp_path_factory, _one_thread):
    """(JAX params, the port's state_dict, a directory holding it)."""
    from motionbert_tpu_torch.models.convert import state_dict_from_jax

    params = jax_params()
    sd = state_dict_from_jax(params)
    out_dir = str(tmp_path_factory.mktemp("tp"))
    torch.save(sd, os.path.join(out_dir, "weights.pt"))
    return params, sd, out_dir


@pytest.fixture(scope="module")
def jax_ref(weights):
    return jax_runs(weights[0])


@pytest.fixture(scope="module")
def world1(weights):
    """The port in one process: the lift, one step, and the first step's
    gradients (for the parameter bar's floor)."""
    sd = weights[1]
    out = port_run(port_model(sd), batches()[:1])
    model = port_model(sd)
    grads = {}
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
             for n, p in model.named_parameters()]
    port_run(model, batches()[:1])
    for h in hooks:
        h.remove()
    out["grads"] = grads
    fb = port_model(sd, num_heads=1)
    out["fallback"] = port_run(fb, batches()[:1])
    return out


@pytest.fixture(scope="module")
def grid_1x2(weights):
    out_dir = os.path.join(weights[2], "1x2")
    os.makedirs(out_dir)
    os.link(os.path.join(weights[2], "weights.pt"),
            os.path.join(out_dir, "weights.pt"))
    return out_dir, spawn_grid(2, out_dir)


@pytest.fixture(scope="module")
def grid_2x2(weights):
    out_dir = os.path.join(weights[2], "2x2")
    os.makedirs(out_dir)
    os.link(os.path.join(weights[2], "weights.pt"),
            os.path.join(out_dir, "weights.pt"))
    return out_dir, spawn_grid(4, out_dir)


@pytest.fixture(params=["1x2", "2x2"])
def grid(request):
    return request.param, request.getfixturevalue(f"grid_{request.param}")[1]


def hold_params(got: dict, want: dict, grads: dict, tol: float,
                what: str) -> None:
    """Every parameter to ``tol`` where its first-step gradient stands above
    rounding (1e-5 of the largest), elsewhere to AdamW's step (module
    note)."""
    assert got.keys() == want.keys(), what
    floor = 1e-5 * max(g.abs().max().item() for g in grads.values())
    over = {}
    for k, w in want.items():
        d = (got[k].double() - torch.as_tensor(w).double()).abs()
        real = grads[k].abs() > floor
        if not (d[real] < tol).all() or not (d <= 2 * LR + 1e-6).all():
            over[k] = (d[real].max().item() if real.any() else 0.0,
                       d.max().item())
    assert not over, (what, over)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_grids_shard_what_the_rules_shard(grid):
    """Every model rank holds its head group and hidden slice of every
    pair, nothing else is cut, and the state_dict gathers them whole."""
    name, ranks = grid
    T, C, hid = 2, CFG["dim_feat"], CFG["dim_feat"] * CFG["mlp_ratio"]
    want = {"qkv.weight": (3 * C // T, C), "qkv.bias": (3 * C // T,),
            "proj.weight": (C, C // T), "fc1.weight": (hid // T, C),
            "fc1.bias": (hid // T,), "fc2.weight": (C, hid // T)}
    for out in ranks:
        shapes = out["local_shapes"]
        sharded = {n: s for n, s in shapes.items()
                   if any(n.endswith(k) for k in want)}
        assert len(sharded) == 4 * CFG["depth"] * 2 * 3, name
        for n, s in sharded.items():
            assert s == want[".".join(n.rsplit(".", 2)[-2:])], (name, n, s)
        for n, t in out["state"].items():
            if n in shapes and n not in sharded:
                assert tuple(t.shape) == shapes[n], n
        assert out["state"]["blocks_st.0.attn_s.qkv.weight"].shape == (3 * C,
                                                                        C)


def test_grid_places_the_ranks_as_jax_reshapes_the_devices(grid_2x2):
    """Rank r sits at (r // n_model, r % n_model) with groups of n_model
    and n_data ranks; a grid larger than the world raises (the JAX
    package's assert), a smaller one warns and leaves the other ranks
    out."""
    for r, out in enumerate(grid_2x2[1]):
        d, m, shape, model_size, data_size = out["place"]
        assert (d, m) == divmod(r, 2)
        assert shape == {"data": 2, "model": 2}
        assert (model_size, data_size) == (2, 2)
        assert "does not fit 4 device(s)" in out["too_large"]
        left_out, caught = out["small_grid"]
        assert left_out == (r >= 2)
        assert any("uses 2 of 4 devices" in w for w in caught)


def test_one_process_grid_is_the_identity():
    from motionbert_tpu_torch.parallel.mesh import (
        data_size, make_mesh, shard_params)

    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert data_size() == 1
    model = torch.nn.Linear(3, 4)
    assert shard_params(model, mesh) is model


def test_tp_lift_matches_jax_and_world1(grid, jax_ref, world1):
    name, ranks = grid
    for ref, what in ((jax_ref["lift"], "JAX"), (world1["lift"], "world 1")):
        for out in ranks:
            err = np.abs(out["lift"] - ref).max() / np.abs(ref).max()
            assert err <= LIFT_TOL, (name, what, err)


def test_tp_step_matches_the_jax_4x2_step(grid, jax_ref, world1):
    name, ranks = grid
    loss, params = jax_ref["4x2"]
    for out in ranks:
        np.testing.assert_allclose(out["loss"][0], loss, rtol=LOSS_RTOL)
        hold_params(out["state"], params, world1["grads"], PARAM_TOL,
                    f"{name} against JAX 4x2")
    # the JAX mesh itself against one device, as its own test holds it
    np.testing.assert_allclose(loss, jax_ref["single"][0], rtol=LOSS_RTOL)


def test_tp_step_matches_world1(grid, world1):
    name, ranks = grid
    for out in ranks:
        np.testing.assert_allclose(out["loss"][0], world1["loss"][0],
                                   rtol=LOSS_RTOL)
        hold_params(out["state"], world1["state"], world1["grads"],
                    PARAM_TOL, f"{name} against world 1")


def test_world1_matches_the_jax_single_step(jax_ref, world1):
    """The reference the grids are held to, held to the JAX package."""
    loss, params = jax_ref["single"]
    np.testing.assert_allclose(world1["loss"][0], loss, rtol=LOSS_RTOL)
    hold_params(world1["state"], params, world1["grads"], PARAM_TOL,
                "world 1 against JAX")


@pytest.mark.parametrize("where", ["1x1", "2x1"])
def test_1x2_checkpoint_resumes_on_another_grid(grid_1x2, world1, where):
    """Saved whole on the 1 x 2 grid after one step (every rank calls the
    save, rank 0 writes), resumed on one process and on two data-parallel
    ranks: the same next step as the 1 x 2 grid's own."""
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint

    out_dir, ranks = grid_1x2
    path = os.path.join(out_dir, "ckpt", "latest_epoch.ckpt")
    payload = load_checkpoint(path)
    C = CFG["dim_feat"]
    assert payload["model"]["blocks_ts.1.mlp_t.fc2.weight"].shape == (C,
                                                                      2 * C)
    moments = payload["optimizer"]["state"]
    assert all(v["exp_avg"].shape == payload["model"][k].shape
               for k, v in zip(payload["model"], moments.values()))
    ref = ranks[0]["next"]
    got = resume(path, None) if where == "1x1" else ranks[0]["resumed_2x1"]
    np.testing.assert_allclose(got["loss"][0], ref["loss"][0],
                               rtol=RESUME_LOSS_RTOL)
    hold_params(got["state"], ref["state"], world1["grads"],
                RESUME_PARAM_TOL, f"resumed on {where}")


def test_heads_that_do_not_divide_stay_whole(grid_1x2, world1):
    """One head over two model ranks: the attention halves run whole on
    each rank (with a warning), the MLP halves still shard, and the step is
    world size 1's."""
    out = grid_1x2[1][0]
    C = CFG["dim_feat"]
    assert any("attention heads does not divide" in w
               for w in out["fallback_warnings"])
    shapes = out["fallback_shapes"]
    assert shapes["blocks_st.0.attn_s.qkv.weight"] == (3 * C, C)
    assert shapes["blocks_st.0.mlp_s.fc1.weight"] == (C, C)
    np.testing.assert_allclose(out["fallback"]["loss"][0],
                               world1["fallback"]["loss"][0], rtol=LOSS_RTOL)
    hold_params(out["fallback"]["state"], world1["fallback"]["state"],
                world1["grads"], PARAM_TOL, "whole attention")


def test_param_partition_spec_matches_jax_for_every_pose3d_name(weights):
    """For each state_dict name the port's spec names the torch dimension of
    the JAX spec's "model" axis on the flax kernel or bias (a (in, out)
    kernel's axis 1 is nn.Linear's dimension 0)."""
    from motionbert_tpu.parallel.mesh import (
        param_partition_spec as jax_spec)
    from motionbert_tpu_torch.models.convert import jax_from_state_dict
    from motionbert_tpu_torch.parallel.mesh import param_partition_spec

    sd = weights[1]
    sharded = 0
    for name, t in sd.items():
        tree = jax_from_state_dict({name: t})
        path = []
        while isinstance(tree, dict):
            (key, tree), = tree.items()
            path.append(key)
        spec = tuple(jax_spec("/".join(path), tree))
        want = spec.index("model") if "model" in spec else None
        if want is not None and t.dim() == 2:
            want = 1 - want
        assert param_partition_spec(name, t) == want, (name, spec)
        sharded += want is not None
    assert sharded == 6 * 4 * CFG["depth"]


def _scope_model(kind: str):
    from motionbert_tpu_torch.core.config import ConfigDict
    from motionbert_tpu_torch.models.dstformer import DSTformer

    if kind in ("kernel_q8", "plain_q8", "kernel_stream", "kernel_stream_q8"):
        return DSTformer(**CFG, attn_impl=kind)
    if kind in ("drop_rate", "drop_path_rate", "attn_drop_rate"):
        return DSTformer(**CFG, **{kind: 0.1})
    if kind == "stage_para":
        model = DSTformer(**CFG)
        model.blocks_st[0].st_mode = "stage_para"
        return model
    if kind in ("action", "embed"):
        from motionbert_tpu_torch.train.action import build_action_model

        return build_action_model(ConfigDict(
            {k: v for k, v in CFG.items() if k not in ("dim_in", "dim_out")},
            hidden_dim=64, action_classes=6, dropout_ratio=0.5,
            model_version="class" if kind == "action" else "embed"),
            device="cpu")
    if kind == "mesh":
        from motionbert_tpu_torch.models.smpl import SMPLModel
        from motionbert_tpu_torch.train.mesh import build_mesh_model

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        smpl = SMPLModel.from_npz(os.path.join(
            root, "data", "synthetic", "mesh", "smpl_model.npz"))
        return build_mesh_model(ConfigDict(
            {k: v for k, v in CFG.items() if k not in ("dim_in", "dim_out")},
            hidden_dim=64, dropout=0.1), smpl, device="cpu")
    raise AssertionError(kind)


SCOPE = {"attn_drop_rate": "attention dropout", "stage_para": "stage_para"}


@pytest.mark.parametrize("kind", sorted(SCOPE))
def test_what_tensor_parallelism_does_not_cover_raises(kind):
    """On a grid with a model axis, shard_params refuses every model it does
    not cover and names what it lacks; on a grid without one it takes any
    model as it is."""
    from motionbert_tpu_torch.parallel.mesh import Mesh, shard_params

    model = _scope_model(kind)
    with pytest.raises(ValueError, match=SCOPE[kind]):
        shard_params(model, Mesh(n_data=1, n_model=2))
    assert shard_params(model, Mesh(n_data=2, n_model=1)) is model


COVERED = ("kernel_q8", "plain_q8", "kernel_stream", "kernel_stream_q8",
           "drop_rate", "drop_path_rate", "action", "embed", "mesh")


@pytest.mark.parametrize("kind", COVERED)
def test_shard_params_takes_every_tier_rate_and_task_model(kind):
    """The W8A8 and stream tiers, dropout and drop-path, and the action
    (classifier and embedding) and mesh models shard on a grid with a
    model axis: every block gets its plan, a task model's head its own,
    model rank 0 keeps its halves of the pairs' and the heads' fc1; a
    second shard_params refuses (already sharded)."""
    from motionbert_tpu_torch.parallel.mesh import Mesh, shard_params

    model = _scope_model(kind)
    assert shard_params(model, Mesh(n_data=1, n_model=2)) is model
    backbone = getattr(model, "backbone", model)
    assert all(b.tp is not None and b.tp.heads == CFG["num_heads"] // 2
               for b in (*backbone.blocks_st, *backbone.blocks_ts))
    C = CFG["dim_feat"]
    assert backbone.blocks_ts[1].mlp_t.fc1.weight.shape == (C, C)
    if backbone is not model:
        assert model.head.tp is not None and model.head.tp.n_model == 2
        assert model.head.fc1.weight.shape == (32, 17 * C)
    with pytest.raises(ValueError, match="already sharded"):
        shard_params(model, Mesh(n_data=1, n_model=2))
