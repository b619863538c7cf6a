"""Data and tensor parallelism over ``torch.distributed``: process groups,
the ("data", "model") process grid, the rank's rows of a global batch,
padded evaluation batches, gathers, the DDP wrap, and the tensor-parallel
sharding of the DSTformer's weights and of the action and mesh heads'.

The port of ``motionbert_tpu/parallel/mesh.py`` (``make_mesh``,
``shard_batch``, ``padded_eval_batches``, ``_TP_RULES``,
``param_partition_spec``, ``shard_params``) in PyTorch idiom. The data axis:
one process per device (``torchrun --nproc_per_node N``), every process
holding the whole model and the rows ``[r * B / W, (r + 1) * B / W)`` of
the same global batch of B clips, gradients averaged by
``DistributedDataParallel``. What the JAX mesh does implicitly the port does
by hand, so that a run at world size W computes what a run at world size 1
computes on the same global batch:

- every random draw whose leading axis is the batch takes the global
  batch's draw and keeps the rank's rows (``rank_draw``), so the generators
  stay in lockstep on every rank and a checkpoint's generator state resumes
  at any world size;
- BatchNorm takes its statistics over the global batch and SupCon compares
  the features of the global batch (``gather_rows``, with gradient);
- evaluation pads the tail batch, runs the rank's rows and gathers the
  outputs back to the global batch.

The model axis (``make_mesh(n_data, n_model)`` with ``n_model > 1``): rank r
of W = n_data * n_model ranks sits at (r // n_model, r % n_model), as the
JAX package's ``devices.reshape(n_data, n_model)``. The JAX package puts
column-parallel specs on qkv / fc1 and row-parallel ones on proj / fc2 and
lets GSPMD derive the collectives (and gather the operands of an opaque
Pallas call); the port computes on the shards for real, Megatron style:
``shard_params`` leaves each model rank a head group of every attention
(qkv's q, k and v rows of heads [r H / T, (r + 1) H / T) and proj's
matching columns) and a hidden slice of every MLP, the pairs run the TP
modes of the block kernels on them and all-reduce their fp32 partials over
the model group (``parallel/tensor.py``), and DDP averages gradients over
the data group, whose ranks hold the same shards. The action and mesh
heads' fc1 / fc2 layers, which the same rules name, are cut the same way
(column- and row-parallel, Megatron's operators around them), and a
BatchNorm after a sliced fc1 keeps the rank's features, its statistics
summed over the data group. A sharded model's
``state_dict()`` gathers whole tensors (``gather_params``) and its
``load_state_dict`` takes whole tensors and keeps its shards, so a
checkpoint written at any grid loads at any other. With a grid, the rows,
draws, gathers and means below go by the data rank and size: the model
ranks of one data rank see the same rows and draw the same numbers.

With no process group every function here is the one-process identity, and
the single-process paths keep their bits.
"""

from __future__ import annotations

import argparse
import os
import random
import re
import warnings
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# how long a collective, and the group's start-up, may wait for a rank
TIMEOUT = timedelta(minutes=10)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclass
class Mesh:
    """This rank's place on the ("data", "model") process grid: the grid's
    sizes, the rank's indices on both axes, and the process groups of its
    model ranks (consecutive ranks, one data index) and of its data ranks
    (one model index). The groups are None without a process group (the
    1 x 1 grid)."""

    n_data: int
    n_model: int
    data_index: int = 0
    model_index: int = 0
    model_group: Optional[object] = field(default=None, repr=False)
    data_group: Optional[object] = field(default=None, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}


# the grid make_mesh last built on this process and the world size it was
# built in; the data axis's helpers read it (a grid of another world size is
# stale and ignored)
_GRID: Tuple[Optional[Mesh], int] = (None, 1)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ("data", "model") grid over the started process group's W ranks
    (``motionbert_tpu.parallel.make_mesh``): n_data defaults to W //
    n_model; rank r sits at (r // n_model, r % n_model). A grid larger than
    W raises ValueError (the JAX package's assert); a smaller one warns, and
    the ranks outside it get None and take no part. Every rank calls it (it creates the process
    groups). Without a process group it is the 1 x 1 grid."""
    global _GRID
    W, r = world_size(), rank()
    if n_data is None:
        n_data = W // n_model
    if not (n_data >= 1 and n_model >= 1 and n_data * n_model <= W):
        raise ValueError(f"mesh {n_data}x{n_model} does not fit {W} "
                         f"device(s)")
    if n_data * n_model != W:
        warnings.warn(f"mesh {n_data}x{n_model} uses {n_data * n_model} of "
                      f"{W} devices; the rest sit idle", stacklevel=2)
    if W == 1:
        _GRID = (Mesh(1, 1), 1)
        return _GRID[0]
    groups = {}
    for d in range(n_data):
        ranks = list(range(d * n_model, (d + 1) * n_model))
        groups["model", d] = dist.new_group(ranks)
    for m in range(n_model):
        ranks = list(range(m, n_data * n_model, n_model))
        groups["data", m] = dist.new_group(ranks)
    mesh = None
    if r < n_data * n_model:
        d, m = divmod(r, n_model)
        mesh = Mesh(n_data, n_model, d, m, groups["model", d],
                    groups["data", m])
    _GRID = (mesh, W)
    return mesh


def _data_axis() -> Tuple[int, int, Optional[object]]:
    """(size, this rank's index, process group) of the data axis: the
    grid's when make_mesh built one for this world, else every rank."""
    g, W = _GRID
    if g is not None and W == world_size() > 1:
        return g.n_data, g.data_index, g.data_group
    return world_size(), rank(), None


def data_size() -> int:
    """The number of data-parallel ranks: the ranks that split a batch."""
    return _data_axis()[0]


def is_main() -> bool:
    """True on the rank that writes logs and checkpoints (rank 0)."""
    return rank() == 0


def init_distributed(device=None,
                     backend: Optional[str] = None) -> torch.device:
    """The device this process trains on, with its process group started.

    Under ``torchrun`` (``WORLD_SIZE`` above 1 in the environment) the group
    starts from the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and the device is ``cuda:LOCAL_RANK`` unless ``device``
    names one. ``backend`` None is NCCL on a CUDA device and gloo on the CPU;
    NCCL with a CPU device raises, and so does a group that fails to start.
    With no such environment, or a group already started by the caller, it
    starts nothing. Returns the device (``models.factory.resolve_device``)."""
    from motionbert_tpu_torch.models.factory import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device is None and world > 1:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if dist.is_initialized() or world == 1:
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, got {dev}")
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]), timeout=TIMEOUT)
    return dev


def shutdown_distributed() -> None:
    """Destroy the process group, if one was started."""
    if dist.is_initialized():
        dist.destroy_process_group()


def add_dist_backend(parser: argparse.ArgumentParser) -> None:
    """The trainers' --dist_backend flag."""
    parser.add_argument("--dist_backend", default=None,
                        help="torch.distributed backend under torchrun "
                             "(default: nccl on the card, gloo on the CPU)")


def run_main(train_with_config, opts, args):
    """A trainer's main: seed the host RNGs, run the driver on the options'
    device (``init_distributed`` inside it), and destroy the process group
    it started."""
    random.seed(opts.seed)
    np.random.seed(opts.seed)
    try:
        return train_with_config(args, opts, device=opts.device,
                                 attn_impl=opts.attn_impl)
    finally:
        shutdown_distributed()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def rank_rows(batch):
    """The rank's rows ``[r * B / W, (r + 1) * B / W)`` of a global batch: an
    array or tensor, or a tuple, list or dict of them, each with B rows, r
    and W the data rank and size. B must divide over the W ranks
    (``motionbert_tpu/train/pose3d.py``'s assert)."""
    W, r, _ = _data_axis()
    if W == 1:
        return batch
    if isinstance(batch, dict):
        return {k: rank_rows(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(rank_rows(v) for v in batch)
    n = batch.shape[0]
    if n % W:
        raise ValueError(f"a batch of {n} rows does not divide over {W} "
                         f"ranks")
    b = n // W
    return batch[r * b:(r + 1) * b]


def check_batch_size(batch_size: int) -> None:
    """A batch must split evenly over the data ranks."""
    if batch_size % data_size():
        raise ValueError(f"batch_size {batch_size} does not divide over "
                         f"{data_size()} ranks")


def rank_batches(loader, device):
    """The rank's rows of each batch of a train loader, on ``device``
    (``data.datasets.device_prefetch``)."""
    from motionbert_tpu_torch.data.datasets import device_prefetch

    return device_prefetch((rank_rows(b) for b in loader), device)


def rank_draw(draw, shape, generator: torch.Generator) -> torch.Tensor:
    """``draw(shape, generator)`` for a draw whose leading axis is the batch:
    the draw at the global batch's shape (``shape[0] * W`` rows), and the
    rank's rows of it. Every rank draws the same numbers, so the generators
    advance alike and the masks do not depend on the world size. W and the
    rank's index are the data axis's."""
    W, r, _ = _data_axis()
    if W == 1:
        return draw(shape, generator)
    b = shape[0]
    full = draw((b * W,) + tuple(shape[1:]), generator)
    return full[r * b:(r + 1) * b]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows in rank order: the (W * b, ...) global batch of an
    (b, ...) tensor, on every rank, differentiable. The rows go into a zero
    tensor of the global shape that ``torch.distributed.nn.functional``'s
    all-reduce sums over the ranks (exact: each element is one rank's value
    plus zeros). Its backward sums the global gradient over the ranks, so a
    loss computed on every rank from the gathered rows, its gradients
    averaged by DDP, has the one-process gradient: the all-reduce multiplies
    by W and DDP divides by it. All-reduce is the one collective that gloo
    also runs on CUDA tensors. With a grid, over the data ranks."""
    W, r, group = _data_axis()
    if W == 1:
        return x
    b = x.shape[0]
    full = x.new_zeros((W * b,) + tuple(x.shape[1:]))
    full[r * b:(r + 1) * b] = x
    return all_reduce_sum(full, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of x over the ranks of ``group`` (None: every rank),
    differentiable (its gradient is summed over the ranks too); x itself
    with no process group."""
    if world_size() == 1:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=group or dist.group.WORLD)


def sum_over_data(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the data ranks (with a grid, the ranks of this
    rank's data group: its model ranks hold other features), differentiable;
    x itself with one data rank."""
    W, _, group = _data_axis()
    return x if W == 1 else all_reduce_sum(x, group)


def mean_over_ranks(terms: dict) -> dict:
    """The mean over the ranks of 0-d tensors (the loss terms of the rank's
    rows): the global batch's terms where each is a mean over its rows.
    One all-reduce for the lot, over the data ranks."""
    W, _, group = _data_axis()
    if W == 1:
        return terms
    keys = list(terms)
    stacked = torch.stack([terms[k].detach().float() for k in keys])
    dist.all_reduce(stacked, group=group)
    stacked /= W
    return dict(zip(keys, stacked))


def padded_eval_batches(loader, multiple: int = 1) -> Iterator[tuple]:
    """Iterate an evaluation loader for a fixed batch shape: yields
    (batch_input, batch_gt, n), the input padded up to the first batch's
    size, rounded up to a multiple of ``multiple`` (the world size, so that
    it divides over the ranks), by repeating its last clip; callers slice
    outputs back to [:n]. Only the final batch may be short (``BatchLoader``
    with drop_last=False). With ``multiple`` 1 it yields what
    ``motionbert_tpu.parallel.mesh.padded_eval_batches`` yields (as numpy).
    Raises on an empty loader and on a batch larger than the first."""
    full_bs = None
    for batch_input, batch_gt in loader:
        batch_input = np.asarray(batch_input)
        n = batch_input.shape[0]
        if full_bs is None:
            full_bs = -(-n // multiple) * multiple
        if not 0 < n <= full_bs:
            raise ValueError(f"an evaluation batch of {n} clips after a "
                             f"first batch of {full_bs}")
        if n < full_bs:
            batch_input = np.concatenate(
                [batch_input, np.repeat(batch_input[-1:], full_bs - n, 0)])
        yield batch_input, batch_gt, n
    if full_bs is None:
        raise ValueError("the evaluation loader yielded no batch")


def eval_rows(step, batch_input: np.ndarray, device, n: int):
    """``step`` on the rank's rows of a padded evaluation batch, the outputs
    (a tensor or a dict of them) gathered back to the global batch and cut
    to its first n rows, on the host as numpy."""
    out = step(torch.from_numpy(rank_rows(batch_input)).to(device))

    def whole(t):
        return gather_rows(t).detach().cpu().numpy()[:n]

    if isinstance(out, dict):
        return {k: whole(v) for k, v in out.items()}
    return whole(out)


def wrap_ddp(model: torch.nn.Module, device: torch.device,
             ignore: tuple = ()) -> torch.nn.Module:
    """The model wrapped in ``DistributedDataParallel`` when a process group
    is started (even of one rank), else the model itself; with a grid, over
    the data group (whose ranks hold the same shards). ``ignore``: the
    names of parameters the forward never uses (an ActionNet's or a
    MeshRegressor's ``backbone.head``), left out of the gradient
    reduction, which would otherwise wait for them. Buffers are not
    broadcast: the BatchNorm statistics are the global batch's on every
    rank already. Checkpoints save the model, not the wrapper, so no
    ``module.`` prefix reaches them."""
    if not dist.is_initialized():
        return model
    from torch.nn.parallel import DistributedDataParallel

    if ignore:
        DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
            model, list(ignore))
    ids = [device.index if device.index is not None
           else torch.cuda.current_device()] if device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids,
                                   broadcast_buffers=False,
                                   process_group=_data_axis()[2])


# ---------------------------------------------------------------------------
# tensor parallelism: the JAX package's partitioning rules on the port's
# state_dict names, the sharding of the pose3d model, the gathers
# ---------------------------------------------------------------------------

# _TP_RULES of motionbert_tpu/parallel/mesh.py on nn.Linear's (out, in)
# layout: the torch dimension that the rule's "model" axis shards. flax's
# qkv / fc1 kernel P(None, "model") and bias P("model") shard the output
# features (torch dim 0), proj / fc2 kernel P("model", None) the input ones
# (torch dim 1).
_TP_RULES = [
    (re.compile(r".*(qkv|fc1)\.weight$"), 0),
    (re.compile(r".*(qkv|fc1)\.bias$"), 0),
    (re.compile(r".*(proj|fc2)\.weight$"), 1),
]


def param_partition_spec(name: str, value=None) -> Optional[int]:
    """The dimension of the state_dict entry ``name`` that the JAX package's
    rules shard over the model axis, or None (replicated). ``value`` is
    taken for the JAX signature's sake."""
    for pat, dim in _TP_RULES:
        if pat.match(name):
            return dim
    return None


def _engine_widths(model) -> bool:
    """Whether the model's pairs run the CUDA chains (a kernel tier on a
    CUDA device), whose shards must be whole 64-column tiles of the GEMM
    engines (bf16 and s8): a half whose shard is not then stays whole, as
    one whose heads do not divide does."""
    from motionbert_tpu_torch.parallel.tensor import TIER_IMPLS

    backbone = getattr(model, "backbone", model)
    return TIER_IMPLS[backbone.blocks_st[0].attn_impl][0] == "kernel" and \
        next(backbone.parameters()).device.type == "cuda"


def _tp_plan(model, mesh: Mesh) -> dict:
    """{state_dict name: (dim, the model rank's indices along it)} of every
    tensor the rules shard that divides over the model axis. The pairs:
    qkv's rows of the rank's head group (its q, k and v rows of heads
    [r H / T, (r + 1) H / T)), proj's columns of those heads, fc1's rows and
    fc2's columns of the rank's hidden slice; a pair whose heads (or hidden
    width) do not divide, or on the card whose shard is not whole 64-column
    tiles, stays whole on every rank, as JAX replicates a dimension that
    does not divide. The heads: each fc1 / fc2 weight and bias the rules
    name, on the rule's dimension, the rank's contiguous slice of it (whole
    when it does not divide: the JAX rule's fallback per parameter), and
    the BatchNorm after a sliced fc1 (weight, bias, running averages) on
    the same features."""
    from motionbert_tpu_torch.models.dstformer import Attention, Mlp

    T, r = mesh.n_model, mesh.model_index
    tiles = _engine_widths(model)

    def own(n: int) -> torch.Tensor:
        return torch.arange(r * (n // T), (r + 1) * (n // T))

    plan = {}
    tensors = dict(model.named_parameters())
    for name, t in tensors.items():
        dim = param_partition_spec(name)
        if dim is None:
            continue
        owner, layer, _ = name.rsplit(".", 2)
        block = model.get_submodule(owner)
        if isinstance(block, Attention):
            C = block.proj.weight.shape[0]
            ci = C // T
            if block.num_heads % T or (tiles and ci % 64):
                continue
            cols = own(C)
            idx = torch.cat([cols + i * C for i in range(3)]) \
                if layer == "qkv" else cols
        elif isinstance(block, Mlp):
            hidden = block.fc1.weight.shape[0]
            if hidden % T or (tiles and (hidden // T) % 64):
                continue
            idx = own(hidden)
        else:
            if t.shape[dim] % T:
                continue
            idx = own(t.shape[dim])
        plan[name] = (dim, idx)
    for head, bn in (("head", "bn"), ("head", "bn1")):
        if f"{head}.fc1.weight" in plan and hasattr(
                model.get_submodule(head), bn):
            idx = plan[f"{head}.fc1.weight"][1]
            for key in ("weight", "bias", "running_mean", "running_var"):
                plan[f"{head}.{bn}.{key}"] = (0, idx)
    return plan


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Leave this model rank the shards ``_tp_plan`` gives it (the same
    Parameter and buffer objects, so an optimizer made before keeps them)
    and mark the model tensor-parallel: its pairs then run on the shards
    and all-reduce over ``mesh.model_group`` (``parallel/tensor.py``: the
    TP modes of the block kernels in the bf16 and stream tiers, the W8A8
    pair on shards in the W8A8 tiers, the halves without their residual
    under dropout and drop-path), and an action or mesh model's head runs
    its column- and row-parallel layers on its slices; its ``state_dict()``
    gathers whole tensors and its ``load_state_dict`` takes whole ones. A
    pair whose heads or hidden width do not divide over the model axis (or,
    on the card, whose shards are not whole 64-column tiles), and a head
    layer whose width does not divide, stays whole and warns once. On a
    grid without a model axis (n_model 1) the model is returned as it is,
    for any model. Covered: the DSTformer, and the ActionNet (classifier
    and embedding) and MeshRegressor on it, in every attn_impl tier, with
    any dropout or drop-path rate; not covered, raising ValueError that
    names it (``models.dstformer.tensor_parallel_gaps``): attention dropout,
    a stage_para block, a model already sharded. Call it on a whole model,
    after loading its weights or before, on every rank of the grid."""
    from motionbert_tpu_torch.models.dstformer import tensor_parallel_gaps
    from motionbert_tpu_torch.parallel.tensor import HeadPlan, TpPlan

    if mesh is None or mesh.n_model == 1:
        return model
    gaps = tensor_parallel_gaps(model)
    if gaps:
        raise ValueError("tensor parallelism (n_model > 1) is not ported for "
                         + "; ".join(gaps))
    plan = _tp_plan(model, mesh)
    backbone = getattr(model, "backbone", model)
    prefix = "backbone." if backbone is not model else ""
    attn, mlp = (any(n.startswith(prefix + "blocks") and key in n
                     for n in plan) for key in (".qkv.", ".fc1."))
    whole = [half for half, sharded in (("the pairs' attention heads", attn),
                                        ("the pairs' MLP hidden width", mlp))
             if not sharded]
    head = getattr(model, "head", None) if backbone is not model else None
    if head is not None:
        whole += [f"the head's {layer}" for layer in ("fc1", "fc2")
                  if hasattr(head, layer) and f"head.{layer}.weight"
                  not in plan]
    for what in whole:
        warnings.warn(f"{what} does not divide over {mesh.n_model} model "
                      f"ranks: those weights stay whole on every rank",
                      stacklevel=2)
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    with torch.no_grad():
        for name, (dim, idx) in plan.items():
            t = tensors[name]
            t.data = t.data.index_select(dim, idx.to(t.device)).contiguous()
            t.grad = None
    heads = backbone.blocks_st[0].num_heads
    group = mesh.model_group
    tp = TpPlan(group if attn else None, group if mlp else None,
                heads // mesh.n_model if attn else heads, mesh.model_index)
    for blk in (*backbone.blocks_st, *backbone.blocks_ts):
        blk.tp = tp
    if head is not None:
        head.tp = HeadPlan(*(group if f"head.{layer}.weight" in plan else None
                             for layer in ("fc1", "fc2")),
                           mesh.n_model, mesh.model_index)
    model.tp_mesh, model.tp_plan = mesh, plan
    model.register_state_dict_post_hook(_gather_hook)
    model.register_load_state_dict_pre_hook(_shard_hook)
    return model


def _gather(t: torch.Tensor, dim: int, idx: torch.Tensor,
            mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which every model rank holds the entries ``idx``
    (its own) along ``dim``: each rank's shard in a zero tensor, summed over
    the model group (exact: one value and zeros per element; all-reduce is
    the collective gloo also runs on CUDA tensors)."""
    shape = list(t.shape)
    shape[dim] *= mesh.n_model
    full = t.new_zeros(shape).index_copy_(dim, idx.to(t.device), t.detach())
    dist.all_reduce(full, group=mesh.model_group)
    return full


def gather_named(model: torch.nn.Module, tensors: dict) -> dict:
    """Whole tensors from a dict keyed by the model's parameter names (its
    weights, or their gradients): each sharded one gathered over the model
    group (every model rank calls it), the others as they are."""
    plan = getattr(model, "tp_plan", {})
    return {k: _gather(v, *plan[k], model.tp_mesh) if k in plan else v
            for k, v in tensors.items()}


def _gather_hook(module, state_dict, prefix, local_metadata) -> None:
    mine = {k[len(prefix):]: state_dict[k] for k in list(state_dict)
            if k.startswith(prefix) and k[len(prefix):] in module.tp_plan}
    for name, t in gather_named(module, mine).items():
        state_dict[prefix + name] = t


def _shard_hook(module, state_dict, prefix, *args) -> None:
    """load_state_dict of whole tensors into a sharded model: each keeps
    this rank's shard."""
    params = {**dict(module.named_parameters()),
              **dict(module.named_buffers())}
    for name, (dim, idx) in module.tp_plan.items():
        t = state_dict.get(prefix + name)
        if t is not None and t.shape[dim] != params[name].shape[dim]:
            state_dict[prefix + name] = t.index_select(dim, idx.to(t.device))


def gather_params(model: torch.nn.Module) -> dict:
    """The model's whole state_dict on every rank: for a sharded model its
    ``state_dict()`` gathers each shard over the model group (every model
    rank calls it), else the state_dict itself."""
    return model.state_dict()


def _optimizer_shards(optimizer, model) -> dict:
    """{index in the optimizer's state_dict: (dim, idx)} of the sharded
    parameters an optimizer holds."""
    plan = getattr(model, "tp_plan", {})
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: plan[names[id(p)]] for i, p in enumerate(params)
            if names.get(id(p)) in plan}


def gather_optimizer_state(optimizer, model) -> dict:
    """The optimizer's state_dict with each sharded parameter's state
    (AdamW's moments) gathered whole, as ``gather_params`` gathers the
    weights; the state_dict itself for a model that is not sharded."""
    state = optimizer.state_dict()
    shards = _optimizer_shards(optimizer, model)
    for i, (dim, idx) in shards.items():
        if i in state["state"]:
            state["state"][i] = {
                k: _gather(v, dim, idx, model.tp_mesh) if v.dim() else v
                for k, v in state["state"][i].items()}
    return state


def shard_optimizer_state(state: dict, optimizer, model) -> dict:
    """A gathered optimizer state_dict (``gather_optimizer_state``, a
    checkpoint's) cut to this model rank's shards, for ``optimizer`` over
    the sharded ``model``'s parameters; unchanged for a model that is not
    sharded."""
    shards = _optimizer_shards(optimizer, model)
    out = {**state, "state": dict(state["state"])}
    for i, (dim, idx) in shards.items():
        if i in out["state"]:
            out["state"][i] = {
                k: v.index_select(dim, idx.to(v.device)) if v.dim() else v
                for k, v in out["state"][i].items()}
    return out
