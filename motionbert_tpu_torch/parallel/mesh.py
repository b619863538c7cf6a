"""Data parallelism over ``torch.distributed``: process groups, the rank's
rows of a global batch, padded evaluation batches, gathers, and the DDP
wrap.

The port of ``motionbert_tpu/parallel/mesh.py``'s data axis
(``make_mesh``, ``shard_batch``, ``padded_eval_batches``) in PyTorch idiom:
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

Tensor parallelism (the JAX package's ``_TP_RULES``, ``n_model > 1``) is
not ported. With no process group every function here is the one-process
identity, and the single-process paths keep their bits.
"""

from __future__ import annotations

import argparse
import os
import random
from datetime import timedelta
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

# how long a collective, and the group's start-up, may wait for a rank
TIMEOUT = timedelta(minutes=10)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


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
    array or tensor, or a tuple, list or dict of them, each with B rows. B
    must divide over the W ranks (``motionbert_tpu/train/pose3d.py``'s
    assert)."""
    W = world_size()
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
    return batch[rank() * b:(rank() + 1) * b]


def check_batch_size(batch_size: int) -> None:
    """A batch must split evenly over the ranks."""
    if batch_size % world_size():
        raise ValueError(f"batch_size {batch_size} does not divide over "
                         f"{world_size()} ranks")


def rank_batches(loader, device):
    """The rank's rows of each batch of a train loader, on ``device``
    (``data.datasets.device_prefetch``)."""
    from motionbert_tpu_torch.data.datasets import device_prefetch

    return device_prefetch((rank_rows(b) for b in loader), device)


def rank_draw(draw, shape, generator: torch.Generator) -> torch.Tensor:
    """``draw(shape, generator)`` for a draw whose leading axis is the batch:
    the draw at the global batch's shape (``shape[0] * W`` rows), and the
    rank's rows of it. Every rank draws the same numbers, so the generators
    advance alike and the masks do not depend on the world size."""
    W = world_size()
    if W == 1:
        return draw(shape, generator)
    b = shape[0]
    full = draw((b * W,) + tuple(shape[1:]), generator)
    return full[rank() * b:(rank() + 1) * b]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows in rank order: the (W * b, ...) global batch of an
    (b, ...) tensor, on every rank, differentiable. The rows go into a zero
    tensor of the global shape that ``torch.distributed.nn.functional``'s
    all-reduce sums over the ranks (exact: each element is one rank's value
    plus zeros). Its backward sums the global gradient over the ranks, so a
    loss computed on every rank from the gathered rows, its gradients
    averaged by DDP, has the one-process gradient: the all-reduce multiplies
    by W and DDP divides by it. All-reduce is the one collective that gloo
    also runs on CUDA tensors."""
    W = world_size()
    if W == 1:
        return x
    b = x.shape[0]
    full = x.new_zeros((W * b,) + tuple(x.shape[1:]))
    full[rank() * b:(rank() + 1) * b] = x
    return all_reduce_sum(full)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks, differentiable (its gradient is summed
    over the ranks too); x itself with no group."""
    if world_size() == 1:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x)


def mean_over_ranks(terms: dict) -> dict:
    """The mean over the ranks of 0-d tensors (the loss terms of the rank's
    rows): the global batch's terms where each is a mean over its rows.
    One all-reduce for the lot."""
    W = world_size()
    if W == 1:
        return terms
    keys = list(terms)
    stacked = torch.stack([terms[k].detach().float() for k in keys])
    dist.all_reduce(stacked)
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
    is started (even of one rank), else the model itself. ``ignore``: the
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
                                   broadcast_buffers=False)
