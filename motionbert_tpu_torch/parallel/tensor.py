"""Tensor parallelism on the model ranks of a ("data", "model") grid: the
DSTformer's pairs on a rank's head group and hidden slice, with the partials
summed over the model group, the W8A8 pair on shards, the residual-free
halves of the dropout path, and Megatron's operators for the heads.

For rank r of T, x replicated (the same on every model rank):

    a_r = B4_tp(x; LN1, Wqkv_r, bqkv_r, Wproj_r)    fp32 partial
    y   = bf16(all-reduce(a) + bproj + x)
    b_r = B6_tp(y; LN2, W1_r, b1_r, W2_r)            fp32 partial
    out = bf16(all-reduce(b) + b2 + y)

then, for the T->S stream's last pair, the att_fuse gate in plain PyTorch
(``ops.fused_pair.gate_plain``, its backward ``gate_bwd_plain`` at B3's
rounding points). These are the single-device pair's
rounding points (B1 writes bf16(fp32 product + bias + x)); only the order of
the fp32 sums differs. The backward of each half takes the replicated output
gradient g: B5_tp / B7_tp give this rank's weight and bias shard gradients
and its part of the fp32 gradient at the LayerNorm's output dh; dh is
all-reduced in fp32, and ``fused_ln_bwd`` writes dx = bf16(LN-backward(dh) +
g) and the LayerNorm's gradients, identical on every model rank; the output
bias's gradient is the sum of g over rows, once, on the replicated side.
These are B3's and ``input_grad``'s rounding points.

Each half is one ``torch.autograd.Function`` holding Megatron's two
operators: "reduce" (all-reduce in the forward, identity in the backward)
on its output partial, and "copy" (identity in the forward, all-reduce in
the backward) on its LayerNorm's output, fused into the half because that
gradient must stay fp32 up to the LayerNorm backward, and autograd casts a
gradient to its input's dtype (bf16 here). Everything replicated (the
embeddings, the LayerNorms, the output biases, the gates) gets the same
gradient on every model rank.

What runs on shards:

- the pairs of every tier: the bf16 halves above for attn_impl "kernel",
  "plain" and "kernel_stream" (the whole-stream kernel B10 spans both pairs
  in one launch, and each pair needs its two reductions between its halves,
  so on a grid the stream's pairs run as pairs and B10 launches nothing),
  and the W8A8 pair on shards (``TpPairsQ8``: B9_tp,
  ``ops.pair_q8.fused_pair_block_q8_tp``, whose output is the unsharded
  W8A8 pair's bit for bit; the backward the bf16 halves', straight-through,
  as the unsharded W8A8 pair's is the bf16 pair's) for "kernel_q8",
  "plain_q8" and "kernel_stream_q8";
- dropout and drop-path: the halves without the residual (``residual``
  False: the branch bf16(all-reduce(partial) + bias), and a LayerNorm
  backward that leaves g out), to which the block adds
  x + droppath(dropout(branch)); with the MLP's own dropout live, the MLP
  runs fc1 -> GELU -> dropout -> fc2 in plain PyTorch on the rank's slice
  (``tp_mlp_dropout``), its mask drawn at the full hidden width and cut to
  the rank's columns, so a grid draws a 1 x 1 run's masks;
- the heads of the action and mesh models, through ``copy_to_model``
  (identity forward, all-reduce backward: on the input of a column-parallel
  layer, so that the backbone gets the whole gradient), ``reduce_from_model``
  (all-reduce forward, identity backward: on a row-parallel partial) and
  ``gather_from_model`` (the model ranks' column slices side by side; its
  backward keeps the rank's slice), by the plan in ``HeadPlan``.

A half whose group is None (its heads or hidden width do not divide over
the model axis, ``parallel.mesh.shard_params``) runs on whole weights on
every rank without a collective. ``impl`` "kernel" takes the wrappers (the
CUDA chains on the card, the plain twins on the CPU), "plain" the plain
twins on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from motionbert_tpu_torch.ops.attention import (
    attention_block_tp_bwd_plain, attention_block_tp_plain,
    fused_attention_block_tp, fused_attention_block_tp_bwd, fused_ln_bwd,
    ln_bwd_plain, rows, wide)
from motionbert_tpu_torch.ops.fused_mlp import (
    fused_mlp_block_tp, fused_mlp_block_tp_bwd, mlp_block_tp_bwd_plain,
    mlp_block_tp_plain)
from motionbert_tpu_torch.ops.fused_pair import gate_bwd_plain, gate_plain
from motionbert_tpu_torch.ops.pair_q8 import (
    fused_pair_block_q8_tp, pair_block_q8_tp_plain)

# impl -> (attention forward, its backward, MLP forward, its backward,
# LayerNorm backward, the W8A8 pair on shards)
TP_IMPLS = {
    "kernel": (fused_attention_block_tp, fused_attention_block_tp_bwd,
               fused_mlp_block_tp, fused_mlp_block_tp_bwd, fused_ln_bwd,
               fused_pair_block_q8_tp),
    "plain": (attention_block_tp_plain, attention_block_tp_bwd_plain,
              mlp_block_tp_plain, mlp_block_tp_bwd_plain, ln_bwd_plain,
              pair_block_q8_tp_plain),
}

# attn_impl -> (TP impl, W8A8): what a model's tier runs on shards
TIER_IMPLS = {
    "kernel": ("kernel", False), "plain": ("plain", False),
    "kernel_q8": ("kernel", True), "plain_q8": ("plain", True),
    "kernel_stream": ("kernel", False), "kernel_stream_q8": ("kernel", True),
}


class TpPlan(NamedTuple):
    """A block's tensor-parallel plan: the model group of its attention
    halves and of its MLP halves (None: that half is whole on every rank),
    its attention's local head count, and the rank's index on the model
    axis (its hidden slice's place)."""

    attn_group: Optional[object]
    mlp_group: Optional[object]
    heads: int
    index: int = 0


class HeadPlan(NamedTuple):
    """A head's tensor-parallel plan: the model group of its column-parallel
    fc1 and of its row-parallel fc2 (None: that layer is whole), the model
    axis's size and the rank's index on it."""

    fc1: Optional[object]
    fc2: Optional[object]
    n_model: int
    index: int


# a head with no plan: every layer whole, on one model rank
WHOLE_HEAD = HeadPlan(None, None, 1, 0)


def all_reduce_model(t: torch.Tensor, group) -> torch.Tensor:
    """t summed in place over the model group (nothing with None)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


# ---------------------------------------------------------------------------
# Megatron's operators
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_model(g.clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_model(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n_model, index):
        n = x.shape[-1]
        ctx.cols = (index * n, (index + 1) * n)
        full = x.new_zeros(tuple(x.shape[:-1]) + (n * n_model,))
        full[..., index * n:(index + 1) * n] = x
        return all_reduce_model(full, group)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.cols
        return g[..., lo:hi].contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x in the forward; in the backward the gradient summed over the model
    group (the input of a column-parallel layer). x itself with None."""
    return x if group is None else _Copy.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the model group in the forward (a row-parallel
    partial); the gradient as it is in the backward. x with None."""
    return x if group is None else _Reduce.apply(x, group)


def gather_from_model(x: torch.Tensor, group, n_model: int,
                      index: int) -> torch.Tensor:
    """The model ranks' slices of the last axis side by side, rank order
    (each rank's in a zero tensor, summed: exact; all-reduce is the
    collective gloo also runs on CUDA tensors); the backward keeps the
    rank's slice of the gradient. x with None."""
    if group is None:
        return x
    return _Gather.apply(x, group, n_model, index)


# ---------------------------------------------------------------------------
# the pairs' halves
# ---------------------------------------------------------------------------

def _attn_fwd(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, heads, scale, mode,
              group, impl, residual=True) -> torch.Tensor:
    a = TP_IMPLS[impl][0](x, ln_w, ln_b, wqkv, bqkv, wproj, heads, scale,
                          mode)
    out = all_reduce_model(a, group) + wide(bproj)
    return (out + wide(x) if residual else out).to(x.dtype)


def _attn_bwd(g, x, ln_w, ln_b, wqkv, bqkv, wproj, heads, scale, mode, group,
              impl, bias_dtype, residual=True) -> tuple:
    """(dx, dln_w, dln_b, dwqkv, dbqkv, dwproj, dbproj)."""
    _, bwd, _, _, ln_bwd, _ = TP_IMPLS[impl]
    dwqkv, dbqkv, dwproj, dh, stats = bwd(x, g, ln_w, ln_b, wqkv, bqkv, wproj,
                                          heads, scale, mode)
    dx, dln_w, dln_b = ln_bwd(all_reduce_model(dh, group), x, stats, ln_w,
                              g if residual else None)
    return (dx, dln_w, dln_b, dwqkv, dbqkv, dwproj,
            rows(g).sum(0).to(bias_dtype))


def _mlp_fwd(y, ln_w, ln_b, w1, b1, w2, b2, group, impl,
             residual=True) -> torch.Tensor:
    b = TP_IMPLS[impl][2](y, ln_w, ln_b, w1, b1, w2)
    out = all_reduce_model(b, group) + wide(b2)
    return (out + wide(y) if residual else out).to(y.dtype)


def _mlp_bwd(g, y, ln_w, ln_b, w1, b1, w2, group, impl, bias_dtype,
             residual=True) -> tuple:
    """(dy, dln_w, dln_b, dw1, db1, dw2, db2)."""
    _, _, _, bwd, ln_bwd, _ = TP_IMPLS[impl]
    dw1, db1, dw2, dh, stats = bwd(y, g, ln_w, ln_b, w1, b1, w2)
    dy, dln_w, dln_b = ln_bwd(all_reduce_model(dh, group), y, stats, ln_w,
                              g if residual else None)
    return dy, dln_w, dln_b, dw1, db1, dw2, rows(g).sum(0).to(bias_dtype)


class TpAttentionHalf(torch.autograd.Function):
    """y = bf16(sum over the model ranks of B4_tp + bproj [+ x])."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, heads, scale,
                mode, group, impl, residual=True):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, wproj)
        ctx.cfg = (heads, scale, mode, group, impl, bproj.dtype, residual)
        return _attn_fwd(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, heads,
                         scale, mode, group, impl, residual)

    @staticmethod
    def backward(ctx, g):
        return (*_attn_bwd(g.contiguous(), *ctx.saved_tensors, *ctx.cfg),
                None, None, None, None, None, None)


class TpMlpHalf(torch.autograd.Function):
    """out = bf16(sum over the model ranks of B6_tp + b2 [+ y])."""

    @staticmethod
    def forward(ctx, y, ln_w, ln_b, w1, b1, w2, b2, group, impl,
                residual=True):
        ctx.save_for_backward(y, ln_w, ln_b, w1, b1, w2)
        ctx.cfg = (group, impl, b2.dtype, residual)
        return _mlp_fwd(y, ln_w, ln_b, w1, b1, w2, b2, group, impl, residual)

    @staticmethod
    def backward(ctx, g):
        return (*_mlp_bwd(g.contiguous(), *ctx.saved_tensors, *ctx.cfg),
                None, None, None)


class Gate(torch.autograd.Function):
    """The att_fuse gate on the replicated pair output (``gate_plain``),
    its backward ``gate_bwd_plain``: the rounding points of the gated pair
    kernels (B2, B3)."""

    @staticmethod
    def forward(ctx, other, out, wg, bg):
        ctx.save_for_backward(other, out, wg, bg)
        return gate_plain(other, out, wg, bg)

    @staticmethod
    def backward(ctx, g):
        return gate_bwd_plain(*ctx.saved_tensors[:2], g,
                              *ctx.saved_tensors[2:])


N_PAIR = 12   # a pair's parameters, in PAIR_PARAMS order


class TpPairsQ8(torch.autograd.Function):
    """W8A8 pairs on shards in a row, the last one gated against ``other``
    when other is given: B9_tp forwards, and the straight-through backward
    of the unsharded W8A8 pair (one pair) or stream (two) on shards: the
    bf16 TP pairs' backward at their bf16 inputs, each pair's input and y
    recomputed with the bf16 halves (and, gated, the last pair's output for
    the gate), as B3 and the stream's backward recompute them in bf16.
    params: N_PAIR tensors a pair, modes one a pair."""

    @staticmethod
    def forward(ctx, x, other, wg, bg, plan, scale, modes, impl, *params):
        ctx.save_for_backward(x, other, wg, bg, *params)
        ctx.cfg = (plan, scale, modes, impl)
        out = x
        for i, mode in enumerate(modes):
            last = i == len(modes) - 1
            out = TP_IMPLS[impl][5](
                out, other if last else None,
                *params[i * N_PAIR:(i + 1) * N_PAIR], wg if last else None,
                bg if last else None, plan.heads, scale, mode,
                plan.attn_group, plan.mlp_group)
        return out

    @staticmethod
    def backward(ctx, g):
        x, other, wg, bg, *params = ctx.saved_tensors
        plan, scale, modes, impl = ctx.cfg
        pairs = [params[i * N_PAIR:(i + 1) * N_PAIR]
                 for i in range(len(modes))]
        attn = lambda p, y, mode: _attn_fwd(
            y, *p[:6], plan.heads, scale, mode, plan.attn_group, impl)
        mlp = lambda p, y: _mlp_fwd(y, *p[6:], plan.mlp_group, impl)
        inputs = [x]
        for p, mode in zip(pairs[:-1], modes[:-1]):
            inputs.append(mlp(p, attn(p, inputs[-1], mode)))
        ys = [attn(p, xi, mode) for p, xi, mode in zip(pairs, inputs, modes)]
        dother = dwg = dbg = None
        g = g.contiguous()
        if other is not None:
            dother, g, dwg, dbg = gate_bwd_plain(other, mlp(pairs[-1], ys[-1]),
                                                 g, wg, bg)
            g = g.contiguous()
        grads = []
        for p, xi, y, mode in reversed(list(zip(pairs, inputs, ys, modes))):
            dy, *dmlp = _mlp_bwd(g, y, *p[6:11], plan.mlp_group, impl,
                                 p[11].dtype)
            g, *dattn = _attn_bwd(dy, xi, *p[:5], plan.heads, scale, mode,
                                  plan.attn_group, impl, p[5].dtype)
            grads = dattn + dmlp + grads
        return (g, dother, dwg, dbg, None, None, None, None, *grads)


def tp_q8_pairs(x, gate, pairs, plan: TpPlan, scale: float, modes,
                impl: str = "kernel") -> torch.Tensor:
    """W8A8 pairs on shards in a row (``TpPairsQ8``): pairs a list of each
    pair's 12 parameters, modes one a pair, gate (other, wg, bg) for the
    last pair, or None."""
    other, wg, bg = gate or (None, None, None)
    return TpPairsQ8.apply(x, other, wg, bg, plan, scale, tuple(modes), impl,
                           *(t for p in pairs for t in p))


def tp_pair(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1,
            w2, b2, plan: TpPlan, scale: float, mode: str,
            impl: str = "kernel") -> torch.Tensor:
    """One attention + MLP pair on this model rank's shards (the pair
    functions' arguments, with the plan in place of the head count),
    differentiable in x and every parameter."""
    y = TpAttentionHalf.apply(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                              plan.heads, scale, mode, plan.attn_group, impl)
    return TpMlpHalf.apply(y, ln2_w, ln2_b, w1, b1, w2, b2, plan.mlp_group,
                           impl)


def tp_gated_pair(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                  ln2_b, w1, b1, w2, b2, wg, bg, plan: TpPlan, scale: float,
                  mode: str, impl: str = "kernel") -> torch.Tensor:
    """``tp_pair`` followed by the att_fuse gate against ``other``, on the
    replicated output."""
    out = tp_pair(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                  w1, b1, w2, b2, plan, scale, mode, impl)
    return Gate.apply(other, out, wg, bg)


def tp_attention_branch(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                        plan: TpPlan, scale: float, mode: str,
                        impl: str = "kernel") -> torch.Tensor:
    """The attention half without the residual (B4's no-residual mode on
    shards): bf16(all-reduce(B4_tp) + bproj), differentiable."""
    return TpAttentionHalf.apply(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                 plan.heads, scale, mode, plan.attn_group,
                                 impl, False)


def tp_mlp_branch(y, ln_w, ln_b, w1, b1, w2, b2, plan: TpPlan,
                  impl: str = "kernel") -> torch.Tensor:
    """The MLP half without the residual: bf16(all-reduce(B6_tp) + b2)."""
    return TpMlpHalf.apply(y, ln_w, ln_b, w1, b1, w2, b2, plan.mlp_group,
                           impl, False)


def tp_mlp_dropout(h, w1, b1, w2, b2, plan: TpPlan, drop) -> torch.Tensor:
    """The MLP with its dropout live, on the rank's hidden slice, in plain
    PyTorch at ``models.dstformer.Mlp``'s rounding points: h the normalised
    stream (replicated), fc1 column-parallel (``copy_to_model`` on its fp32
    input), GELU, ``drop(a, cols)`` (the hidden dropout: its mask drawn at
    the full width, the rank's columns ``cols`` kept), fc2 row-parallel
    (``reduce_from_model``) plus its bias, then ``drop(out, None)``."""
    dt = h.dtype
    group = plan.mlp_group
    z = (torch.matmul(copy_to_model(wide(h), group), wide(w1).t())
         + wide(b1)).to(dt)
    a = torch.nn.functional.gelu(wide(z)).to(dt)
    n = w1.shape[0]
    a = drop(a, (plan.index * n, (plan.index + 1) * n) if group is not None
             else None)
    out = reduce_from_model(torch.matmul(wide(a), wide(w2).t()), group)
    return drop((out + wide(b2)).to(dt), None)
