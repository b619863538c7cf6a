"""Tensor-parallel attention + MLP pairs: the pose3d model's pairs on a model
rank's head group and hidden slice, with the fp32 partials summed over the
model group.

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
embeddings, the LayerNorms, the output biases, the gates, the head) gets
the same gradient on every model rank.

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

# impl -> (attention forward, its backward, MLP forward, its backward,
# LayerNorm backward)
TP_IMPLS = {
    "kernel": (fused_attention_block_tp, fused_attention_block_tp_bwd,
               fused_mlp_block_tp, fused_mlp_block_tp_bwd, fused_ln_bwd),
    "plain": (attention_block_tp_plain, attention_block_tp_bwd_plain,
              mlp_block_tp_plain, mlp_block_tp_bwd_plain, ln_bwd_plain),
}


class TpPlan(NamedTuple):
    """A block's tensor-parallel plan: the model group of its attention
    halves and of its MLP halves (None: that half is whole on every rank)
    and its attention's local head count."""

    attn_group: Optional[object]
    mlp_group: Optional[object]
    heads: int


def all_reduce_model(t: torch.Tensor, group) -> torch.Tensor:
    """t summed in place over the model group (nothing with None)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class TpAttentionHalf(torch.autograd.Function):
    """y = bf16(sum over the model ranks of B4_tp + bproj + x)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, heads, scale,
                mode, group, impl):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, wproj)
        ctx.cfg = (heads, scale, mode, group, impl, bproj.dtype)
        a = TP_IMPLS[impl][0](x, ln_w, ln_b, wqkv, bqkv, wproj, heads, scale,
                              mode)
        return ((all_reduce_model(a, group) + wide(bproj))
                + wide(x)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, wqkv, bqkv, wproj = ctx.saved_tensors
        heads, scale, mode, group, impl, bias_dtype = ctx.cfg
        _, bwd, _, _, ln_bwd = TP_IMPLS[impl]
        g = g.contiguous()
        dwqkv, dbqkv, dwproj, dh, stats = bwd(x, g, ln_w, ln_b, wqkv, bqkv,
                                              wproj, heads, scale, mode)
        dx, dln_w, dln_b = ln_bwd(all_reduce_model(dh, group), x, stats, ln_w,
                                  g)
        dbproj = rows(g).sum(0).to(bias_dtype)
        return (dx, dln_w, dln_b, dwqkv, dbqkv, dwproj, dbproj, None, None,
                None, None, None)


class TpMlpHalf(torch.autograd.Function):
    """out = bf16(sum over the model ranks of B6_tp + b2 + y)."""

    @staticmethod
    def forward(ctx, y, ln_w, ln_b, w1, b1, w2, b2, group, impl):
        ctx.save_for_backward(y, ln_w, ln_b, w1, b1, w2)
        ctx.cfg = (group, impl, b2.dtype)
        b = TP_IMPLS[impl][2](y, ln_w, ln_b, w1, b1, w2)
        return ((all_reduce_model(b, group) + wide(b2)) + wide(y)).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        y, ln_w, ln_b, w1, b1, w2 = ctx.saved_tensors
        group, impl, bias_dtype = ctx.cfg
        _, _, _, bwd, ln_bwd = TP_IMPLS[impl]
        g = g.contiguous()
        dw1, db1, dw2, dh, stats = bwd(y, g, ln_w, ln_b, w1, b1, w2)
        dy, dln_w, dln_b = ln_bwd(all_reduce_model(dh, group), y, stats, ln_w,
                                  g)
        db2 = rows(g).sum(0).to(bias_dtype)
        return dy, dln_w, dln_b, dw1, db1, dw2, db2, None, None


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
