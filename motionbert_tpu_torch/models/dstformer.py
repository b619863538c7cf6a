"""DSTformer, the MotionBERT backbone, in PyTorch.

The port of ``motionbert_tpu/models/dstformer.py`` on its pair path
(reference DSTformer.py:269-361), for inference and training. Input (B, F, J, 3) is embedded, gets a
spatial pos-embed (1, J, C) and a temporal embed (1, maxlen, 1, C) cut to F,
and passes ``depth`` dual blocks. In each, the S->T stream runs the spatial
then the temporal attention+MLP pair, the T->S stream the temporal then the
spatial pair, and the learned per-channel softmax gate ``ts_attn`` mixes the
two. Each pair runs as one ``fused_pair_block`` call, and the T->S stream's
last pair carries the gate (``fused_gated_pair_block``). ``attn_impl`` picks
the pair functions (``PAIR_IMPLS``): the bf16 kernels, the W8A8 int8 kernels
of the serving tier, or the plain version of either, on the same parameters.
Then LayerNorm -> pre_logits (Linear + Tanh) -> head.

Dropout and drop-path (``drop_rate``, ``drop_path_rate``) are live only in
training mode with gradients enabled. A block whose rates are both 0 stays
on the pair path; the others run each residual on its own,
``x + droppath(dropout(attention_block(x)))`` then
``x + droppath(mlp(LN x))``, through ``fused_attention_block`` and
``fused_mlp_block`` (``BLOCK_IMPLS``), with the att_fuse gate in plain
PyTorch after the stream. Drop-path rates rise linearly over the layers from
0, so layer 0 keeps the pair path unless ``drop_rate`` is set. Every random
draw comes from the ``torch.Generator`` passed to ``forward``, as fp32
uniforms on the generator's device, so the masks depend on neither the
compute dtype nor ``attn_impl``. Attention-weight dropout
(``attn_drop_rate``) is not implemented, as in the JAX package: training
with it raises.

Module and parameter names are the reference PyTorch ones, so a MotionBERT
state_dict loads with ``load_state_dict(strict=True)``. Parameters stay
fp32; ``compute_dtype`` (bf16 on the card) sets the activation dtype, with
LayerNorm and softmax statistics in fp32. Gradients flow through the pair
and block Functions (``ops/fused_pair.py``, ``ops/attention.py``,
``ops/fused_mlp.py``): on the card through the hand-written backward kernels.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from motionbert_tpu_torch.ops.attention import (
    attention_block_plain, fused_attention_block, layer_norm, linear, wide)
from motionbert_tpu_torch.ops.fused_mlp import fused_mlp_block, mlp_block_plain
from motionbert_tpu_torch.ops.fused_pair import (
    fused_gated_pair_block, fused_pair_block, gate_plain,
    gated_pair_block_plain, pair_block_plain)
from motionbert_tpu_torch.ops.pair_q8 import (
    fused_gated_pair_block_q8, fused_pair_block_q8, gated_pair_block_q8_plain,
    pair_block_q8_plain)

# attn_impl -> (pair function, gated pair function). "kernel" goes through
# the wrappers (CUDA kernel on the card, plain version on the CPU); "plain"
# calls the plain versions directly, on any device, in any dtype. The "_q8"
# pairs are the W8A8 serving tier (ops/pair_q8.py) on the same parameters.
PAIR_IMPLS = {
    "kernel": (fused_pair_block, fused_gated_pair_block),
    "plain": (pair_block_plain, gated_pair_block_plain),
    "kernel_q8": (fused_pair_block_q8, fused_gated_pair_block_q8),
    "plain_q8": (pair_block_q8_plain, gated_pair_block_q8_plain),
}


# attn_impl -> (attention block, MLP block) of the path dropout and drop-path
# take. The W8A8 tier quantises only inside the pair kernels: its standalone
# blocks are the bf16 ones, as in the JAX package.
BLOCK_IMPLS = {
    "kernel": (fused_attention_block, fused_mlp_block),
    "plain": (attention_block_plain, mlp_block_plain),
    "kernel_q8": (fused_attention_block, fused_mlp_block),
    "plain_q8": (attention_block_plain, mlp_block_plain),
}


def _drop(x: torch.Tensor, mask_shape, rate: float,
          generator: torch.Generator) -> torch.Tensor:
    """x / keep where a Bernoulli(keep = 1 - rate) mask of ``mask_shape``
    holds, else 0. The mask comes from fp32 uniforms on the generator's
    device, whatever the dtype of x."""
    keep = 1.0 - rate
    mask = torch.rand(mask_shape, generator=generator, device=generator.device,
                      dtype=torch.float32) < keep
    return torch.where(mask, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate and
    divided by it. generator None (evaluation) or rate 0 returns x."""
    if rate == 0.0 or generator is None:
        return x
    return _drop(x, x.shape, rate, generator)


class DropPath(nn.Module):
    """Stochastic depth: the residual branch is dropped per (clip, frame),
    mask shape (B, F, 1, 1), and the kept ones divided by the keep
    probability (the reference blocks run on (B*F, J, C), so its per-sample
    mask is per clip and frame)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if self.rate == 0.0 or generator is None:
            return x
        shape = tuple(x.shape[:2]) + (1,) * (x.dim() - 2)
        return _drop(x, shape, self.rate, generator)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """nn.Linear in x's dtype (parameters cast on the way)."""
    return nn.functional.linear(x, layer.weight.to(x.dtype),
                                layer.bias.to(x.dtype))


class Attention(nn.Module):
    """One attention sub-block (reference DSTformer.py:88-110): ``qkv`` packs
    [q | k | v], each H heads of d. The pair path reads only the parameters;
    ``forward`` is the standalone block of the dropout / drop-path path."""

    def __init__(self, dim: int, proj_drop: float = 0.0):
        super().__init__()
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = float(proj_drop)

    def forward(self, x: torch.Tensor, ln: nn.LayerNorm, num_heads: int,
                scale: float, mode: str, attn_impl: str,
                generator=None) -> torch.Tensor:
        """dropout(proj(attn(qkv(LN x)))), without the residual."""
        dt = x.dtype
        block_fn = BLOCK_IMPLS[attn_impl][0]
        out = block_fn(x, ln.weight, ln.bias, self.qkv.weight.to(dt),
                       self.qkv.bias.to(dt), self.proj.weight.to(dt),
                       self.proj.bias.to(dt), num_heads, scale, mode,
                       True, False)
        return dropout(out, self.proj_drop, generator)


class Mlp(nn.Module):
    """fc1 -> GELU -> drop -> fc2 -> drop (reference DSTformer.py:69-85).
    The pair path reads only the parameters; ``forward`` is the standalone
    block of the dropout / drop-path path."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = float(drop)

    def forward(self, x: torch.Tensor, attn_impl: str,
                generator=None) -> torch.Tensor:
        """x is the normalised stream. Without live dropout one
        ``fused_mlp_block``; with it the dropout between GELU and fc2 keeps
        the block out of the kernel, and it runs in plain PyTorch."""
        dt = x.dtype
        w1, b1 = self.fc1.weight.to(dt), self.fc1.bias.to(dt)
        w2, b2 = self.fc2.weight.to(dt), self.fc2.bias.to(dt)
        if self.drop == 0.0 or generator is None:
            C = x.shape[-1]
            ones = torch.ones(C, dtype=torch.float32, device=x.device)
            return BLOCK_IMPLS[attn_impl][1](x, ones, torch.zeros_like(ones),
                                             w1, b1, w2, b2, False, False)
        h = linear(x, w1, b1).to(dt)
        h = nn.functional.gelu(wide(h)).to(dt)
        h = dropout(h, self.drop, generator)
        h = linear(h, w2, b2).to(dt)
        return dropout(h, self.drop, generator)


class Block(nn.Module):
    """Pre-LN dual attention+MLP block (reference DSTformer.py:214-267).

    st_mode "stage_st": spatial pair then temporal pair; "stage_ts": the
    reverse order. ``drop`` is the dropout rate after the attention
    projection and inside the MLP, ``drop_path`` the stochastic-depth rate
    of every residual of the block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 st_mode: str, attn_impl: str = "kernel", drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        if st_mode not in ("stage_st", "stage_ts"):
            raise NotImplementedError(f"st_mode {st_mode!r} is not ported")
        if attn_impl not in PAIR_IMPLS:
            raise ValueError(f"attn_impl must be one of {sorted(PAIR_IMPLS)}, "
                             f"got {attn_impl!r}")
        self.st_mode = st_mode
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.attn_impl = attn_impl
        self.drop = float(drop)
        self.attn_drop = float(attn_drop)
        hidden = int(dim * mlp_ratio)
        self.norm1_s = nn.LayerNorm(dim, eps=1e-6)
        self.norm1_t = nn.LayerNorm(dim, eps=1e-6)
        self.norm2_s = nn.LayerNorm(dim, eps=1e-6)
        self.norm2_t = nn.LayerNorm(dim, eps=1e-6)
        self.attn_s = Attention(dim, proj_drop=drop)
        self.attn_t = Attention(dim, proj_drop=drop)
        self.mlp_s = Mlp(dim, hidden, drop=drop)
        self.mlp_t = Mlp(dim, hidden, drop=drop)
        self.droppath = DropPath(drop_path)

    def _pair_params(self, axis: str, dtype: torch.dtype) -> list:
        attn = self.attn_s if axis == "s" else self.attn_t
        mlp = self.mlp_s if axis == "s" else self.mlp_t
        n1 = self.norm1_s if axis == "s" else self.norm1_t
        n2 = self.norm2_s if axis == "s" else self.norm2_t
        return [n1.weight, n1.bias, attn.qkv.weight.to(dtype),
                attn.qkv.bias.to(dtype),
                attn.proj.weight.to(dtype), attn.proj.bias.to(dtype),
                n2.weight, n2.bias, mlp.fc1.weight.to(dtype),
                mlp.fc1.bias.to(dtype), mlp.fc2.weight.to(dtype),
                mlp.fc2.bias.to(dtype)]

    def forward(self, x: torch.Tensor, gate=None,
                generator=None) -> torch.Tensor:
        """x (B, F, J, C) in the compute dtype. gate=(other, wg, bg): mix the
        result with the twin stream ``other`` through the att_fuse gate:
        inside the last pair's kernel on the pair path, in plain PyTorch
        otherwise. generator: the source of the dropout and drop-path masks;
        None means they are inactive (evaluation)."""
        order = ("s", "t") if self.st_mode == "stage_st" else ("t", "s")
        stochastic = generator is not None
        if stochastic and self.attn_drop > 0:
            raise NotImplementedError(
                f"attn_drop_rate={self.attn_drop} is not supported for "
                f"training; set it to 0 (every shipped config does)")
        if not stochastic or (self.drop == 0.0 and self.droppath.rate == 0.0):
            pair_fn, gated_fn = PAIR_IMPLS[self.attn_impl]
            for i, axis in enumerate(order):
                params = self._pair_params(axis, x.dtype)
                mode = "spatial" if axis == "s" else "temporal"
                if gate is not None and i == len(order) - 1:
                    other, wg, bg = gate
                    return gated_fn(x, other, *params, wg, bg, self.num_heads,
                                    self.scale, mode)
                x = pair_fn(x, *params, self.num_heads, self.scale, mode)
            return x
        for axis in order:
            attn = self.attn_s if axis == "s" else self.attn_t
            mlp = self.mlp_s if axis == "s" else self.mlp_t
            ln1 = self.norm1_s if axis == "s" else self.norm1_t
            ln2 = self.norm2_s if axis == "s" else self.norm2_t
            mode = "spatial" if axis == "s" else "temporal"
            x = x + self.droppath(
                attn(x, ln1, self.num_heads, self.scale, mode, self.attn_impl,
                     generator), generator)
            x = x + self.droppath(
                mlp(layer_norm(x, ln2.weight, ln2.bias), self.attn_impl,
                    generator), generator)
        if gate is not None:
            other, wg, bg = gate
            x = gate_plain(other, x, wg, bg)
        return x


class DSTformer(nn.Module):
    """The MotionBERT backbone. Input (B, F, J, dim_in) -> (B, F, J, dim_out),
    or the (B, F, J, dim_rep) motion representation with return_rep=True.
    Outputs are in ``compute_dtype``. Layer i of ``depth`` gets the drop-path
    rate ``linspace(0, drop_path_rate, depth)[i]`` (reference
    DSTformer.py:279)."""

    def __init__(self, dim_in: int = 3, dim_out: int = 3, dim_feat: int = 256,
                 dim_rep: int = 512, depth: int = 5, num_heads: int = 8,
                 mlp_ratio: float = 4.0, num_joints: int = 17,
                 maxlen: int = 243, attn_impl: str = "kernel",
                 compute_dtype: torch.dtype = torch.float32,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.drop_rate = float(drop_rate)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        # whether training draws any mask (a depth-1 model's only drop-path
        # rate is 0)
        self.stochastic = any(r > 0 for r in (drop_rate, attn_drop_rate, *dpr))
        self.joints_embed = nn.Linear(dim_in, dim_feat)
        kw = dict(dim=dim_feat, num_heads=num_heads, mlp_ratio=mlp_ratio,
                  attn_impl=attn_impl, drop=drop_rate, attn_drop=attn_drop_rate)
        self.blocks_st = nn.ModuleList(
            Block(st_mode="stage_st", drop_path=dpr[i], **kw)
            for i in range(depth))
        self.blocks_ts = nn.ModuleList(
            Block(st_mode="stage_ts", drop_path=dpr[i], **kw)
            for i in range(depth))
        self.norm = nn.LayerNorm(dim_feat, eps=1e-6)
        self.pre_logits = nn.Sequential(OrderedDict([
            ("fc", nn.Linear(dim_feat, dim_rep)), ("act", nn.Tanh())]))
        self.head = nn.Linear(dim_rep, dim_out)
        self.temp_embed = nn.Parameter(torch.zeros(1, maxlen, 1, dim_feat))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_joints, dim_feat))
        self.ts_attn = nn.ModuleList(
            nn.Linear(dim_feat * 2, 2) for _ in range(depth))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DSTformer":
        """The reference initialisation (DSTformer.py:302-323): truncated
        normal std 0.02 for Linear weights and the embeddings, zero biases,
        unit LayerNorms, and the gate's zero weight / 0.5 bias. The draws
        are made on the CPU from ``generator`` (a CPU generator), so a seed
        gives the same weights on every device."""
        def tn(t):
            cpu = torch.empty(t.shape, dtype=t.dtype)
            t.copy_(nn.init.trunc_normal_(cpu, std=0.02, a=-2.0, b=2.0,
                                          generator=generator))

        for m in self.modules():
            if isinstance(m, nn.Linear):
                tn(m.weight)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        tn(self.temp_embed)
        tn(self.pos_embed)
        for lin in self.ts_attn:
            nn.init.zeros_(lin.weight)
            nn.init.constant_(lin.bias, 0.5)
        return self

    def forward(self, x: torch.Tensor, return_rep: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        """generator: the source of the dropout and drop-path masks, on the
        model's device. It is read only in training mode with gradients
        enabled and a rate above 0, and must be given then; evaluation runs
        the pair path whatever the rates."""
        if self.stochastic and self.training and torch.is_grad_enabled():
            if generator is None:
                raise ValueError(
                    "training with dropout or drop-path needs forward("
                    "generator=...), a torch.Generator on the model's device")
        else:
            generator = None
        F = x.shape[1]
        dt = self.compute_dtype
        x = _linear(x.to(dt), self.joints_embed)
        x = x + self.pos_embed.to(dt)
        x = x + self.temp_embed[:, :F].to(dt)
        x = dropout(x, self.drop_rate, generator)
        for blk_st, blk_ts, gate in zip(self.blocks_st, self.blocks_ts,
                                        self.ts_attn):
            x_st = blk_st(x, generator=generator)
            x = blk_ts(x, gate=(x_st, gate.weight.to(dt), gate.bias.to(dt)),
                       generator=generator)
        x = layer_norm(x, self.norm.weight, self.norm.bias)
        x = torch.tanh(_linear(x, self.pre_logits.fc))
        if return_rep:
            return x
        return _linear(x, self.head)

    def get_representation(self, x: torch.Tensor) -> torch.Tensor:
        return self(x, return_rep=True)
