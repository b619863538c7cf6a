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
of the serving tier, or the plain version of either, on the same parameters;
or the whole-stream kernels (``STREAM_IMPLS``, bf16 or W8A8), which run a
block's two pairs, and its gate, in one call per stream.
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

The legacy attention modes (reference DSTformer.py:112-176; no shipped config
builds them) are public modules here as in the JAX package: ``Attention``
with mode "vanilla", "series" or "parallel" runs the attention core alone
(``st_attention``, kernel B8 on the card) between projections in plain
PyTorch, "coupling" runs ``coupled_attention``, and ``Block(st_mode=
"stage_para")`` runs its two branches through the attention and MLP blocks
(B4, B6) with the LayerNorms outside them.

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
    attention_block_plain, coupled_attention, fused_attention_block,
    layer_norm, linear, st_attention, st_attention_plain, wide)
from motionbert_tpu_torch.ops.fused_mlp import fused_mlp_block, mlp_block_plain
from motionbert_tpu_torch.ops.fused_pair import (
    fused_gated_pair_block, fused_pair_block, gate_alpha, gate_plain,
    gated_pair_block_plain, pair_block_plain)
from motionbert_tpu_torch.ops.fused_stream import (
    fused_gated_stream_block, fused_gated_stream_block_q8, fused_stream_block,
    fused_stream_block_q8)
from motionbert_tpu_torch.ops.pair_q8 import (
    fused_gated_pair_block_q8, fused_pair_block_q8, gated_pair_block_q8_plain,
    pair_block_q8_plain)
from motionbert_tpu_torch.parallel.mesh import rank_draw

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

# attn_impl -> (stream function, gated stream function): the whole-stream
# kernel (ops/fused_stream.py), bf16 or W8A8, which runs both pairs of a
# block's stream, and the att_fuse gate of the T->S stream, in one call.
STREAM_IMPLS = {
    "kernel_stream": (fused_stream_block, fused_gated_stream_block),
    "kernel_stream_q8": (fused_stream_block_q8, fused_gated_stream_block_q8),
}
ATTN_IMPLS = tuple(PAIR_IMPLS) + tuple(STREAM_IMPLS)


# attn_impl -> (attention block, MLP block) of the path dropout and drop-path
# take. The W8A8 tier and the stream kernels quantise or fuse only on the
# pair path: their standalone blocks are the bf16 ones, as in the JAX package.
BLOCK_IMPLS = {
    "kernel": (fused_attention_block, fused_mlp_block),
    "plain": (attention_block_plain, mlp_block_plain),
    "kernel_q8": (fused_attention_block, fused_mlp_block),
    "plain_q8": (attention_block_plain, mlp_block_plain),
    "kernel_stream": (fused_attention_block, fused_mlp_block),
    "kernel_stream_q8": (fused_attention_block, fused_mlp_block),
}


# attn_impl -> the attention core of the legacy attention modes (vanilla,
# series, parallel): the B8 wrapper or its plain version. The JAX package's
# pallas, pallas_q8 and pallas_stream* all reach its Pallas core there.
CORE_IMPLS = {
    "kernel": st_attention,
    "plain": st_attention_plain,
    "kernel_q8": st_attention,
    "plain_q8": st_attention_plain,
    "kernel_stream": st_attention,
    "kernel_stream_q8": st_attention,
}

AXIS_MODES = ("spatial", "temporal")
ATTENTION_MODES = AXIS_MODES + ("vanilla", "series", "parallel", "coupling")


def uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """fp32 uniforms of ``shape`` on the generator's device."""
    return torch.rand(shape, generator=generator, device=generator.device,
                      dtype=torch.float32)


def _drop(x: torch.Tensor, mask_shape, rate: float,
          generator: torch.Generator) -> torch.Tensor:
    """x / keep where a Bernoulli(keep = 1 - rate) mask of ``mask_shape``
    holds, else 0. The mask comes from fp32 uniforms on the generator's
    device, whatever the dtype of x; its leading axis is the batch, drawn
    at the global batch's size under data parallelism
    (``parallel.mesh.rank_draw``)."""
    keep = 1.0 - rate
    mask = rank_draw(uniform, mask_shape, generator) < keep
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


def _gate_mix(x_s: torch.Tensor, x_t: torch.Tensor,
              logits: torch.Tensor) -> torch.Tensor:
    """The per-channel softmax gate of the parallel mode and of the
    stage_para block: logits (..., 2C) read as (C, 2), so channel 2c weighs
    x_s and 2c + 1 weighs x_t; fp32 softmax, weights and mix in x's dtype."""
    C = x_s.shape[-1]
    a = torch.softmax(wide(logits).reshape(*logits.shape[:-1], C, 2),
                      dim=-1).to(x_s.dtype)
    return x_t * a[..., 1] + x_s * a[..., 0]


class Attention(nn.Module):
    """One attention sub-block (reference DSTformer.py:88-200): ``qkv``
    packs [q | k | v], each H heads of d, then ``proj``. ``mode``:
    "spatial" (the joints of a frame) and "temporal" (the frames of a joint)
    run as one attention block (``BLOCK_IMPLS``); the legacy modes project in
    plain PyTorch around the attention core (``CORE_IMPLS``): "vanilla" is
    spatial attention, "series" spatial attention re-projected through the
    same ``qkv`` then temporal, "parallel" both axes on one projection mixed
    by a per-channel gate (``ts_attn``, Linear(2C, 2C), parallel mode only)
    on the joint-mean of [x_s, x_t], "coupling" all F*J tokens of a clip.
    The pair path reads only the parameters."""

    def __init__(self, dim: int, num_heads: int = 8, mode: str = "spatial",
                 attn_impl: str = "kernel", proj_drop: float = 0.0):
        super().__init__()
        if mode not in ATTENTION_MODES:
            raise NotImplementedError(f"attention mode {mode!r}; known: "
                                      f"{ATTENTION_MODES}")
        if attn_impl not in CORE_IMPLS:
            raise ValueError(f"attn_impl must be one of {sorted(CORE_IMPLS)}, "
                             f"got {attn_impl!r}")
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.mode = mode
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        if mode == "parallel":
            self.ts_attn = nn.Linear(dim * 2, dim * 2)
        self.proj_drop = float(proj_drop)

    def forward(self, x: torch.Tensor, ln: nn.LayerNorm = None,
                generator=None) -> torch.Tensor:
        """dropout(proj(attention(qkv([LN] x)))), without the residual; in a
        spatial or temporal mode the LayerNorm runs inside the block."""
        dt = x.dtype
        if self.mode in AXIS_MODES:
            ln_w, ln_b = (None, None) if ln is None else (ln.weight, ln.bias)
            out = BLOCK_IMPLS[self.attn_impl][0](
                x, ln_w, ln_b, self.qkv.weight.to(dt), self.qkv.bias.to(dt),
                self.proj.weight.to(dt), self.proj.bias.to(dt),
                self.num_heads, self.scale, self.mode, ln is not None, False)
            return dropout(out, self.proj_drop, generator)
        h = x if ln is None else layer_norm(x, ln.weight, ln.bias)
        out = _linear(self._attend(h), self.proj)
        return dropout(out, self.proj_drop, generator)

    def _split_qkv(self, h: torch.Tensor) -> tuple:
        C = h.shape[-1]
        qkv = _linear(h, self.qkv)
        return qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]

    def _attend(self, h: torch.Tensor) -> torch.Tensor:
        """The legacy modes between the two projections."""
        core = CORE_IMPLS[self.attn_impl]
        H, scale = self.num_heads, self.scale
        q, k, v = self._split_qkv(h)
        if self.mode == "vanilla":
            return core(q, k, v, "spatial", H, scale)
        if self.mode == "coupling":
            return coupled_attention(q, k, v, H, scale)
        if self.mode == "series":
            mid = core(q, k, v, "spatial", H, scale)
            return core(*self._split_qkv(mid), "temporal", H, scale)
        x_t = core(q, k, v, "temporal", H, scale)
        x_s = core(q, k, v, "spatial", H, scale)
        alpha = wide(torch.cat([x_s, x_t], -1)).mean(2, keepdim=True)
        return _gate_mix(x_s, x_t, _linear(alpha.to(h.dtype), self.ts_attn))


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
            return BLOCK_IMPLS[attn_impl][1](x, None, None, w1, b1, w2, b2,
                                             False, False)
        h = linear(x, w1, b1).to(dt)
        h = nn.functional.gelu(wide(h)).to(dt)
        h = dropout(h, self.drop, generator)
        h = linear(h, w2, b2).to(dt)
        return dropout(h, self.drop, generator)


class Block(nn.Module):
    """Pre-LN dual attention+MLP block (reference DSTformer.py:214-267).

    st_mode "stage_st": spatial pair then temporal pair; "stage_ts": the
    reverse order; "stage_para" (legacy): a temporal and a spatial branch
    side by side, each ``x + attn(LN x)`` then ``+ mlp(LN .)`` through the
    attention and MLP blocks with the LayerNorm outside them, mixed by the
    per-channel gate ``ts_attn`` (Linear(2C, 2C)) with ``att_fuse``, else
    averaged. ``drop`` is the dropout rate after the attention projection
    and inside the MLP, ``drop_path`` the stochastic-depth rate of every
    residual of the block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 st_mode: str, attn_impl: str = "kernel", drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 att_fuse: bool = False):
        super().__init__()
        if st_mode not in ("stage_st", "stage_ts", "stage_para"):
            raise NotImplementedError(f"st_mode {st_mode!r}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {sorted(ATTN_IMPLS)}, "
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
        kw = dict(num_heads=num_heads, attn_impl=attn_impl, proj_drop=drop)
        self.attn_s = Attention(dim, mode="spatial", **kw)
        self.attn_t = Attention(dim, mode="temporal", **kw)
        self.mlp_s = Mlp(dim, hidden, drop=drop)
        self.mlp_t = Mlp(dim, hidden, drop=drop)
        self.droppath = DropPath(drop_path)
        self.att_fuse = st_mode == "stage_para" and att_fuse
        if self.att_fuse:
            self.ts_attn = nn.Linear(dim * 2, dim * 2)

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
        if self.st_mode == "stage_para":
            if gate is not None:
                raise ValueError("the stage_para block takes no twin-stream "
                                 "gate")
            return self._stage_para(x, generator)
        if not stochastic or (self.drop == 0.0 and self.droppath.rate == 0.0):
            if self.attn_impl in STREAM_IMPLS:
                return self._stream(x, order, gate)
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
            x = x + self.droppath(attn(x, ln1, generator), generator)
            x = x + self.droppath(
                mlp(layer_norm(x, ln2.weight, ln2.bias), self.attn_impl,
                    generator), generator)
        if gate is not None:
            other, wg, bg = gate
            x = gate_plain(other, x, wg, bg)
        return x

    def _stream(self, x: torch.Tensor, order: tuple, gate) -> torch.Tensor:
        """Both pairs of the stream, and the gate, in one stream call."""
        stream_fn, gated_fn = STREAM_IMPLS[self.attn_impl]
        params = self._pair_params(order[0], x.dtype) \
            + self._pair_params(order[1], x.dtype)
        if gate is None:
            return stream_fn(x, *params, self.num_heads, self.scale, order)
        other, wg, bg = gate
        return gated_fn(x, other, *params, wg, bg, self.num_heads, self.scale,
                        order)

    def _stage_para(self, x: torch.Tensor, generator) -> torch.Tensor:
        branches = []
        for attn, mlp, ln1, ln2 in (
                (self.attn_t, self.mlp_t, self.norm1_t, self.norm2_t),
                (self.attn_s, self.mlp_s, self.norm1_s, self.norm2_s)):
            y = x + self.droppath(
                attn(layer_norm(x, ln1.weight, ln1.bias), generator=generator),
                generator)
            y = y + self.droppath(
                mlp(layer_norm(y, ln2.weight, ln2.bias), self.attn_impl,
                    generator), generator)
            branches.append(y)
        x_t, x_s = branches
        if self.att_fuse:
            return _gate_mix(x_s, x_t,
                             _linear(torch.cat([x_s, x_t], -1), self.ts_attn))
        return (x_s + x_t) * 0.5


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
        dt = self.compute_dtype
        x = dropout(self._embed(x), self.drop_rate, generator)
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

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        """The joint embedding plus the spatial and temporal embeddings, in
        the compute dtype."""
        dt = self.compute_dtype
        x = _linear(x.to(dt), self.joints_embed)
        x = x + self.pos_embed.to(dt)
        return x + self.temp_embed[:, :x.shape[1]].to(dt)

    def get_representation(self, x: torch.Tensor) -> torch.Tensor:
        return self(x, return_rep=True)


@torch.no_grad()
def attention_gate_stats(model: DSTformer, x: torch.Tensor) -> dict:
    """Per-sample gate statistics, the functional counterpart of the
    reference's count_attn accumulator (DSTformer.py:106-107, 202-212;
    ``motionbert_tpu/models/dstformer.py``'s ``attention_gate_stats``).

    Returns {"attn_count_s": (B, depth), "attn_count_t": (B, depth)} as
    numpy: the mean over frames and joints of the att_fuse gate's weight
    on the S->T and the T->S stream, per sample and layer. It runs its own
    forward without masks, each layer's T->S stream through its ungated
    pairs and the gate's weights (``ops.fused_pair.gate_alpha``) mixed in
    after, so the model's own forward, whose last pair carries the gate
    inside the kernel, keeps its bits."""
    dt = model.compute_dtype
    h = model._embed(x)
    stats = []
    for blk_st, blk_ts, gate in zip(model.blocks_st, model.blocks_ts,
                                    model.ts_attn):
        x_st, x_ts = blk_st(h), blk_ts(h)
        a = gate_alpha(x_st, x_ts, gate.weight.to(dt), gate.bias.to(dt))
        stats.append(a.float().mean((1, 2)))
        h = x_st * a[..., 0:1] + x_ts * a[..., 1:2]
    s = torch.stack(stats, 1).cpu().numpy()
    return {"attn_count_s": s[..., 0], "attn_count_t": s[..., 1]}
