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

Module and parameter names are the reference PyTorch ones, so a MotionBERT
state_dict loads with ``load_state_dict(strict=True)``. Parameters stay
fp32; ``compute_dtype`` (bf16 on the card) sets the activation dtype, with
LayerNorm and softmax statistics in fp32. Gradients flow through the pair
Functions (``ops/fused_pair.py``): on the card through the hand-written
backward kernels. Dropout, attention dropout and drop-path are not ported
(ROADMAP A1): training with any of their rates above 0 raises.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from motionbert_tpu_torch.ops.attention import layer_norm
from motionbert_tpu_torch.ops.fused_pair import (
    fused_gated_pair_block, fused_pair_block, gated_pair_block_plain,
    pair_block_plain)
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


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """nn.Linear in x's dtype (parameters cast on the way)."""
    return nn.functional.linear(x, layer.weight.to(x.dtype),
                                layer.bias.to(x.dtype))


class Attention(nn.Module):
    """The parameters of one attention sub-block (reference
    DSTformer.py:88-110): ``qkv`` packs [q | k | v], each H heads of d."""

    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 parameters (reference DSTformer.py:69-85)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """Pre-LN dual attention+MLP block (reference DSTformer.py:214-267).

    st_mode "stage_st": spatial pair then temporal pair; "stage_ts": the
    reverse order."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 st_mode: str, attn_impl: str = "kernel"):
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
        hidden = int(dim * mlp_ratio)
        self.norm1_s = nn.LayerNorm(dim, eps=1e-6)
        self.norm1_t = nn.LayerNorm(dim, eps=1e-6)
        self.norm2_s = nn.LayerNorm(dim, eps=1e-6)
        self.norm2_t = nn.LayerNorm(dim, eps=1e-6)
        self.attn_s = Attention(dim)
        self.attn_t = Attention(dim)
        self.mlp_s = Mlp(dim, hidden)
        self.mlp_t = Mlp(dim, hidden)

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

    def forward(self, x: torch.Tensor, gate=None) -> torch.Tensor:
        """x (B, F, J, C) in the compute dtype. gate=(other, wg, bg): mix the
        result with the twin stream ``other`` through the att_fuse gate,
        inside the last pair's kernel."""
        pair_fn, gated_fn = PAIR_IMPLS[self.attn_impl]
        order = ("s", "t") if self.st_mode == "stage_st" else ("t", "s")
        for i, axis in enumerate(order):
            params = self._pair_params(axis, x.dtype)
            mode = "spatial" if axis == "s" else "temporal"
            if gate is not None and i == len(order) - 1:
                other, wg, bg = gate
                return gated_fn(x, other, *params, wg, bg, self.num_heads,
                                self.scale, mode)
            x = pair_fn(x, *params, self.num_heads, self.scale, mode)
        return x


class DSTformer(nn.Module):
    """The MotionBERT backbone. Input (B, F, J, dim_in) -> (B, F, J, dim_out),
    or the (B, F, J, dim_rep) motion representation with return_rep=True.
    Outputs are in ``compute_dtype``."""

    def __init__(self, dim_in: int = 3, dim_out: int = 3, dim_feat: int = 256,
                 dim_rep: int = 512, depth: int = 5, num_heads: int = 8,
                 mlp_ratio: float = 4.0, num_joints: int = 17,
                 maxlen: int = 243, attn_impl: str = "kernel",
                 compute_dtype: torch.dtype = torch.float32,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.compute_dtype = compute_dtype
        # kept to refuse training with them: the port has no dropout yet
        self.drop_rates = dict(drop_rate=drop_rate,
                               attn_drop_rate=attn_drop_rate,
                               drop_path_rate=drop_path_rate)
        self.joints_embed = nn.Linear(dim_in, dim_feat)
        kw = dict(dim=dim_feat, num_heads=num_heads, mlp_ratio=mlp_ratio,
                  attn_impl=attn_impl)
        self.blocks_st = nn.ModuleList(
            Block(st_mode="stage_st", **kw) for _ in range(depth))
        self.blocks_ts = nn.ModuleList(
            Block(st_mode="stage_ts", **kw) for _ in range(depth))
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

    def forward(self, x: torch.Tensor, return_rep: bool = False) -> torch.Tensor:
        active = {k: v for k, v in self.drop_rates.items() if v > 0}
        if self.training and active and torch.is_grad_enabled():
            raise NotImplementedError(
                f"training with {active} needs dropout and drop-path, which "
                f"the port has not got yet (ROADMAP A1); set them to 0")
        F = x.shape[1]
        dt = self.compute_dtype
        x = _linear(x.to(dt), self.joints_embed)
        x = x + self.pos_embed.to(dt)
        x = x + self.temp_embed[:, :F].to(dt)
        for blk_st, blk_ts, gate in zip(self.blocks_st, self.blocks_ts,
                                        self.ts_attn):
            x_st = blk_st(x)
            x = blk_ts(x, gate=(x_st, gate.weight.to(dt), gate.bias.to(dt)))
        x = layer_norm(x, self.norm.weight, self.norm.bias)
        x = torch.tanh(_linear(x, self.pre_logits.fc))
        if return_rep:
            return x
        return _linear(x, self.head)

    def get_representation(self, x: torch.Tensor) -> torch.Tensor:
        return self(x, return_rep=True)
