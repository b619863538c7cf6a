"""The plain DSTformer (MotionBERT's backbone) in float32 PyTorch.

A frozen, self-contained copy of the published architecture (Zhu et al.,
ICCV 2023; DSTformer.py of Walter0807/MotionBERT) with the configuration's
att_fuse gate, written from the paper's equations and nothing else: no
kernels, no batching, no cache. Parameter names are the upstream ones, so
one state dict loads into this module and into the program under test.

    x   = joints_embed(x) + pos_embed + temp_embed[:F]
    per layer:  x_st = Block_ST(x), x_ts = Block_TS(x)
                (a0, a1) = softmax(ts_attn([x_st, x_ts]))
                x = a0 * x_st + a1 * x_ts
    out = head(tanh(pre_logits(LayerNorm(x))))

Each block is pre-LN: ``x + attn(LN x)`` then ``x + mlp(LN x)``, the
spatial pair first in Block_ST and the temporal pair first in Block_TS.
Spatial attention runs over the joints of a frame, temporal attention over
the frames of a joint. The MLP's GELU is the exact (erf) one. LayerNorm's
epsilon is 1e-6. Nothing here imports the program.

``fp8=True`` builds the same model with every product of its pairs (the
four Linear layers and the two attention products) taking its operands
rounded to float8 e4m3 under a per-tensor scale, and the gradients at
those operands rounded the same way in the backward: the reference
computed a precision below the program's bf16, the control of a training
cell's limits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax()
    s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def _exact(t: torch.Tensor) -> torch.Tensor:
    return t


def _linear(layer: nn.Linear, x: torch.Tensor, rnd) -> torch.Tensor:
    if rnd is _exact:
        return layer(x)
    return F.linear(rnd(x), rnd(layer.weight), layer.bias)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, mode: str, rnd=_exact):
        super().__init__()
        self.rnd = rnd
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.mode = mode
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, Fr, J, C = x.shape
        H = self.num_heads
        rnd = self.rnd
        qkv = _linear(self.qkv, x, rnd).reshape(B, Fr, J, 3, H, C // H)
        if self.mode == "spatial":      # tokens: the joints of a frame
            qkv = qkv.permute(3, 0, 1, 4, 2, 5)   # 3, B, F, H, J, d
        else:                           # tokens: the frames of a joint
            qkv = qkv.permute(3, 0, 2, 4, 1, 5)   # 3, B, J, H, F, d
        q, k, v = qkv[0], qkv[1], qkv[2]
        p = torch.softmax(rnd(q) @ rnd(k).transpose(-2, -1) * self.scale,
                          dim=-1)
        o = rnd(p) @ rnd(v)
        if self.mode == "spatial":
            o = o.permute(0, 1, 3, 2, 4)           # B, F, J, H, d
        else:
            o = o.permute(0, 3, 1, 2, 4)           # B, F, J, H, d
        return _linear(self.proj, o.reshape(B, Fr, J, C), rnd)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, rnd=_exact):
        super().__init__()
        self.rnd = rnd
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(_linear(self.fc1, x, self.rnd))
        return _linear(self.fc2, h, self.rnd)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 spatial_first: bool, rnd=_exact):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.spatial_first = spatial_first
        self.norm1_s = nn.LayerNorm(dim, eps=1e-6)
        self.norm1_t = nn.LayerNorm(dim, eps=1e-6)
        self.norm2_s = nn.LayerNorm(dim, eps=1e-6)
        self.norm2_t = nn.LayerNorm(dim, eps=1e-6)
        self.attn_s = Attention(dim, num_heads, "spatial", rnd)
        self.attn_t = Attention(dim, num_heads, "temporal", rnd)
        self.mlp_s = Mlp(dim, hidden, rnd)
        self.mlp_t = Mlp(dim, hidden, rnd)

    def _pair(self, x, axis: str):
        attn, mlp = getattr(self, f"attn_{axis}"), getattr(self, f"mlp_{axis}")
        x = x + attn(getattr(self, f"norm1_{axis}")(x))
        return x + mlp(getattr(self, f"norm2_{axis}")(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        order = ("s", "t") if self.spatial_first else ("t", "s")
        for axis in order:
            x = self._pair(x, axis)
        return x


class DSTformer(nn.Module):
    def __init__(self, dim_in: int = 3, dim_out: int = 3, dim_feat: int = 256,
                 dim_rep: int = 512, depth: int = 5, num_heads: int = 8,
                 mlp_ratio: float = 4.0, num_joints: int = 17,
                 maxlen: int = 243, fp8: bool = False):
        super().__init__()
        rnd = _RoundFp8.apply if fp8 else _exact
        self.joints_embed = nn.Linear(dim_in, dim_feat)
        self.blocks_st = nn.ModuleList(
            Block(dim_feat, num_heads, mlp_ratio, True, rnd)
            for _ in range(depth))
        self.blocks_ts = nn.ModuleList(
            Block(dim_feat, num_heads, mlp_ratio, False, rnd)
            for _ in range(depth))
        self.norm = nn.LayerNorm(dim_feat, eps=1e-6)
        self.pre_logits = nn.Sequential()
        self.pre_logits.add_module("fc", nn.Linear(dim_feat, dim_rep))
        self.pre_logits.add_module("act", nn.Tanh())
        self.head = nn.Linear(dim_rep, dim_out)
        self.temp_embed = nn.Parameter(torch.zeros(1, maxlen, 1, dim_feat))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_joints, dim_feat))
        self.ts_attn = nn.ModuleList(
            nn.Linear(dim_feat * 2, 2) for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.joints_embed(x) + self.pos_embed
        x = x + self.temp_embed[:, :x.shape[1]]
        for blk_st, blk_ts, gate in zip(self.blocks_st, self.blocks_ts,
                                        self.ts_attn):
            x_st, x_ts = blk_st(x), blk_ts(x)
            a = torch.softmax(gate(torch.cat([x_st, x_ts], -1)), dim=-1)
            x = x_st * a[..., 0:1] + x_ts * a[..., 1:2]
        return self.head(self.pre_logits(self.norm(x)))


MODEL_KEYS = ("dim_feat", "dim_rep", "depth", "num_heads", "mlp_ratio",
              "num_joints", "maxlen")


def build(config: dict, device, fp8: bool = False) -> DSTformer:
    """The plain model of a configuration's keys, float32 (its products in
    float8 with ``fp8``), on ``device``, its parameters left for
    ``load_state_dict``."""
    return DSTformer(**{k: config[k] for k in MODEL_KEYS}, fp8=fp8).to(device)


def parameter_shapes(config: dict) -> list:
    """[(name, shape), ...] of the model's parameters, in the order the
    weights are drawn (the module's own order)."""
    with torch.device("meta"):
        model = DSTformer(**{k: config[k] for k in MODEL_KEYS})
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def draw_weights(config: dict, seed: int, device) -> dict:
    """The state dict of a seed, drawn on ``device`` in one call: every
    parameter from one normal draw at the published initialisation's scale
    (std 0.02), the LayerNorms' scales at 1 + 0.02 n. Unlike the published
    initialisation, biases, the LayerNorms' shifts and the att_fuse gate's
    weights are drawn too rather than set to 0, so that every path of the
    forward carries a value. The same seed gives the same weights on the
    same kind of device."""
    shapes = parameter_shapes(config)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = 0.02 * torch.randn(total, generator=gen, device=device,
                              dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if "norm" in name and name.endswith(".weight"):
            t = 1.0 + t
        out[name] = t
    return out
