"""LayerNorm, single-axis attention (the attention core alone, B8) and the
standalone attention block (B4, B5).

``st_attention`` is softmax(q k^T * scale) v per head over the J joints of a
frame ("spatial") or the F frames of a joint ("temporal") of separate q, k, v
(B, F, J, C), differentiable (``StAttention``): the legacy attention modes
run it between their projections. On a CUDA tensor it launches the kernel in
``csrc/st_attention_kernels.cu`` (the chains' tensor-core core,
``csrc/attention_tc.cuh``, on three row-strided pointers) or raises; on a
CPU tensor it runs ``st_attention_plain``. Its backward is plain PyTorch
(``st_attention_bwd_plain``), as the JAX package's is XLA. It counts its
launches in ``st_attention.launches``. The kernel replaces
``motionbert_tpu/ops/attention.py:_temporal_pallas`` and ``_spatial_pallas``;
it moves four (B, F, J, C) bf16 tensors and is bound by bytes on the H100
(see the note at the top of the ``.cu``).
``coupled_attention`` (all F*J tokens of a clip) stays plain PyTorch, as XLA
computes it in the JAX package.

``fused_attention_block`` is ``[LN ->] qkv -> softmax(q k^T * scale) v per
head over the J joints of a frame ("spatial") or the F frames of a joint
("temporal") -> proj [-> + x]`` on x (B, F, J, C), differentiable
(``torch.autograd.Function`` ``FusedAttentionBlock``). The model runs it, with
``fused_mlp_block``, in place of the fused pair when dropout or drop-path is
live in training. On a CUDA tensor the forward and the backward launch the
hand-written kernel chains in ``csrc/block_kernels.cu`` (bf16, fp32
accumulation), or they raise; on a CPU tensor they run the plain PyTorch
versions beside them (``attention_block_plain``,
``attention_block_bwd_plain``). The forward saves only its inputs and the
backward recomputes the block, as the JAX package's custom VJP does. The
wrappers count their kernel launches in ``fused_attention_block.launches`` and
``fused_attention_block_bwd.launches``.

Source note. The CUDA chains replace the TPU kernels
``motionbert_tpu/ops/attention.py:_fused_block_pallas`` and
``motionbert_tpu/ops/attention.py:_fused_block_bwd_pallas``. On the H100 the
block is bound by tensor-core operations (~2.6 MFLOP per token against 2 KB of
token I/O at the flagship shape). The TPU design keeps the weights resident on
chip and accumulates parameter gradients across a sequential grid; the port
runs a chain over the flattened rows: every product on the wgmma + TMA GEMM
engine (``csrc/hopper_gemm.cuh``), the attention core, forward and backward,
on tensor cores (``csrc/attention_tc.cuh``), the LayerNorm and the bias
sums as row and column passes with two-pass deterministic reductions (see
the notes at the top of the ``.cu``). The engine reads x, g and the weights
through TMA, so each must sit at a 16-byte-aligned address
(``check_attention_args`` raises otherwise).

Tensor-parallel modes (``parallel/tensor.py``). Under tensor parallelism a
model rank holds a head group's rows of qkv, wqkv (3 Ci, C) with Ci = C / T,
and the matching columns of proj, wproj (C, Ci).
``fused_attention_block_tp`` runs B4's chain on those shards with the
LayerNorm and returns the fp32 partial product (no bias, no residual), which
the caller sums over the model ranks; ``fused_attention_block_tp_bwd`` runs
B5's chain on them up to the fp32 gradient at the LayerNorm's output (dh)
and returns it with the LayerNorm's row statistics, and ``fused_ln_bwd`` runs
the LayerNorm backward from the summed dh with the residual gradient. Their
plain twins are ``attention_block_tp_plain``, ``attention_block_tp_bwd_plain``
and ``ln_bwd_plain``; each wrapper counts its launches in ``.launches``.
Without the residual (the dropout path's branch) the LayerNorm backward
leaves g out: dx = bf16(LN-backward(dh)), B5's rounding without the
residual. B5_tp's core backward also writes attn, the forward core's bits,
so no forward core runs; on 243-frame groups it is two launches, a
query-major half (dq, attn and each row's max, reciprocal sum and D) and a
key-major half (dk, dv), whose plain mirrors are
``st_attention_bwd_query_plain`` and ``st_attention_bwd_key_plain`` and
whose test entry is ``attention_core_bwd_attn``; its two weight gradients
run in one grouped launch of the engine. B4_tp takes the LayerNorm inside
its qkv product (``csrc/hopper_gemm.cuh`` ``hg_ln_gemm``: no h in device
memory; twin ``fused_mlp.ln_engine_gemm_plain``) and on 243-frame groups a
split forward core (64-row query slices, two blocks an SM;
``st_attention_sliced_plain``, test entry ``attention_core_fwd``, grid
``attn_tp_fwd_core_grid`` and its plan ``attn_tp_fwd_core_plan``): 3
launches a call.

The LayerNorm backward (``fused_ln_bwd``, and inside B3, B5 and B7) is one
pass over the rows that writes dx and sums the parameter gradients into
fixed row chunks, then an in-order sum of the chunks
(``csrc/pair_bwd_common.cuh`` ``launch_ln_bwd``); the chains' bias
gradients are column sums of the same shape (``column_sum``, the test entry
of one, with its plain twin ``column_sum_plain``). It replaces the TPU
function ``motionbert_tpu/ops/attention.py:_ln_bwd_rows`` and is bound by
bytes: it reads dh and x once (see the note above the kernel).

The plain versions here are also what the CUDA pair kernel is held against
(``ops/fused_pair.py``). They keep the kernels' rounding points: inputs arrive
in the compute dtype, every sum is taken in fp32, and results are rounded back
to the compute dtype where the kernel rounds. In fp32 they reduce to the JAX
package's XLA formulation (``motionbert_tpu/ops/attention.py``:
``layer_norm``, ``_attention_xla``, ``_fused_block_xla``). Weights use
nn.Linear's layout: wqkv (3C, C), wproj (C, C), or a head group's shards.
"""

from __future__ import annotations

import ctypes

import torch

from motionbert_tpu_torch.ops import _build

LN_EPS = 1e-6

# what the CUDA kernels take
MAX_FRAMES = 243   # one temporal group's K and V stay in shared memory
NUM_JOINTS = 17
HEAD_DIMS = (32, 64)
# the tensor-core core numbers its (group, head) items with 32-bit ints: at
# most B*F*J * heads of them (a temporal group of one frame)
CORE_MAX_ITEMS = 2 ** 31 - 1
# the GEMM engine walks its tiles with persistent blocks, and it, the row
# passes and the column sums index the token rows with 32-bit ints
ENGINE_MAX_ROWS = 2 ** 31 - 1


def check_tensor(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def device_kind(x: torch.Tensor, what: str = "pair") -> str:
    """"cpu" or "cuda"; any other device has no version of the ``what``
    kernel."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {x.device}")
    return x.device.type


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in the plain versions' accumulation type: fp32, or fp64 for an fp64
    tensor (so that ``torch.autograd.gradcheck`` can run them)."""
    return t if t.dtype == torch.float64 else t.float()


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """fp32 ``x @ weight.T + bias`` with ``weight`` in nn.Linear layout
    (out, in); the inputs may be bf16 (exact products, fp32 sums)."""
    return torch.matmul(wide(x), wide(weight).t()) + wide(bias)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics, var = E[x^2] -
    mean^2 (flax semantics), returned in x's dtype."""
    xf = wide(x)
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * wide(weight) + wide(bias)).to(x.dtype)


def ln_row_stats(x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """The LayerNorm's row statistics (..., 2): mean and rstd in fp32, as
    the CUDA row pass writes them."""
    xf = wide(x)
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    return torch.cat([mu, torch.rsqrt(var + eps)], -1)


def ln_fwd_stats(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float = LN_EPS) -> tuple:
    """LayerNorm forward keeping what its backward needs: (xhat, rstd, h),
    all fp32 (the JAX package's ``_ln_fwd_stats``)."""
    return ln_from_stats(x, ln_row_stats(x, eps), weight, bias)


def ln_from_stats(x, stats, weight, bias=None) -> tuple:
    """(xhat, rstd, h) from the row statistics; h is None without bias."""
    rstd = stats[..., 1:]
    xhat = (wide(x) - stats[..., :1]) * rstd
    h = None if bias is None else xhat * wide(weight) + wide(bias)
    return xhat, rstd, h


def ln_bwd_rows(dh: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
                weight: torch.Tensor) -> tuple:
    """LayerNorm backward from fp32 ``dh`` (the JAX package's
    ``_ln_bwd_rows``): (dx, dweight, dbias), all fp32, the parameter
    gradients summed over every leading axis."""
    lead = tuple(range(dh.dim() - 1))
    dweight = (dh * xhat).sum(lead)
    dbias = dh.sum(lead)
    dy = dh * wide(weight)
    m1 = dy.mean(-1, keepdim=True)
    m2 = (dy * xhat).mean(-1, keepdim=True)
    return rstd * (dy - m1 - xhat * m2), dweight, dbias


def ln_bwd_plain(dh: torch.Tensor, x: torch.Tensor, stats: torch.Tensor,
                 weight: torch.Tensor, g=None) -> tuple:
    """The plain version of ``fused_ln_bwd``: the LayerNorm backward of x
    from the fp32 gradient at its output dh and its row statistics (mean,
    rstd), plus the residual gradient g: (bf16(dx + g), dweight, dbias), the
    parameter gradients fp32; g None (a half without the residual):
    bf16(dx)."""
    xhat, rstd, _ = ln_from_stats(x, stats, weight)
    dx, dweight, dbias = ln_bwd_rows(dh, xhat, rstd, weight)
    if g is not None:
        dx = dx + wide(g)
    return dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(weight.dtype)


# (B, F, J, H, d) -> groups of tokens, and back
_PERM = {"spatial": (0, 1, 3, 2, 4), "temporal": (0, 2, 3, 1, 4)}


def to_groups(t: torch.Tensor, mode: str, num_heads: int) -> torch.Tensor:
    """(B, F, J, C) -> (B, ., H, N, d): the N tokens that attend to each
    other (the J joints of a frame, or the F frames of a joint) per head."""
    B, F, J, C = t.shape
    return t.reshape(B, F, J, num_heads, C // num_heads).permute(_PERM[mode])


def from_groups(t: torch.Tensor, mode: str) -> torch.Tensor:
    """Inverse of ``to_groups``."""
    perm = _PERM[mode]
    t = t.permute([perm.index(i) for i in range(5)])
    B, F, J, H, d = t.shape
    return t.reshape(B, F, J, H * d)


def st_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mode: str, num_heads: int,
                       scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over the joints of one frame ("spatial") or
    the frames of one joint ("temporal") of (B, F, J, C) tensors. Scores and
    softmax in fp32, P rounded to q's dtype before P.v, output in q's dtype.
    The plain attention core: the plain versions of every kernel call it, and
    ``st_attention`` is held against it."""
    if mode not in _PERM:
        raise ValueError(f"unknown attention mode: {mode!r}")
    qh, kh, vh = (wide(to_groups(t, mode, num_heads)) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.matmul(wide(p), vh).to(q.dtype)
    return from_groups(o, mode)


def _attend_packed(h: torch.Tensor, wqkv, bqkv, num_heads: int, scale: float,
                   mode: str) -> torch.Tensor:
    """The attention core on the packed qkv projection of h: (..., Ci) in
    h's dtype, Ci = wqkv's rows / 3 (C, or a head group's width)."""
    Ci = wqkv.shape[0] // 3
    qkv = linear(h, wqkv, bqkv).to(h.dtype)
    return st_attention_plain(qkv[..., :Ci], qkv[..., Ci:2 * Ci],
                              qkv[..., 2 * Ci:], mode, num_heads, scale)


def attention_block(x: torch.Tensor, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                    num_heads: int, scale: float, mode: str,
                    use_ln: bool = True, residual: bool = True) -> torch.Tensor:
    """Attention sub-block ``[x +] proj(attn(qkv([LN] x)))``, returned in
    fp32 (the caller rounds it). The pair uses the pre-LN form with the
    residual."""
    h = layer_norm(x, ln_w, ln_b) if use_ln else x
    out = linear(_attend_packed(h, wqkv, bqkv, num_heads, scale, mode), wproj,
                 bproj)
    return out + wide(x) if residual else out


def attention_block_tp_plain(x, ln_w, ln_b, wqkv, bqkv, wproj,
                             num_heads: int, scale: float,
                             mode: str) -> torch.Tensor:
    """The plain version of ``fused_attention_block_tp``: LN, qkv on a head
    group's rows wqkv (3 Ci, C), attention over its ``num_heads`` heads, and
    the fp32 product with proj's columns of those heads wproj (C, Ci),
    without bias or residual. Summed over the groups, plus proj's bias and
    x, it is ``attention_block``'s output."""
    attn = _attend_packed(layer_norm(x, ln_w, ln_b), wqkv, bqkv, num_heads,
                          scale, mode)
    return torch.matmul(wide(attn), wide(wproj).t())


# ---------------------------------------------------------------------------
# the standalone attention block: plain versions
# ---------------------------------------------------------------------------

def attention_block_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                          num_heads: int, scale: float, mode: str,
                          use_ln: bool = False,
                          residual: bool = False) -> torch.Tensor:
    """``attention_block`` rounded to x's dtype: the plain version of
    ``fused_attention_block``."""
    return attention_block(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                           scale, mode, use_ln, residual).to(x.dtype)


def no_ln_grads(ln_w, ln_b) -> tuple:
    """The LayerNorm gradients of a block run without use_ln: zeros, or None
    for parameters passed as None (the block reads them only with use_ln)."""
    return tuple(None if t is None else torch.zeros_like(t)
                 for t in (ln_w, ln_b))


def rows(t: torch.Tensor) -> torch.Tensor:
    """t as (token rows, channels) in the accumulation type."""
    return wide(t.reshape(-1, t.shape[-1]))


def weight_grad(dy: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """sum over token rows of dy^T a, fp32: an nn.Linear weight's gradient."""
    return torch.matmul(rows(dy).t(), rows(a))


def attention_block_bwd_plain(x, g, ln_w, ln_b, wqkv, bqkv, wproj,
                              num_heads: int, scale: float, mode: str,
                              use_ln: bool = False,
                              residual: bool = False) -> tuple:
    """Gradients of ``attention_block_plain`` at x for the output gradient
    g, written out at the rounding points of the JAX package's
    ``_fused_block_bwd_kernel``: the forward is recomputed (h, qkv, fp32 P,
    attn); dattn, P, dS and dqkv are rounded to the compute dtype before
    their products, and dbqkv sums the fp32 dqkv. Returns (dx, dln_w, dln_b,
    dwqkv, dbqkv, dwproj, dbproj), each in its tensor's dtype (dbproj in
    wproj's); without use_ln, ``no_ln_grads``."""
    dt = x.dtype
    stats = ln_row_stats(x) if use_ln else None
    dh, dwqkv, dbqkv, dwproj = _attention_bwd_products(
        x, g, stats, ln_w, ln_b, wqkv, bqkv, wproj, num_heads, scale, mode)
    dbproj = rows(g).sum(0)
    # ---- LayerNorm backward and residual ----
    if use_ln:
        xhat, rstd, _ = ln_from_stats(x, stats, ln_w)
        dx, dln_w, dln_b = ln_bwd_rows(dh, xhat, rstd, ln_w)
        dln_w, dln_b = dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype)
    else:
        dx, (dln_w, dln_b) = dh, no_ln_grads(ln_w, ln_b)
    if residual:
        dx = dx + wide(g)
    return (dx.to(dt), dln_w, dln_b,
            dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwproj.to(wproj.dtype),
            dbproj.to(wproj.dtype))


def attention_block_tp_bwd_plain(x, g, ln_w, ln_b, wqkv, bqkv, wproj,
                                 num_heads: int, scale: float,
                                 mode: str) -> tuple:
    """The plain version of ``fused_attention_block_tp_bwd``: the gradients
    of ``attention_block_tp_plain`` for the output gradient g, at
    ``attention_block_bwd_plain``'s rounding points, up to the fp32 gradient
    at the LayerNorm's output. Returns (dwqkv, dbqkv, dwproj, dh fp32, the
    LayerNorm's row statistics (..., 2) fp32)."""
    stats = ln_row_stats(x)
    dh, dwqkv, dbqkv, dwproj = _attention_bwd_products(
        x, g, stats, ln_w, ln_b, wqkv, bqkv, wproj, num_heads, scale, mode)
    return (dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype),
            dwproj.to(wproj.dtype), dh, stats)


def _attention_bwd_products(x, g, stats, ln_w, ln_b, wqkv, bqkv, wproj,
                            num_heads: int, scale: float, mode: str) -> tuple:
    """The attention block's backward up to the fp32 gradient at the qkv
    product's input (the LayerNorm's output with ``stats``, else x): (dh,
    dwqkv, dbqkv, dwproj), the gradients fp32. wqkv (3 Ci, C), wproj
    (C, Ci)."""
    dt = x.dtype
    Ci = wqkv.shape[0] // 3
    # ---- forward recompute ----
    h = x if stats is None else ln_from_stats(x, stats, ln_w, ln_b)[2].to(dt)
    qkv = linear(h, wqkv, bqkv)
    q, k, v = (wide(to_groups(qkv[..., i * Ci:(i + 1) * Ci].to(dt), mode,
                              num_heads)) for i in range(3))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    pb = wide(p.to(dt))
    attn = from_groups(torch.matmul(pb, v).to(dt), mode)
    # ---- output projection backward ----
    dattn = torch.matmul(wide(g), wide(wproj))
    dwproj = weight_grad(g, attn)
    # ---- attention core and qkv projection backward ----
    dah = wide(to_groups(dattn.to(dt), mode, num_heads))
    dv = torch.matmul(pb.transpose(-1, -2), dah)
    dp = torch.matmul(dah, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = wide((ds * scale).to(dt))
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.cat([from_groups(t, mode) for t in (dq, dk, dv)], -1)
    dqkvb = dqkv.to(dt)
    dwqkv = weight_grad(dqkvb, h)
    dbqkv = rows(dqkv).sum(0)
    return torch.matmul(wide(dqkvb), wide(wqkv)), dwqkv, dbqkv, dwproj


# ---------------------------------------------------------------------------
# the standalone attention block: kernel launch
# ---------------------------------------------------------------------------

def check_aligned(name: str, t: torch.Tensor) -> None:
    """The engine's TMA loads read from 16-byte-aligned addresses only."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the GEMM engine needs a 16-byte-aligned "
                         f"address, got one at offset {t.data_ptr() % 16}")


def core_max_rows(num_heads: int) -> int:
    """Token rows (B*F*J) a chain of the engine (bf16 or s8) and the
    tensor-core core takes, and the core alone (B8): the core's item count
    binds before ENGINE_MAX_ROWS does."""
    return CORE_MAX_ITEMS // num_heads


def check_ln_args(ln_w, ln_b, C: int, use_ln: bool, dev) -> None:
    """ln_w / ln_b: (C,) fp32 on x's device, or None without use_ln."""
    for name, t in (("ln_w", ln_w), ("ln_b", ln_b)):
        if t is None and use_ln:
            raise ValueError(f"{name} is None with use_ln")
        if t is not None:
            check_tensor(name, t, (C,), torch.float32, dev)


def check_attention_args(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                         num_heads: int, mode: str, use_ln: bool = True,
                         tp: bool = False) -> None:
    """Raise ValueError on anything the CUDA attention block does not take
    (bproj None: the backward, or a tensor-parallel mode, which do not read
    it). Its chains run the GEMM engine and the tensor-core core, so the row
    limit is ``core_max_rows``, and x, the weights and the biases must sit
    at 16-byte-aligned addresses (the engine's TMA and vector loads). With
    ``tp`` the weights are a head group's shards: wqkv (3 Ci, C), wproj
    (C, Ci), with ``num_heads`` local heads of Ci / num_heads channels."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, F, J, C), got shape {tuple(x.shape)}")
    B, F, J, C = x.shape
    if mode not in ("spatial", "temporal"):
        raise ValueError(f"unknown attention mode: {mode!r}")
    if J != NUM_JOINTS:
        raise ValueError(f"the attention kernel takes J={NUM_JOINTS} joints, "
                         f"got {J}")
    if not 1 <= F <= MAX_FRAMES:
        raise ValueError(f"the attention kernel takes 1..{MAX_FRAMES} frames, "
                         f"got {F}")
    Ci = wqkv.shape[0] // 3 if tp else C
    if C % 64 or Ci % 64 or num_heads < 1 or Ci % num_heads \
            or Ci // num_heads not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes C % 64 == 0, an inner "
                         f"width Ci % 64 == 0 and head dim Ci / heads in "
                         f"{HEAD_DIMS}, got C={C}, Ci={Ci}, heads={num_heads}")
    limit = core_max_rows(num_heads)
    if not 1 <= B * F * J <= limit:
        raise ValueError(f"the attention block kernel takes 1..{limit} token "
                         f"rows (B*F*J) at {num_heads} heads, got {B * F * J}")
    dev, bf16 = x.device, torch.bfloat16
    check_tensor("x", x, (B, F, J, C), bf16, dev)
    check_ln_args(ln_w, ln_b, C, use_ln, dev)
    for name, t, shape in (("wqkv", wqkv, (3 * Ci, C)),
                           ("bqkv", bqkv, (3 * Ci,)),
                           ("wproj", wproj, (C, Ci)), ("bproj", bproj, (C,))):
        if t is not None:
            check_tensor(name, t, shape, bf16, dev)
    for name, t in (("x", x), ("wqkv", wqkv), ("bqkv", bqkv),
                    ("wproj", wproj), ("bproj", bproj)):
        if t is not None:
            check_aligned(name, t)


# mbt_attention_block_bwd's pointer array, in the order of the AttnSlot enum
# in csrc/block_kernels.cu: inputs, outputs, scratch
ATTN_BWD_SLOTS = (
    "x", "g", "ln_w", "ln_b", "wqkv", "bqkv", "wproj",
    "dx", "dln_w", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj",
    "h", "st", "qkv", "attn", "dattn", "dqkv", "dqkvb", "dh", "work")
# mbt_attention_block_tp_bwd's, in the order of the AttnTpSlot enum
ATTN_TP_BWD_SLOTS = (
    "x", "g", "ln_w", "ln_b", "wqkv", "bqkv", "wproj",
    "dwqkv", "dbqkv", "dwproj", "dh", "st",
    "h", "qkv", "attn", "dattn", "dqkv", "dqkvb", "core_st", "work")


def bind_block_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of csrc/block_kernels.cu's entry
    points on lib (this checkout's library, or another checkout's whose
    entries take the same arguments); entries lib lacks are skipped."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    slots = ctypes.POINTER(vp)
    for name, argtypes in (
            ("mbt_attention_block", [vp] * 10 + [i] * 5 + [f] + [i] * 3 + [vp]),
            ("mbt_attention_block_bwd", [slots] + [i] * 5 + [f] + [i] * 3 + [vp]),
            ("mbt_mlp_block", [vp] * 9 + [i] * 5 + [vp]),
            ("mbt_mlp_block_bwd", [slots] + [i] * 5 + [vp]),
            ("mbt_attention_block_tp", [vp] * 9 + [i] * 6 + [f, i, vp]),
            ("mbt_attention_block_tp_bwd", [slots] + [i] * 6 + [f, i, vp]),
            ("mbt_mlp_block_tp", [vp] * 8 + [i] * 3 + [vp]),
            ("mbt_mlp_block_tp_bwd", [slots] + [i] * 3 + [vp]),
            ("mbt_ln_bwd", [vp] * 9 + [i] * 2 + [vp]),
            ("mbt_attn_core_bwd_attn_test", [vp] * 12 + [i] * 5 + [f, i, i, vp]),
            ("mbt_attn_tp_bwd_core_grid", [i] * 6 + [ctypes.POINTER(i)]),
            ("mbt_attn_tp_fwd_core_grid", [i] * 6 + [ctypes.POINTER(i)]),
            ("mbt_attn_core_fwd_test", [vp] * 4 + [i] * 5 + [f, i, i, vp]),
            ("mbt_ln_gemm_test", [vp] * 7 + [i] * 4 + [vp]),
            ("mbt_ln_gemm_constant", [ctypes.c_char_p]),
            ("mbt_attention_bwd_slot_count", []),
            ("mbt_mlp_bwd_slot_count", []),
            ("mbt_attention_tp_bwd_slot_count", []),
            ("mbt_mlp_tp_bwd_slot_count", [])):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    for name, argtypes in (("mbt_block_work_floats", [i, i]),
                           ("mbt_attention_block_tp_scratch", [i, i, i])):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong
    return lib


def block_library() -> ctypes.CDLL:
    """csrc/block_kernels.cu, loaded, with its argument types set."""
    lib = _build.load("block_kernels")
    if lib.mbt_attention_block.argtypes is None:
        bind_block_library(lib)
        if lib.mbt_attention_bwd_slot_count() != len(ATTN_BWD_SLOTS) or \
                lib.mbt_attention_tp_bwd_slot_count() != \
                len(ATTN_TP_BWD_SLOTS):
            raise RuntimeError("block_kernels.cu and ATTN_BWD_SLOTS / "
                               "ATTN_TP_BWD_SLOTS disagree on the pointer "
                               "slots")
    return lib


def data_ptr(t):
    """t's device address, None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def slot_pointers(slots: tuple, tensors: dict):
    """The ctypes pointer array of ``tensors`` in ``slots`` order (None ->
    a null pointer)."""
    return (ctypes.c_void_p * len(slots))(*(data_ptr(tensors[k])
                                            for k in slots))


def _launch(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, scale, mode,
            use_ln, residual) -> torch.Tensor:
    check_attention_args(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                         mode, use_ln)
    B, F, J, C = x.shape
    M = B * F * J
    lib = block_library()
    with torch.cuda.device(x.device):
        qkv = torch.empty((M, 3 * C), dtype=x.dtype, device=x.device)
        attn = torch.empty((M, C), dtype=x.dtype, device=x.device)
        out = torch.empty_like(x)
        rc = lib.mbt_attention_block(
            x.data_ptr(), out.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
            data_ptr(ln_w), data_ptr(ln_b), wqkv.data_ptr(),
            bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
            B, F, J, C, num_heads, float(scale), int(mode == "temporal"),
            int(use_ln), int(residual),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention block kernel launch failed with CUDA "
                           f"error {rc}")
    return out


def _launch_bwd(x, g, ln_w, ln_b, wqkv, bqkv, wproj, num_heads, scale, mode,
                use_ln, residual) -> tuple:
    B, F, J, C = x.shape
    check_attention_args(x, ln_w, ln_b, wqkv, bqkv, wproj, None, num_heads,
                         mode, use_ln)
    check_tensor("g", g, x.shape, x.dtype, x.device)
    check_aligned("g", g)
    M = B * F * J
    lib = block_library()
    dev = x.device
    with torch.cuda.device(dev):
        bf = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device=dev)
        f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
        ln = lambda t: t if use_ln else None
        t = dict(x=x, g=g, ln_w=ln_w, ln_b=ln_b, wqkv=wqkv, bqkv=bqkv,
                 wproj=wproj, dx=torch.empty_like(x),
                 dln_w=ln(f32(C)), dln_b=ln(f32(C)), dwqkv=bf(3 * C, C),
                 dbqkv=bf(3 * C), dwproj=bf(C, C), dbproj=bf(C),
                 h=ln(bf(M, C)), st=ln(f32(M, 2)), qkv=bf(M, 3 * C),
                 attn=bf(M, C), dattn=bf(M, C), dqkv=f32(M, 3 * C),
                 dqkvb=bf(M, 3 * C), dh=ln(f32(M, C)),
                 work=f32(lib.mbt_block_work_floats(3 * C, C)))
        rc = lib.mbt_attention_block_bwd(
            slot_pointers(ATTN_BWD_SLOTS, t), B, F, J, C, num_heads,
            float(scale), int(mode == "temporal"), int(use_ln), int(residual),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention block backward kernel launch failed "
                           f"with CUDA error {rc}")
    if not use_ln:
        t["dln_w"], t["dln_b"] = no_ln_grads(ln_w, ln_b)
    return tuple(t[n] for n in ("dx", "dln_w", "dln_b", "dwqkv", "dbqkv",
                                "dwproj", "dbproj"))


# ---------------------------------------------------------------------------
# the standalone attention block: public wrappers
# ---------------------------------------------------------------------------

def fused_attention_block_bwd(x, g, ln_w, ln_b, wqkv, bqkv, wproj,
                              num_heads: int, scale: float, mode: str,
                              use_ln: bool = False,
                              residual: bool = False) -> tuple:
    """The attention block's gradients (as ``attention_block_bwd_plain``
    orders them): the CUDA backward chain for a CUDA tensor, the plain
    backward for a CPU tensor."""
    args = (x, g, ln_w, ln_b, wqkv, bqkv, wproj, num_heads, scale, mode,
            use_ln, residual)
    if device_kind(x, "attention block") == "cpu":
        return attention_block_bwd_plain(*args)
    grads = _launch_bwd(*args)
    fused_attention_block_bwd.launches += 1
    return grads


fused_attention_block_bwd.launches = 0


class FusedAttentionBlock(torch.autograd.Function):
    """``fused_attention_block`` with its backward. Saves only the inputs;
    the backward recomputes the block."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                scale, mode, use_ln, residual):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, wproj)
        ctx.cfg = (num_heads, scale, mode, use_ln, residual)
        args = (x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, *ctx.cfg)
        if device_kind(x, "attention block") == "cpu":
            return attention_block_plain(*args)
        out = _launch(*args)
        fused_attention_block.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        grads = fused_attention_block_bwd(x, g.contiguous(), *params, *ctx.cfg)
        return (*grads, None, None, None, None, None)


def fused_attention_block(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                          num_heads: int, scale: float, mode: str,
                          use_ln: bool = False,
                          residual: bool = False) -> torch.Tensor:
    """[LN ->] qkv -> attention -> proj [-> + x] on x (B, F, J, C),
    differentiable in x and every parameter: the CUDA kernels for a CUDA
    tensor, the plain versions for a CPU tensor. ln_w / ln_b (C,) fp32 are
    read only with use_ln, and may be None without it."""
    return FusedAttentionBlock.apply(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                     num_heads, scale, mode, use_ln, residual)


fused_attention_block.launches = 0


# ---------------------------------------------------------------------------
# the tensor-parallel modes (B4_tp, B5_tp) and the LayerNorm backward
# ---------------------------------------------------------------------------

def check_ln_bwd_args(dh, x, stats, ln_w, g) -> None:
    """Raise ValueError on anything ``mbt_ln_bwd`` does not take: dh (..., C)
    fp32, x and g (..., C) bf16 (g may be None), stats (..., 2) and ln_w (C,)
    fp32, on one device, contiguous and 16-byte aligned."""
    C = x.shape[-1] if x.dim() else 0
    M = x.numel() // max(C, 1)
    if not C or C % 2 or not 1 <= M <= ENGINE_MAX_ROWS:
        raise ValueError(f"the LayerNorm backward takes an even C and "
                         f"1..{ENGINE_MAX_ROWS} rows, got shape "
                         f"{tuple(x.shape)}")
    dev, f32 = x.device, torch.float32
    check_tensor("x", x, x.shape, torch.bfloat16, dev)
    if g is not None:
        check_tensor("g", g, x.shape, torch.bfloat16, dev)
    check_tensor("dh", dh, x.shape, f32, dev)
    check_tensor("stats", stats, tuple(x.shape[:-1]) + (2,), f32, dev)
    check_tensor("ln_w", ln_w, (C,), f32, dev)
    for name, t in (("x", x), ("g", g), ("dh", dh), ("stats", stats)):
        if t is not None:
            check_aligned(name, t)


def _launch_tp(x, ln_w, ln_b, wqkv, bqkv, wproj, num_heads, scale,
               mode) -> torch.Tensor:
    check_attention_args(x, ln_w, ln_b, wqkv, bqkv, wproj, None, num_heads,
                         mode, True, tp=True)
    B, F, J, C = x.shape
    Ci, M = wqkv.shape[0] // 3, B * F * J
    lib = block_library()
    with torch.cuda.device(x.device):
        qkv = torch.empty((M, 3 * Ci), dtype=x.dtype, device=x.device)
        # the core's output (M, Ci); where the LayerNorm is a row pass, its
        # rows (M, C) first
        attn = torch.empty(lib.mbt_attention_block_tp_scratch(M, C, Ci),
                           dtype=x.dtype, device=x.device)
        out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        rc = lib.mbt_attention_block_tp(
            x.data_ptr(), out.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
            ln_w.data_ptr(), ln_b.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wproj.data_ptr(), B, F, J, C, Ci, num_heads,
            float(scale), int(mode == "temporal"),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tensor-parallel attention block kernel launch "
                           f"failed with CUDA error {rc}")
    return out


def tp_bwd_tensors(x, g, ln_w, ln_b, wqkv, bqkv, wproj,
                   num_heads: int) -> dict:
    """Every buffer of ``mbt_attention_block_tp_bwd`` by its slot name,
    the outputs and scratch allocated on x's device: the core's split row
    statistics 3 * heads floats a token row, and the workspace of dWqkv's
    and dWproj's partials side by side."""
    B, F, J, C = x.shape
    Ci, M = wqkv.shape[0] // 3, B * F * J
    dev = x.device
    bf = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device=dev)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    return dict(x=x, g=g, ln_w=ln_w, ln_b=ln_b, wqkv=wqkv, bqkv=bqkv,
                wproj=wproj, dwqkv=bf(3 * Ci, C), dbqkv=bf(3 * Ci),
                dwproj=bf(C, Ci), dh=f32(B, F, J, C), st=f32(B, F, J, 2),
                h=bf(M, C), qkv=bf(M, 3 * Ci), attn=bf(M, Ci),
                dattn=bf(M, Ci), dqkv=f32(M, 3 * Ci), dqkvb=bf(M, 3 * Ci),
                core_st=f32(3 * num_heads * M),
                work=f32(block_library().mbt_block_work_floats(4 * Ci, C)))


def _launch_tp_bwd(x, g, ln_w, ln_b, wqkv, bqkv, wproj, num_heads, scale,
                   mode) -> tuple:
    check_attention_args(x, ln_w, ln_b, wqkv, bqkv, wproj, None, num_heads,
                         mode, True, tp=True)
    check_tensor("g", g, x.shape, x.dtype, x.device)
    check_aligned("g", g)
    B, F, J, C = x.shape
    Ci = wqkv.shape[0] // 3
    lib = block_library()
    dev = x.device
    with torch.cuda.device(dev):
        t = tp_bwd_tensors(x, g, ln_w, ln_b, wqkv, bqkv, wproj, num_heads)
        rc = lib.mbt_attention_block_tp_bwd(
            slot_pointers(ATTN_TP_BWD_SLOTS, t), B, F, J, C, Ci, num_heads,
            float(scale), int(mode == "temporal"),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tensor-parallel attention block backward kernel "
                           f"launch failed with CUDA error {rc}")
    return tuple(t[n] for n in ("dwqkv", "dbqkv", "dwproj", "dh", "st"))


def _launch_ln_bwd(dh, x, stats, ln_w, g) -> tuple:
    check_ln_bwd_args(dh, x, stats, ln_w, g)
    C = x.shape[-1]
    M = x.numel() // C
    lib = block_library()
    dev = x.device
    with torch.cuda.device(dev):
        f32 = lambda n: torch.empty(n, dtype=torch.float32, device=dev)
        dx, dln_w, dln_b = torch.empty_like(x), f32(C), f32(C)
        work = f32(lib.mbt_block_work_floats(0, C))
        rc = lib.mbt_ln_bwd(
            dh.data_ptr(), x.data_ptr(), stats.data_ptr(), ln_w.data_ptr(),
            data_ptr(g), dx.data_ptr(), dln_w.data_ptr(), dln_b.data_ptr(),
            work.data_ptr(), M, C, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"LayerNorm backward kernel launch failed with "
                           f"CUDA error {rc}")
    return dx, dln_w, dln_b


def fused_attention_block_tp(x, ln_w, ln_b, wqkv, bqkv, wproj,
                             num_heads: int, scale: float,
                             mode: str) -> torch.Tensor:
    """B4's tensor-parallel mode on x (B, F, J, C) and a head group's shards
    (see ``attention_block_tp_plain``): the fp32 partial product, to be
    summed over the model ranks. The CUDA chain for a CUDA tensor, the plain
    version for a CPU tensor. Not differentiable by itself:
    ``parallel.tensor`` pairs it with ``fused_attention_block_tp_bwd``."""
    args = (x, ln_w, ln_b, wqkv, bqkv, wproj, num_heads, scale, mode)
    if device_kind(x, "attention block") == "cpu":
        return attention_block_tp_plain(*args)
    out = _launch_tp(*args)
    fused_attention_block_tp.launches += 1
    return out


fused_attention_block_tp.launches = 0


def fused_attention_block_tp_bwd(x, g, ln_w, ln_b, wqkv, bqkv, wproj,
                                 num_heads: int, scale: float,
                                 mode: str) -> tuple:
    """B5's tensor-parallel mode (see ``attention_block_tp_bwd_plain``):
    (dwqkv, dbqkv, dwproj, dh fp32, row statistics)."""
    args = (x, g, ln_w, ln_b, wqkv, bqkv, wproj, num_heads, scale, mode)
    if device_kind(x, "attention block") == "cpu":
        return attention_block_tp_bwd_plain(*args)
    grads = _launch_tp_bwd(*args)
    fused_attention_block_tp_bwd.launches += 1
    return grads


fused_attention_block_tp_bwd.launches = 0


def fused_ln_bwd(dh, x, stats, ln_w, g=None) -> tuple:
    """The LayerNorm backward from the fp32 gradient at its output, with the
    residual gradient g, or without it for g None (see ``ln_bwd_plain``):
    (dx, dln_w, dln_b). The CUDA pass with its parameter sums, and their
    in-order chunk sum, for a CUDA tensor; the plain version for a CPU
    tensor."""
    if device_kind(x, "LayerNorm backward") == "cpu":
        return ln_bwd_plain(dh, x, stats, ln_w, g)
    out = _launch_ln_bwd(dh, x, stats, ln_w, g)
    fused_ln_bwd.launches += 1
    return out


fused_ln_bwd.launches = 0


# ---------------------------------------------------------------------------
# a bias column sum alone (csrc/pair_bwd_common.cuh's column_sum through
# block_kernels.cu's test entry)
# ---------------------------------------------------------------------------

# csrc/pair_bwd_common.cuh's column-sum constants by the names
# mbt_colsum_constant (csrc/block_kernels.cu) maps to them: the bias sums'
# fixed row chunks and the loads a thread issues before it adds, the
# LayerNorm backward's fixed row chunks and column slice, and the ColMode
# values of the sources ("gate": bf16(w[:, 0]) * src); _colsum_library holds
# them against the library's
COLSUM_CONSTANTS = {"splits": 64, "batch": 32, "ln_splits": 256,
                    "ln_slice": 512, "bf16": 0, "f32": 1, "gate": 2}
COLSUM_MODES = ("bf16", "f32", "gate")


def column_sum_plain(src: torch.Tensor, mode: str, w=None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """The plain version of ``column_sum``: the fp32 sum over src's rows of
    src ("bf16", "f32") or of bf16(w[:, 0]) * src ("gate"), in
    out_dtype."""
    terms = rows(src)
    if mode == "gate":
        terms = terms * wide(w[:, :1].to(torch.bfloat16))
    return terms.sum(0).to(out_dtype)


def check_column_sum_args(src, mode: str, w, out_dtype) -> None:
    """Raise ValueError on anything column_sum's kernel does not take: src
    (M, N) contiguous, N even, bf16 (fp32 for "f32") at an address of a
    whole column pair; w (M, 2) fp32 for "gate"; a bf16 or fp32 output."""
    if mode not in COLSUM_MODES:
        raise ValueError(f"unknown column-sum mode: {mode!r}")
    if src.dim() != 2 or src.shape[1] % 2 or \
            not 1 <= src.shape[0] <= ENGINE_MAX_ROWS:
        raise ValueError(f"the column sum takes (M, N) sources with N even "
                         f"and 1..{ENGINE_MAX_ROWS} rows, got shape "
                         f"{tuple(src.shape)}")
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    check_tensor("src", src, src.shape, dt, src.device)
    if mode == "gate":
        if w is None:
            raise ValueError("the gate column sum reads w (M, 2) fp32")
        check_tensor("w", w, (src.shape[0], 2), torch.float32, src.device)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the column sum writes bf16 or fp32, not "
                         f"{out_dtype}")
    if src.data_ptr() % (2 * src.element_size()):
        raise ValueError(f"src: the column sum loads column pairs and needs "
                         f"an address of a whole pair, got one at offset "
                         f"{src.data_ptr() % (2 * src.element_size())}")


def _colsum_library() -> ctypes.CDLL:
    lib = block_library()
    if lib.mbt_colsum_test.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mbt_colsum_test.argtypes = [i, vp, vp, i, i, vp, vp, i, vp]
        lib.mbt_colsum_constant.argtypes = [ctypes.c_char_p]
        for fn in (lib.mbt_colsum_test, lib.mbt_colsum_constant):
            fn.restype = i
        drift = {name: (value, lib.mbt_colsum_constant(name.encode()))
                 for name, value in COLSUM_CONSTANTS.items()
                 if lib.mbt_colsum_constant(name.encode()) != value}
        if drift:
            lib.mbt_colsum_test.argtypes = None
            raise RuntimeError(f"attention's column-sum constants disagree "
                               f"with the library's (ours, the library's): "
                               f"{drift}")
    return lib


def column_sum(src: torch.Tensor, mode: str, w=None,
               out_dtype=torch.float32) -> torch.Tensor:
    """The column sums of an (M, N) source as the backward chains take
    their bias gradients (see ``column_sum_plain``): COLSUM_CONSTANTS'
    "splits" fixed row chunks, each a serial sum in row order, added in
    chunk order. The CUDA passes for a CUDA tensor, the plain version for a
    CPU tensor."""
    check_column_sum_args(src, mode, w, out_dtype)
    if device_kind(src, "column sum") == "cpu":
        return column_sum_plain(src, mode, w, out_dtype)
    M, N = src.shape
    lib = _colsum_library()
    dev = src.device
    with torch.cuda.device(dev):
        out = torch.empty(N, dtype=out_dtype, device=dev)
        work = torch.empty(COLSUM_CONSTANTS["splits"] * N,
                           dtype=torch.float32, device=dev)
        rc = lib.mbt_colsum_test(
            COLSUM_CONSTANTS[mode], src.data_ptr(), data_ptr(w), M, N,
            work.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"column sum kernel launch failed with CUDA error "
                           f"{rc}")
    column_sum.launches += 1
    return out


column_sum.launches = 0


# ---------------------------------------------------------------------------
# the attention core alone (B8): plain versions
# ---------------------------------------------------------------------------

def st_attention_bwd_plain(q, k, v, g, mode: str, num_heads: int,
                           scale: float) -> tuple:
    """Gradients (dq, dk, dv) of ``st_attention_plain`` for the output
    gradient g, P recomputed, at the rounding points of the JAX package's
    analytic backward (``motionbert_tpu/ops/attention.py``
    ``_attention_fused_bwd``; for spatial groups the VJP of
    ``_attention_xla_spatial_grouped``, the same math per frame): fp32 P; dv
    from P rounded to g's dtype; dS = P (dP - sum(dP P)) * scale rounded to
    q's dtype before dq and dk; every product summed in fp32; the gradients
    in q's dtype."""
    dt = q.dtype
    qh, kh, vh, gh = (wide(to_groups(t, mode, num_heads))
                      for t in (q, k, v, g))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(wide(p.to(g.dtype)).transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = wide((ds * scale).to(dt))
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(from_groups(t, mode).to(dt) for t in (dq, dk, dv))


def st_attention_bwd_query_plain(q, k, v, g, mode: str, num_heads: int,
                                 scale: float) -> tuple:
    """The query-major half of the split core backward
    (``csrc/attention_tc.cuh`` ``attn_tc_bwd_query_kernel``) in plain
    PyTorch: (dq, attn, stats). dq is ``st_attention_bwd_plain``'s, attn
    ``st_attention_plain``'s, bit for bit; stats (B, groups, H, 3, N) fp32
    holds each query row's max score, the reciprocal of its exp sum and D =
    rowsum(dP * P), the kernel's [item][3][N] buffer. P is the plain
    versions' softmax (the kernel's exp(S - max) * (1 / sum) is one fp32
    rounding from it)."""
    dt = q.dtype
    qh, kh, vh, gh = (wide(to_groups(t, mode, num_heads))
                      for t in (q, k, v, g))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    attn = torch.matmul(wide(p.to(dt)), vh).to(dt)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    d = (dp * p).sum(-1, keepdim=True)
    ds = wide((p * (dp - d) * scale).to(dt))
    dq = torch.matmul(ds, kh)
    mx = s.amax(-1, keepdim=True)
    inv = 1.0 / torch.exp(s - mx).sum(-1, keepdim=True)
    stats = torch.cat([mx, inv, d], -1).transpose(-1, -2)
    return from_groups(dq, mode).to(dt), from_groups(attn, mode), stats


def st_attention_bwd_key_plain(q, k, v, g, stats, mode: str, num_heads: int,
                               scale: float) -> tuple:
    """The key-major half (``attn_tc_bwd_key_kernel``) in plain PyTorch:
    (dk, dv) from the query-major half's statistics, P recomputed as the
    query-major half computes it and D read from stats; bit for bit
    ``st_attention_bwd_plain``'s dk and dv."""
    dt = q.dtype
    qh, kh, vh, gh = (wide(to_groups(t, mode, num_heads))
                      for t in (q, k, v, g))
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(wide(p.to(g.dtype)).transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = wide((p * (dp - stats[..., 2, :].unsqueeze(-1)) * scale).to(dt))
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(from_groups(t, mode).to(dt) for t in (dk, dv))


def attention_core_bwd_attn(q, k, v, g, mode: str, num_heads: int,
                            scale: float, split: bool) -> tuple:
    """B5_tp's core backward alone on (B, F, J, C) q, k, v and the output
    gradient g: (dq, dk, dv, attn) bf16, (dq, dk, dv) fp32 and the row
    statistics. On CUDA tensors one call of ``mbt_attn_core_bwd_attn_test``:
    with split the query-major and key-major launches (groups of 65..256
    rows), else the one-launch backward with attn; counted in
    ``attention_core_bwd_attn.launches``. On CPU tensors the plain halves
    (fp32 gradients before their rounding are not kept: None)."""
    if device_kind(q, "attention core") == "cpu":
        dq, attn, stats = st_attention_bwd_query_plain(q, k, v, g, mode,
                                                       num_heads, scale)
        dk, dv = st_attention_bwd_key_plain(q, k, v, g, stats, mode,
                                            num_heads, scale)
        return dq, dk, dv, attn, None, None, None, stats
    row_stride = check_st_attention_args(q, k, v, num_heads, mode)
    B, F, J, C = q.shape
    if row_stride != C or not g.is_contiguous() or g.shape != q.shape \
            or g.dtype != q.dtype or g.data_ptr() % 16:
        raise ValueError("attention_core_bwd_attn takes contiguous, 16-byte-"
                         "aligned q, k, v and g of one shape and dtype")
    lib = block_library()
    with torch.cuda.device(q.device):
        out = [torch.empty_like(q) for _ in range(4)] + [
            torch.empty(q.shape, dtype=torch.float32, device=q.device)
            for _ in range(3)]
        stats = torch.empty(3 * num_heads * B * F * J, dtype=torch.float32,
                            device=q.device)
        dqb, dkb, dvb, attn, dqf, dkf, dvf = out
        rc = lib.mbt_attn_core_bwd_attn_test(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dqf.data_ptr(), dkf.data_ptr(), dvf.data_ptr(), dqb.data_ptr(),
            dkb.data_ptr(), dvb.data_ptr(), attn.data_ptr(), stats.data_ptr(),
            B, F, J, C, num_heads, float(scale), int(mode == "temporal"),
            int(split), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tensor-core attention backward with attn launch "
                           f"failed with CUDA error {rc}")
    attention_core_bwd_attn.launches += 1
    return (*out, stats)


attention_core_bwd_attn.launches = 0


def attn_tp_bwd_core_grid(x_shape, num_heads: int, head_dim: int,
                          mode: str) -> dict:
    """The core backward's launches in ``mbt_attention_block_tp_bwd`` at
    x_shape (B, F, J, C) with num_heads local heads of head_dim: each
    launch's blocks, the blocks an SM holds of it (the runtime's occupancy
    for its threads and shared memory) and its waves over the device's
    SMs. Launches nothing."""
    B, F, J, _ = x_shape
    out = (ctypes.c_int * 6)()
    rc = block_library().mbt_attn_tp_bwd_core_grid(
        B, F, J, num_heads * head_dim, num_heads, int(mode == "temporal"), out)
    if rc != 0:
        raise RuntimeError(f"core grid query failed with CUDA error {rc}")
    return _grid([(out[1 + 2 * i], out[2 + 2 * i]) for i in range(out[0])],
                 out[5])


# attention_tc.cuh's split kernels: blocks of TC_SLICE_WARPS warps of
# TC_KEY_TILE query (or key) rows, on groups whose key tiles are 8 or 16
# (65..256 rows), where the one-launch kernels are one item a block
CORE_KEY_TILE = 16
CORE_SLICE_ROWS = 4 * CORE_KEY_TILE


def core_key_tiles(n: int) -> int:
    """Key tiles of a group of n rows (attention_tc.cuh's tc_key_tiles): a
    power of two, 0 outside 1..256."""
    if not 1 <= n <= 256:
        return 0
    kt = 1
    while kt * CORE_KEY_TILE < n:
        kt *= 2
    return kt


def core_splits_forward(n: int) -> bool:
    """Whether B4_tp's chain runs the split forward core on groups of n rows
    (block_kernels.cu's tc_split_forward)."""
    return core_key_tiles(n) in (8, 16)


def st_attention_sliced_plain(q, k, v, mode: str, num_heads: int,
                              scale: float) -> torch.Tensor:
    """B4_tp's split forward core (``csrc/attention_tc.cuh``
    ``attn_tc_fwd_query_kernel``) in plain PyTorch: each group's query rows
    in slices of CORE_SLICE_ROWS against the group's keys whole, as the
    kernel's blocks take them (groups of 65..256 rows; a smaller group is one
    slice); bit for bit ``st_attention_plain``'s."""
    qh, kh, vh = (wide(to_groups(t, mode, num_heads)) for t in (q, k, v))
    n = qh.shape[-2]
    step = CORE_SLICE_ROWS if core_splits_forward(n) else n
    out = []
    for r0 in range(0, n, step):
        s = torch.matmul(qh[..., r0:r0 + step, :], kh.transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1).to(q.dtype)
        out.append(torch.matmul(wide(p), vh).to(q.dtype))
    return from_groups(torch.cat(out, -2), mode)


def attention_core_fwd(q, k, v, mode: str, num_heads: int, scale: float,
                       split: bool) -> torch.Tensor:
    """B4_tp's forward core alone on (B, F, J, C) q, k, v: on CUDA tensors
    one call of ``mbt_attn_core_fwd_test``, with split the split forward
    (groups of 65..256 rows), else the one-launch kernel, counted in
    ``attention_core_fwd.launches``; on CPU tensors
    ``st_attention_sliced_plain`` (split) or ``st_attention_plain``."""
    if device_kind(q, "attention core") == "cpu":
        plain = st_attention_sliced_plain if split else st_attention_plain
        return plain(q, k, v, mode, num_heads, scale)
    row_stride = check_st_attention_args(q, k, v, num_heads, mode)
    B, F, J, C = q.shape
    if row_stride != C:
        raise ValueError("attention_core_fwd takes contiguous q, k, v")
    lib = block_library()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        rc = lib.mbt_attn_core_fwd_test(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, F, J,
            C, num_heads, float(scale), int(mode == "temporal"), int(split),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tensor-core attention forward launch failed with "
                           f"CUDA error {rc}")
    attention_core_fwd.launches += 1
    return out


attention_core_fwd.launches = 0


def _grid(launches: list, sms: int) -> dict:
    return dict(sms=sms, launches=[
        dict(blocks=b, blocks_an_sm=per_sm, waves=b / (per_sm * sms))
        for b, per_sm in launches])


def attn_tp_fwd_core_grid(x_shape, num_heads: int, head_dim: int,
                          mode: str) -> dict:
    """The forward core's launch in ``mbt_attention_block_tp`` at x_shape
    (B, F, J, C) with num_heads local heads of head_dim: its blocks, the
    blocks an SM holds of it (the runtime's occupancy) and its waves over
    the device's SMs, as ``attn_tp_bwd_core_grid`` gives them. Launches
    nothing."""
    B, F, J, _ = x_shape
    out = (ctypes.c_int * 4)()
    rc = block_library().mbt_attn_tp_fwd_core_grid(
        B, F, J, num_heads * head_dim, num_heads, int(mode == "temporal"), out)
    if rc != 0:
        raise RuntimeError(f"core grid query failed with CUDA error {rc}")
    return _grid([(out[1], out[2])], out[3])


def attn_tp_fwd_core_plan(x_shape, num_heads: int, mode: str,
                          blocks_an_sm: int, sms: int) -> dict:
    """``attn_tp_fwd_core_grid``'s blocks and waves from the shapes alone,
    for a card of ``sms`` SMs that holds ``blocks_an_sm`` blocks of the
    launch: (group, head) items times CORE_SLICE_ROWS-row query slices where
    the forward splits, else items over the one-launch kernel's items a
    block (8 / key tiles, at least 1)."""
    B, F, J, _ = x_shape
    n, groups = (F, B * J) if mode == "temporal" else (J, B * F)
    items, kt = groups * num_heads, core_key_tiles(n)
    if core_splits_forward(n):
        blocks = items * (kt * CORE_KEY_TILE // CORE_SLICE_ROWS)
    else:
        per_block = max(1, 8 // kt)
        blocks = -(-items // per_block)
    return _grid([(blocks, blocks_an_sm)], sms)


def coupled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      num_heads: int, scale: float) -> torch.Tensor:
    """All F*J tokens of a clip attend to each other (the legacy "coupling"
    mode; ``motionbert_tpu/ops/attention.py`` ``coupled_attention``, which
    XLA computes outside any kernel): fp32 scores and softmax, P rounded to
    q's dtype, output in q's dtype. Plain PyTorch on every device,
    differentiable by autograd; its fp32 scores take B * H * (F J)^2 * 4
    bytes."""
    B, F, J, C = q.shape
    d = C // num_heads
    qh, kh, vh = (wide(t.reshape(B, F * J, num_heads, d).transpose(1, 2))
                  for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.matmul(wide(p), vh).to(q.dtype)
    return o.transpose(1, 2).reshape(B, F, J, C)


# ---------------------------------------------------------------------------
# the attention core alone (B8): kernel launch and public wrapper
# ---------------------------------------------------------------------------

def check_st_attention_args(q, k, v, num_heads: int, mode: str) -> int:
    """Raise ValueError on anything the CUDA attention core (the tensor-core
    core, csrc/attention_tc.cuh) does not take; return the common row stride
    of q, k and v (C for contiguous tensors, 3C for the slices of a packed
    qkv projection). The core copies 16-byte chunks, so each tensor sits at
    a 16-byte-aligned address with a row stride of a multiple of 8, and it
    numbers its (group, head) items with 32-bit ints (``core_max_rows``)."""
    if mode not in ("spatial", "temporal"):
        raise ValueError(f"unknown attention mode: {mode!r}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, F, J, C), got shape {tuple(q.shape)}")
    B, F, J, C = q.shape
    if J != NUM_JOINTS:
        raise ValueError(f"the attention kernel takes J={NUM_JOINTS} joints, "
                         f"got {J}")
    if not 1 <= F <= MAX_FRAMES:
        raise ValueError(f"the attention kernel takes 1..{MAX_FRAMES} frames, "
                         f"got {F}")
    if C % 64 or num_heads < 1 or C % num_heads \
            or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes C % 64 == 0 and head "
                         f"dim in {HEAD_DIMS}, got C={C}, heads={num_heads}")
    limit = core_max_rows(num_heads)
    if not 1 <= B * F * J <= limit:
        raise ValueError(f"the attention kernel takes 1..{limit} token rows "
                         f"(B*F*J) at {num_heads} heads, got {B * F * J}")
    ld = q.stride(2)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if tuple(t.shape) != (B, F, J, C):
            raise ValueError(f"{name}: expected shape {(B, F, J, C)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: expected torch.bfloat16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: expected device {q.device}, got "
                             f"{t.device}")
        want = (F * J * ld, J * ld, ld, 1)
        if any(n > 1 and t.stride(i) != w
               for i, (n, w) in enumerate(zip(t.shape, want))) \
                or ld < C or ld % 8:
            raise ValueError(f"{name}: the attention kernel takes token rows "
                             f"of one common row stride >= C and a multiple "
                             f"of 8 (q's is {ld}), got strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the tensor-core core copies 16-byte "
                             f"chunks and needs a 16-byte-aligned address, "
                             f"got one at offset {t.data_ptr() % 16}")
    return ld


def st_attention_library() -> ctypes.CDLL:
    """csrc/st_attention_kernels.cu, loaded, with its argument types set."""
    lib = _build.load("st_attention_kernels")
    if lib.mbt_st_attention.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mbt_st_attention.argtypes = [vp, vp, vp, i, vp] + [i] * 5 + [
            ctypes.c_float, i, vp]
        lib.mbt_st_attention.restype = ctypes.c_int
    return lib


def _launch_st(q, k, v, mode, num_heads, scale) -> torch.Tensor:
    ld = check_st_attention_args(q, k, v, num_heads, mode)
    B, F, J, C = q.shape
    lib = st_attention_library()
    with torch.cuda.device(q.device):
        out = torch.empty((B, F, J, C), dtype=q.dtype, device=q.device)
        rc = lib.mbt_st_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, out.data_ptr(),
            B, F, J, C, num_heads, float(scale), int(mode == "temporal"),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention core kernel launch failed with CUDA "
                           f"error {rc}")
    return out


class StAttention(torch.autograd.Function):
    """``st_attention`` with its backward. Saves only q, k and v; the
    backward recomputes P in plain PyTorch (``st_attention_bwd_plain``), as
    the JAX package's backward is XLA and not a kernel."""

    @staticmethod
    def forward(ctx, q, k, v, mode, num_heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (mode, num_heads, scale)
        if device_kind(q, "attention core") == "cpu":
            return st_attention_plain(q, k, v, mode, num_heads, scale)
        out = _launch_st(q, k, v, mode, num_heads, scale)
        st_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*st_attention_bwd_plain(q, k, v, g, *ctx.cfg), None, None,
                None)


def st_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mode: str, num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v per head over the joints of a frame
    ("spatial") or the frames of a joint ("temporal") of (B, F, J, C)
    tensors, differentiable in q, k and v: the CUDA kernel for CUDA tensors
    (bf16 token rows of one common row stride, so slices of a packed qkv
    need no copy), the plain version for CPU tensors."""
    return StAttention.apply(q, k, v, mode, num_heads, scale)


st_attention.launches = 0
