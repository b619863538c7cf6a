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

The plain versions here are also what the CUDA pair kernel is held against
(``ops/fused_pair.py``). They keep the kernels' rounding points: inputs arrive
in the compute dtype, every sum is taken in fp32, and results are rounded back
to the compute dtype where the kernel rounds. In fp32 they reduce to the JAX
package's XLA formulation (``motionbert_tpu/ops/attention.py``:
``layer_norm``, ``_attention_xla``, ``_fused_block_xla``). Weights use
nn.Linear's layout: wqkv (3C, C), wproj (C, C).
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


def ln_fwd_stats(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float = LN_EPS) -> tuple:
    """LayerNorm forward keeping what its backward needs: (xhat, rstd, h),
    all fp32 (the JAX package's ``_ln_fwd_stats``)."""
    xf = wide(x)
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mu) * rstd
    return xhat, rstd, xhat * wide(weight) + wide(bias)


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


def attention_block(x: torch.Tensor, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                    num_heads: int, scale: float, mode: str,
                    use_ln: bool = True, residual: bool = True) -> torch.Tensor:
    """Attention sub-block ``[x +] proj(attn(qkv([LN] x)))``, returned in
    fp32 (the caller rounds it). The pair uses the pre-LN form with the
    residual."""
    C = x.shape[-1]
    h = layer_norm(x, ln_w, ln_b) if use_ln else x
    qkv = linear(h, wqkv, bqkv).to(x.dtype)
    attn = st_attention_plain(qkv[..., :C], qkv[..., C:2 * C],
                              qkv[..., 2 * C:], mode, num_heads, scale)
    out = linear(attn, wproj, bproj)
    return out + wide(x) if residual else out


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
    C = x.shape[-1]
    # ---- forward recompute ----
    if use_ln:
        xhat, rstd, hf = ln_fwd_stats(x, ln_w, ln_b)
        h = hf.to(dt)
    else:
        h = x
    qkv = linear(h, wqkv, bqkv)
    q, k, v = (wide(to_groups(qkv[..., i * C:(i + 1) * C].to(dt), mode,
                              num_heads)) for i in range(3))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    pb = wide(p.to(dt))
    attn = from_groups(torch.matmul(pb, v).to(dt), mode)
    # ---- output projection backward ----
    dattn = torch.matmul(wide(g), wide(wproj))
    dwproj = weight_grad(g, attn)
    dbproj = rows(g).sum(0)
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
    dh = torch.matmul(wide(dqkvb), wide(wqkv))
    # ---- LayerNorm backward and residual ----
    if use_ln:
        dx, dln_w, dln_b = ln_bwd_rows(dh, xhat, rstd, ln_w)
        dln_w, dln_b = dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype)
    else:
        dx, (dln_w, dln_b) = dh, no_ln_grads(ln_w, ln_b)
    if residual:
        dx = dx + wide(g)
    return (dx.to(dt), dln_w, dln_b,
            dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwproj.to(wproj.dtype),
            dbproj.to(wproj.dtype))


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
                         num_heads: int, mode: str,
                         use_ln: bool = True) -> None:
    """Raise ValueError on anything the CUDA attention block does not take
    (bproj None: the backward, which does not read it). Its chains run the
    GEMM engine and the tensor-core core, so the row limit is
    ``core_max_rows``, and x, the weights and the biases must sit at
    16-byte-aligned addresses (the engine's TMA and vector loads)."""
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
    if C % 64 or num_heads < 1 or C % num_heads \
            or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes C % 64 == 0 and head "
                         f"dim in {HEAD_DIMS}, got C={C}, heads={num_heads}")
    limit = core_max_rows(num_heads)
    if not 1 <= B * F * J <= limit:
        raise ValueError(f"the attention block kernel takes 1..{limit} token "
                         f"rows (B*F*J) at {num_heads} heads, got {B * F * J}")
    dev, bf16 = x.device, torch.bfloat16
    check_tensor("x", x, (B, F, J, C), bf16, dev)
    check_ln_args(ln_w, ln_b, C, use_ln, dev)
    for name, t, shape in (("wqkv", wqkv, (3 * C, C)), ("bqkv", bqkv, (3 * C,)),
                           ("wproj", wproj, (C, C)), ("bproj", bproj, (C,))):
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


def block_library() -> ctypes.CDLL:
    """csrc/block_kernels.cu, loaded, with its argument types set."""
    lib = _build.load("block_kernels")
    if lib.mbt_attention_block.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        slots = ctypes.POINTER(vp)
        for fn, argtypes in (
                (lib.mbt_attention_block, [vp] * 10 + [i] * 5 + [f] + [i] * 3 + [vp]),
                (lib.mbt_attention_block_bwd, [slots] + [i] * 5 + [f] + [i] * 3 + [vp]),
                (lib.mbt_mlp_block, [vp] * 9 + [i] * 5 + [vp]),
                (lib.mbt_mlp_block_bwd, [slots] + [i] * 5 + [vp]),
                (lib.mbt_attention_bwd_slot_count, []),
                (lib.mbt_mlp_bwd_slot_count, [])):
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mbt_block_work_floats.argtypes = [i, i]
        lib.mbt_block_work_floats.restype = ctypes.c_longlong
        if lib.mbt_attention_bwd_slot_count() != len(ATTN_BWD_SLOTS):
            raise RuntimeError("block_kernels.cu and ATTN_BWD_SLOTS disagree "
                               "on the pointer slots")
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
