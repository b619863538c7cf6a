"""The DSTformer attention+MLP pair, and the pair with the att_fuse gate,
with their backward.

    y   = x + proj(attn(qkv(LN1 x)))      yb = y rounded to x's dtype
    out = yb + fc2(GELU(fc1(LN2 yb)))
    gated: out <- other * a0 + out * a1,  (a0, a1) = softmax(other.wg[:, :C]
                                                   + out.wg[:, C:] + bg)

``fused_pair_block`` and ``fused_gated_pair_block`` take x (B, F, J, C) and
are differentiable (``torch.autograd.Function``s ``FusedPair`` and
``FusedGatedPair``). On a CUDA tensor the forward launches the hand-written
kernel chain in ``csrc/pair_kernels.cu`` and the backward the chain in
``csrc/pair_bwd_kernels.cu`` (bf16, fp32 accumulation), or they raise; on a
CPU tensor they run the plain PyTorch versions beside them
(``pair_block_plain``, ``gated_pair_block_plain``, ``pair_block_bwd_plain``,
``gated_pair_block_bwd_plain``). The forward saves only its inputs and the
backward recomputes the pair, as the JAX package's custom VJP does, so a
pair keeps one (B, F, J, C) activation for its backward; a ``remat`` switch
(the JAX package's ``nn.remat``) would change nothing here and the port has
none. Each public wrapper counts its kernel launches in its ``launches``
attribute; the backward's recompute counts as a backward launch only.

Source note. The CUDA chains replace the TPU kernels
``motionbert_tpu/ops/fused_pair.py:_pair_pallas`` (``_pair_kernel``),
``motionbert_tpu/ops/fused_pair.py:fused_gated_pair_block``
(``_gated_pair_kernel`` + ``_gate_rows``) and
``motionbert_tpu/ops/fused_pair.py:_pair_bwd_pallas`` (``_pair_bwd_body``).
On the H100 the pair is bound by tensor-core operations (~4.7 MFLOP per
token against 2 KB of token I/O at the flagship shape; its backward, with the
recompute, about three times that). The TPU design keeps every weight
resident on chip, which 227 KB of shared memory cannot; the port runs chains
of GEMM, attention and row launches over the flattened rows and pays for the
intermediates in device memory; see the notes at the top of the ``.cu``
files. Both chains run their products on the wgmma + TMA engine
(``csrc/hopper_gemm.cuh``), so x, g and the weights and biases must sit at
16-byte-aligned addresses (they raise otherwise), and their attention core on
tensor cores (``csrc/attention_tc.cuh``); the forward's chain is
``csrc/pair_chain.cuh``, which the bf16 stream (``ops/fused_stream.py``)
shares. That core alone, forward and backward, is ``attention_core`` /
``attention_core_bwd`` (through the test entries of
``csrc/pair_bwd_kernels.cu``; plain twins ``st_attention_plain`` and
``st_attention_bwd_plain``).

Weights use nn.Linear's layout: wqkv (3C, C), wproj (C, C), w1 (hidden, C),
w2 (C, hidden), wg (2, 2C). LayerNorm weights stay fp32; everything else is
in the compute dtype. Gradients come back in their tensor's dtype: weights
and biases in the compute dtype, LayerNorm parameters in fp32. Activations
keep the JAX package's (B, F, J, C) layout.
"""

from __future__ import annotations

import ctypes

import torch

from motionbert_tpu_torch.ops import _build
from motionbert_tpu_torch.ops.attention import (
    HEAD_DIMS, MAX_FRAMES, NUM_JOINTS, attention_block,
    check_aligned, check_tensor as _check, core_max_rows,
    device_kind as _device_kind, from_groups, linear, ln_bwd_rows,
    ln_fwd_stats, rows as _rows, st_attention_bwd_plain, st_attention_plain,
    to_groups, weight_grad as _weight_grad, wide)
from motionbert_tpu_torch.ops.fused_mlp import mlp_block

# the 12 parameters of a pair, in argument order
PAIR_PARAMS = ("ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_w",
               "ln2_b", "w1", "b1", "w2", "b2")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def pair_block_plain(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                     w1, b1, w2, b2, num_heads: int, scale: float,
                     mode: str) -> torch.Tensor:
    yb = attention_block(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                         num_heads, scale, mode).to(x.dtype)
    return mlp_block(yb, ln2_w, ln2_b, w1, b1, w2, b2).to(x.dtype)


def gate_alpha(other: torch.Tensor, out: torch.Tensor, wg: torch.Tensor,
               bg: torch.Tensor) -> torch.Tensor:
    """The att_fuse gate's weights (..., 2): the softmax of fp32 logits,
    rounded to the compute dtype. wg[:, :C] scores ``other`` (the S->T
    stream)."""
    C = other.shape[-1]
    s = (torch.matmul(wide(other), wide(wg[:, :C]).t())
         + torch.matmul(wide(out), wide(wg[:, C:]).t()) + wide(bg))
    return torch.softmax(s, dim=-1).to(out.dtype)


def gate_plain(other: torch.Tensor, out: torch.Tensor, wg: torch.Tensor,
               bg: torch.Tensor) -> torch.Tensor:
    """att_fuse gate: fp32 logits, weights rounded to the compute dtype, mix
    in the compute dtype."""
    a = gate_alpha(other, out, wg, bg)
    return other * a[..., 0:1] + out * a[..., 1:2]


def gated_pair_block_plain(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                           ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                           num_heads: int, scale: float,
                           mode: str) -> torch.Tensor:
    out = pair_block_plain(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                           ln2_b, w1, b1, w2, b2, num_heads, scale, mode)
    return gate_plain(other, out, wg, bg)


def _pair_bwd_plain(x, other, g, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                    ln2_w, ln2_b, w1, b1, w2, b2, wg, bg, num_heads, scale,
                    mode) -> tuple:
    """The pair backward written out step by step at the rounding points of
    the JAX package's ``_pair_bwd_body``: the forward is recomputed (h1, qkv,
    P in fp32, attn, yb, h2, z in fp32, a), the gate's dsg is fp32 and
    rounded for its products, and dz, dyb, dattn, ds and dqkv are rounded to
    the compute dtype where the kernel rounds them (dbqkv sums fp32 dqkv)."""
    dt = x.dtype
    C = x.shape[-1]
    gated = other is not None
    # ---- forward recompute ----
    xhat1, rstd1, h1f = ln_fwd_stats(x, ln1_w, ln1_b)
    h1 = h1f.to(dt)
    qkv = linear(h1, wqkv, bqkv)
    q, k, v = (wide(to_groups(qkv[..., i * C:(i + 1) * C].to(dt), mode,
                              num_heads)) for i in range(3))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    pb = wide(p.to(dt))
    attn = from_groups(torch.matmul(pb, v).to(dt), mode)
    yb = (linear(attn, wproj, bproj) + wide(x)).to(dt)
    xhat2, rstd2, h2f = ln_fwd_stats(yb, ln2_w, ln2_b)
    h2 = h2f.to(dt)
    z = linear(h2, w1, b1)
    cdf = 0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
    a = (z * cdf).to(dt)

    # ---- att_fuse gate backward ----
    if gated:
        out_b = (linear(a, w2, b2) + wide(yb)).to(dt)
        sg = (torch.matmul(wide(other), wide(wg[:, :C]).t())
              + torch.matmul(wide(out_b), wide(wg[:, C:]).t()) + wide(bg))
        e = torch.exp(sg - sg.amax(-1, keepdim=True))
        alpha = e / e.sum(-1, keepdim=True)
        ga = wide(g)
        dal = torch.stack([(ga * wide(other)).sum(-1),
                           (ga * wide(out_b)).sum(-1)], -1)
        dsg = alpha * (dal - (dal * alpha).sum(-1, keepdim=True))
        dsgb = dsg.to(dt)
        dother = ga * alpha[..., 0:1] + torch.matmul(wide(dsgb),
                                                     wide(wg[:, :C]))
        dout = ga * alpha[..., 1:2] + torch.matmul(wide(dsgb),
                                                   wide(wg[:, C:]))
        dwg = torch.cat([_weight_grad(dsgb, other),
                         _weight_grad(dsgb, out_b)], -1)
        dbg = _rows(dsg).sum(0)
        gmlp = dout.to(dt)
    else:
        gmlp = g

    # ---- MLP backward ----
    dw2 = _weight_grad(gmlp, a)
    db2 = _rows(gmlp).sum(0)
    da = torch.matmul(wide(gmlp), wide(w2))
    pdf = torch.exp(-0.5 * z * z) * 0.3989422804014327
    dz = (da * (cdf + z * pdf)).to(dt)
    dw1 = _weight_grad(dz, h2)
    db1 = _rows(dz).sum(0)
    dh2 = torch.matmul(wide(dz), wide(w1))
    dy, dln2_w, dln2_b = ln_bwd_rows(dh2, xhat2, rstd2, ln2_w)
    dyb = (dy + wide(gmlp)).to(dt)

    # ---- attention backward ----
    dattn = torch.matmul(wide(dyb), wide(wproj))
    dwproj = _weight_grad(dyb, attn)
    dbproj = _rows(dyb).sum(0)
    dah = wide(to_groups(dattn.to(dt), mode, num_heads))
    dv = torch.matmul(pb.transpose(-1, -2), dah)
    dp = torch.matmul(dah, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = wide((ds * scale).to(dt))
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.cat([from_groups(t, mode) for t in (dq, dk, dv)], -1)
    dqkvb = dqkv.to(dt)
    dwqkv = _weight_grad(dqkvb, h1)
    dbqkv = _rows(dqkv).sum(0)
    dh1 = torch.matmul(wide(dqkvb), wide(wqkv))
    dx, dln1_w, dln1_b = ln_bwd_rows(dh1, xhat1, rstd1, ln1_w)
    dx = (dx + wide(dyb)).to(dt)

    grads = [dx] + ([dother.to(dt)] if gated else [])
    grads += [t.to(ref.dtype) for t, ref in (
        (dln1_w, ln1_w), (dln1_b, ln1_b), (dwqkv, wqkv), (dbqkv, bqkv),
        (dwproj, wproj), (dbproj, bproj), (dln2_w, ln2_w), (dln2_b, ln2_b),
        (dw1, w1), (db1, b1), (dw2, w2), (db2, b2))]
    if gated:
        grads += [dwg.to(wg.dtype), dbg.to(bg.dtype)]
    return tuple(grads)


def pair_block_bwd_plain(x, g, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                         ln2_w, ln2_b, w1, b1, w2, b2, num_heads: int,
                         scale: float, mode: str) -> tuple:
    """Gradients of ``pair_block_plain`` at x for the output gradient g:
    (dx, dln1_w, dln1_b, dwqkv, dbqkv, dwproj, dbproj, dln2_w, dln2_b, dw1,
    db1, dw2, db2)."""
    return _pair_bwd_plain(x, None, g, ln1_w, ln1_b, wqkv, bqkv, wproj,
                           bproj, ln2_w, ln2_b, w1, b1, w2, b2, None, None,
                           num_heads, scale, mode)


def gated_pair_block_bwd_plain(x, other, g, ln1_w, ln1_b, wqkv, bqkv, wproj,
                               bproj, ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                               num_heads: int, scale: float,
                               mode: str) -> tuple:
    """Gradients of ``gated_pair_block_plain``: (dx, dother, the 12 pair
    parameter gradients, dwg, dbg)."""
    return _pair_bwd_plain(x, other, g, ln1_w, ln1_b, wqkv, bqkv, wproj,
                           bproj, ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                           num_heads, scale, mode)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def check_kernel_args(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                      ln2_w, ln2_b, w1, b1, w2, b2, wg, bg, num_heads: int,
                      mode: str) -> None:
    """Raise ValueError on anything the CUDA pair kernels do not take: the
    bf16 chains (forward and backward) and the W8A8 chain
    (``ops/pair_q8.py``), all on the GEMM engine (bf16 or s8) and the
    tensor-core core. The engine walks its tiles with persistent blocks and
    takes any row count, so the core's 32-bit item count bounds the token
    rows (``core_max_rows``). Every chain reads x, other, the weights and
    the biases with vector loads (the engine's through TMA), so each must
    sit at a 16-byte-aligned address."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, F, J, C), got shape {tuple(x.shape)}")
    B, F, J, C = x.shape
    if mode not in ("spatial", "temporal"):
        raise ValueError(f"unknown attention mode: {mode!r}")
    if J != NUM_JOINTS:
        raise ValueError(f"the pair kernel takes J={NUM_JOINTS} joints, got {J}")
    if not 1 <= F <= MAX_FRAMES:
        raise ValueError(f"the pair kernel takes 1..{MAX_FRAMES} frames, "
                         f"got {F}")
    if C % 64 or num_heads < 1 or C % num_heads \
            or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"the pair kernel takes C % 64 == 0 and head dim in "
                         f"{HEAD_DIMS}, got C={C}, heads={num_heads}")
    limit = core_max_rows(num_heads)
    if not 1 <= B * F * J <= limit:
        raise ValueError(f"the pair kernel takes 1..{limit} token rows "
                         f"(B*F*J) at {num_heads} heads, got {B * F * J}")
    hidden = w1.shape[0]
    if hidden % 64:
        raise ValueError(f"hidden width must be a multiple of 64, got {hidden}")
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, (B, F, J, C), bf16, dev)
    if other is not None:
        _check("other", other, (B, F, J, C), bf16, dev)
        _check("wg", wg, (2, 2 * C), bf16, dev)
        _check("bg", bg, (2,), bf16, dev)
    for name, t in (("ln1_w", ln1_w), ("ln1_b", ln1_b), ("ln2_w", ln2_w),
                    ("ln2_b", ln2_b)):
        _check(name, t, (C,), f32, dev)
    for name, t, shape in (("wqkv", wqkv, (3 * C, C)), ("bqkv", bqkv, (3 * C,)),
                           ("wproj", wproj, (C, C)), ("bproj", bproj, (C,)),
                           ("w1", w1, (hidden, C)), ("b1", b1, (hidden,)),
                           ("w2", w2, (C, hidden)), ("b2", b2, (C,))):
        _check(name, t, shape, bf16, dev)
    for name, t in (("x", x), ("other", other), ("wqkv", wqkv),
                    ("bqkv", bqkv), ("wproj", wproj), ("bproj", bproj),
                    ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
                    ("wg", wg), ("bg", bg)):
        if t is not None:
            check_aligned(name, t)


_ARGTYPES = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

# mbt_pair_block_bwd's pointer array, in the order of the Slot enum in
# csrc/pair_bwd_kernels.cu: inputs, outputs, scratch
BWD_SLOTS = (
    "x", "other", "g", *PAIR_PARAMS, "wg", "bg",
    "dx", "dother", *(f"d{k}" for k in PAIR_PARAMS), "dwg", "dbg",
    "h1", "st1", "qkv", "attn", "yb", "h2", "st2", "z", "a", "outb", "gmlp",
    "dsg", "dh", "dyb", "dqkv", "dqkvb", "work")
_BWD_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = _build.load("pair_kernels")
    fn = lib.mbt_pair_block
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("pair_bwd_kernels")
    fn = lib.mbt_pair_block_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
        lib.mbt_pair_bwd_slot_count.argtypes = []
        lib.mbt_pair_bwd_slot_count.restype = ctypes.c_int
        lib.mbt_pair_bwd_work_floats.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.mbt_pair_bwd_work_floats.restype = ctypes.c_longlong
        if lib.mbt_pair_bwd_slot_count() != len(BWD_SLOTS):
            raise RuntimeError("pair_bwd_kernels.cu and BWD_SLOTS disagree "
                               "on the pointer slots")
    return lib


def _launch(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
            w1, b1, w2, b2, wg, bg, num_heads, scale, mode) -> torch.Tensor:
    check_kernel_args(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                      ln2_w, ln2_b, w1, b1, w2, b2, wg, bg, num_heads, mode)
    B, F, J, C = x.shape
    hidden = w1.shape[0]
    M = B * F * J
    lib = _library()
    with torch.cuda.device(x.device):
        scratch = lambda n: torch.empty((M, n), dtype=x.dtype, device=x.device)
        qkv, attn, y, hid = scratch(3 * C), scratch(C), scratch(C), \
            scratch(hidden)
        pair_out = scratch(C) if other is not None else None
        out = torch.empty_like(x)
        ptr = lambda t: None if t is None else t.data_ptr()
        rc = lib.mbt_pair_block(
            ptr(x), ptr(other), ptr(out), ptr(qkv), ptr(attn), ptr(y),
            ptr(hid), ptr(pair_out), ptr(ln1_w), ptr(ln1_b), ptr(wqkv),
            ptr(bqkv), ptr(wproj), ptr(bproj), ptr(ln2_w), ptr(ln2_b),
            ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(wg), ptr(bg),
            B, F, J, C, num_heads, hidden, float(scale),
            int(mode == "temporal"),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pair kernel launch failed with CUDA error {rc}")
    return out


def _launch_bwd(x, other, g, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                ln2_b, w1, b1, w2, b2, wg, bg, num_heads, scale,
                mode) -> tuple:
    check_kernel_args(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                      ln2_w, ln2_b, w1, b1, w2, b2, wg, bg, num_heads, mode)
    _check("g", g, x.shape, x.dtype, x.device)
    check_aligned("g", g)
    B, F, J, C = x.shape
    hidden = w1.shape[0]
    M = B * F * J
    gated = other is not None
    lib = _bwd_library()
    dev = x.device
    with torch.cuda.device(dev):
        bf = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device=dev)
        f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
        when = lambda t: t if gated else None
        t = dict(zip(("x", "other", "g", *PAIR_PARAMS, "wg", "bg"),
                     (x, other, g, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                      ln2_w, ln2_b, w1, b1, w2, b2, wg, bg)))
        t.update(
            dx=torch.empty_like(x), dother=when(torch.empty_like(x)),
            dln1_w=f32(C), dln1_b=f32(C), dwqkv=bf(3 * C, C), dbqkv=bf(3 * C),
            dwproj=bf(C, C), dbproj=bf(C), dln2_w=f32(C), dln2_b=f32(C),
            dw1=bf(hidden, C), db1=bf(hidden), dw2=bf(C, hidden), db2=bf(C),
            dwg=when(bf(2, 2 * C)), dbg=when(bf(2)),
            h1=bf(M, C), st1=f32(M, 2), qkv=bf(M, 3 * C), attn=bf(M, C),
            yb=bf(M, C), h2=bf(M, C), st2=f32(M, 2), z=f32(M, hidden),
            a=bf(M, hidden), outb=when(bf(M, C)), gmlp=when(bf(M, C)),
            dsg=when(f32(M, 2)), dh=f32(M, C), dyb=bf(M, C),
            dqkv=f32(M, 3 * C), dqkvb=bf(M, 3 * C),
            work=f32(lib.mbt_pair_bwd_work_floats(C, hidden)))
        ptrs = (ctypes.c_void_p * len(BWD_SLOTS))(
            *(None if t[k] is None else t[k].data_ptr() for k in BWD_SLOTS))
        rc = lib.mbt_pair_block_bwd(
            ptrs, B, F, J, C, num_heads, hidden, float(scale),
            int(mode == "temporal"), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pair backward kernel launch failed with CUDA "
                           f"error {rc}")
    names = ["dx"] + (["dother"] if gated else []) \
        + [f"d{k}" for k in PAIR_PARAMS] + (["dwg", "dbg"] if gated else [])
    return tuple(t[n] for n in names)


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def fused_pair_block_bwd(x, g, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                         ln2_b, w1, b1, w2, b2, num_heads: int, scale: float,
                         mode: str) -> tuple:
    """The pair's gradients (as ``pair_block_bwd_plain`` orders them): the
    CUDA backward chain for a CUDA tensor, the plain backward for a CPU
    tensor."""
    args = (x, g, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1,
            b1, w2, b2, num_heads, scale, mode)
    if _device_kind(x) == "cpu":
        return pair_block_bwd_plain(*args)
    grads = _launch_bwd(x, None, g, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                        ln2_w, ln2_b, w1, b1, w2, b2, None, None, num_heads,
                        scale, mode)
    fused_pair_block_bwd.launches += 1
    return grads


fused_pair_block_bwd.launches = 0


def fused_gated_pair_block_bwd(x, other, g, ln1_w, ln1_b, wqkv, bqkv, wproj,
                               bproj, ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                               num_heads: int, scale: float,
                               mode: str) -> tuple:
    """The gated pair's gradients (as ``gated_pair_block_bwd_plain`` orders
    them): the CUDA backward chain for a CUDA tensor, the plain backward for
    a CPU tensor."""
    args = (x, other, g, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
            ln2_b, w1, b1, w2, b2, wg, bg, num_heads, scale, mode)
    if _device_kind(x) == "cpu":
        return gated_pair_block_bwd_plain(*args)
    grads = _launch_bwd(*args)
    fused_gated_pair_block_bwd.launches += 1
    return grads


fused_gated_pair_block_bwd.launches = 0


class FusedPair(torch.autograd.Function):
    """``fused_pair_block`` with its backward. Saves only the inputs; the
    backward recomputes the pair."""

    @staticmethod
    def forward(ctx, x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                w1, b1, w2, b2, num_heads, scale, mode):
        params = (ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1,
                  b1, w2, b2)
        ctx.save_for_backward(x, *params)
        ctx.cfg = (num_heads, scale, mode)
        if _device_kind(x) == "cpu":
            return pair_block_plain(x, *params, num_heads, scale, mode)
        out = _launch(x, None, *params, None, None, num_heads, scale, mode)
        fused_pair_block.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        grads = fused_pair_block_bwd(x, g.contiguous(), *params, *ctx.cfg)
        return (*grads, None, None, None)


class FusedGatedPair(torch.autograd.Function):
    """``fused_gated_pair_block`` with its backward. Saves only the inputs;
    the backward recomputes the pair and the gate."""

    @staticmethod
    def forward(ctx, x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                ln2_b, w1, b1, w2, b2, wg, bg, num_heads, scale, mode):
        params = (ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1,
                  b1, w2, b2)
        ctx.save_for_backward(x, other, *params, wg, bg)
        ctx.cfg = (num_heads, scale, mode)
        if _device_kind(x) == "cpu":
            return gated_pair_block_plain(x, other, *params, wg, bg,
                                          num_heads, scale, mode)
        out = _launch(x, other, *params, wg, bg, num_heads, scale, mode)
        fused_gated_pair_block.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, other, *rest = ctx.saved_tensors
        grads = fused_gated_pair_block_bwd(x, other, g.contiguous(), *rest,
                                           *ctx.cfg)
        return (*grads, None, None, None)


def fused_pair_block(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                     w1, b1, w2, b2, num_heads: int, scale: float,
                     mode: str) -> torch.Tensor:
    """LN1 -> qkv -> attention -> proj -> +x -> LN2 -> fc1 -> GELU -> fc2
    -> +y on x (B, F, J, C), differentiable: the CUDA kernels for a CUDA
    tensor, the plain versions for a CPU tensor."""
    return FusedPair.apply(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                           ln2_b, w1, b1, w2, b2, num_heads, scale, mode)


fused_pair_block.launches = 0


def fused_gated_pair_block(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                           ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                           num_heads: int, scale: float,
                           mode: str) -> torch.Tensor:
    """fused_pair_block followed by the att_fuse gate against ``other``,
    differentiable in x, other and every parameter: the CUDA kernels for a
    CUDA tensor, the plain versions for a CPU tensor. wg (2, 2C) with
    columns [:C] scoring ``other``; bg (2,)."""
    return FusedGatedPair.apply(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj,
                                bproj, ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                                num_heads, scale, mode)


fused_gated_pair_block.launches = 0


# ---------------------------------------------------------------------------
# the pair backward's tensor-core attention core alone
# ---------------------------------------------------------------------------

# what csrc/attention_tc.cuh takes, by the names mbt_attn_core_constant
# (csrc/pair_bwd_kernels.cu) maps to its constants: groups of up to
# max_keys rows, padded to key_tile rows times a power of two
CORE_CONSTANTS = {"max_keys": 256, "key_tile": 16}


def core_key_tiles(n: int) -> int:
    """Key tiles (of ``key_tile`` rows) the core pads a group of n rows to:
    a power of two, which picks the kernel instantiation that runs."""
    kt = 1
    while kt * CORE_CONSTANTS["key_tile"] < n:
        kt *= 2
    return kt


def check_core_args(q, k, v, g, num_heads: int, mode: str) -> None:
    """Raise ValueError on anything the tensor-core core does not take."""
    if mode not in ("spatial", "temporal"):
        raise ValueError(f"unknown attention mode: {mode!r}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, F, J, C), got shape {tuple(q.shape)}")
    B, F, J, C = q.shape
    n = F if mode == "temporal" else J
    if not 1 <= n <= CORE_CONSTANTS["max_keys"]:
        raise ValueError(f"the tensor-core core takes groups of 1.."
                         f"{CORE_CONSTANTS['max_keys']} rows, got {n}")
    if num_heads < 1 or C % num_heads or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"the tensor-core core takes a head dim in "
                         f"{HEAD_DIMS}, got C={C}, heads={num_heads}")
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if t is not None:
            _check(name, t, (B, F, J, C), torch.bfloat16, q.device)
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the tensor-core core copies "
                                 f"16-byte chunks and needs a 16-byte-"
                                 f"aligned address")


def _core_library() -> ctypes.CDLL:
    lib = _bwd_library()
    if lib.mbt_attn_core_test.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mbt_attn_core_test.argtypes = [vp] * 4 + [i] * 5 + [f, i, vp]
        lib.mbt_attn_core_bwd_test.argtypes = [vp] * 7 + [i] * 5 + [f, i, vp]
        lib.mbt_attn_core_constant.argtypes = [ctypes.c_char_p]
        for fn in (lib.mbt_attn_core_test, lib.mbt_attn_core_bwd_test,
                   lib.mbt_attn_core_constant):
            fn.restype = i
    drift = {name: (value, lib.mbt_attn_core_constant(name.encode()))
             for name, value in CORE_CONSTANTS.items()
             if lib.mbt_attn_core_constant(name.encode()) != value}
    if drift:
        raise RuntimeError(f"fused_pair's core constants disagree with the "
                           f"library's (ours, the library's): {drift}")
    return lib


def attention_core(q, k, v, mode: str, num_heads: int,
                   scale: float) -> torch.Tensor:
    """The pair backward's forward attention core on (B, F, J, C) q, k, v:
    one launch of the tensor-core kernel on CUDA tensors (counted in
    ``attention_core.launches``), ``st_attention_plain`` on CPU tensors."""
    if _device_kind(q, "attention core") == "cpu":
        return st_attention_plain(q, k, v, mode, num_heads, scale)
    check_core_args(q, k, v, None, num_heads, mode)
    B, F, J, C = q.shape
    lib = _core_library()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        rc = lib.mbt_attn_core_test(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, F, J,
            C, num_heads, float(scale), int(mode == "temporal"),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tensor-core attention core launch failed with "
                           f"CUDA error {rc}")
    attention_core.launches += 1
    return out


attention_core.launches = 0


def attention_core_bwd(q, k, v, g, mode: str, num_heads: int,
                       scale: float) -> tuple:
    """(dq, dk, dv) of ``attention_core`` for the output gradient g: one
    launch of the tensor-core backward on CUDA tensors (counted in
    ``attention_core_bwd.launches``), ``st_attention_bwd_plain`` on CPU
    tensors."""
    if _device_kind(q, "attention core") == "cpu":
        return st_attention_bwd_plain(q, k, v, g, mode, num_heads, scale)
    check_core_args(q, k, v, g, num_heads, mode)
    B, F, J, C = q.shape
    lib = _core_library()
    with torch.cuda.device(q.device):
        bf = [torch.empty_like(q) for _ in range(3)]
        rc = lib.mbt_attn_core_bwd_test(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            *(t.data_ptr() for t in bf), B, F, J, C, num_heads,
            float(scale), int(mode == "temporal"),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tensor-core attention core backward launch "
                           f"failed with CUDA error {rc}")
    attention_core_bwd.launches += 1
    return tuple(bf)


attention_core_bwd.launches = 0
