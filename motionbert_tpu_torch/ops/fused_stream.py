"""One DSTformer stream: both attention+MLP pairs of a stream, in the order
("s", "t") or ("t", "s"), and in the gated variant the att_fuse gate against
the twin stream, in bf16 or in the W8A8 tier.

    mid = pair_1(x)          the inter-pair activation, in x's dtype
    out = pair_2(mid)        gated: gate(other, pair_2(mid))

``fused_stream_block`` and ``fused_gated_stream_block`` (``torch.autograd.
Function``s ``FusedStream`` and ``FusedGatedStream``), and their W8A8 twins
``fused_stream_block_q8`` and ``fused_gated_stream_block_q8``, take the JAX
package's arguments: x (B, F, J, C), [other,] pass 1's 12 parameters and
pass 2's 12 in ``PAIR_PARAMS`` order, [wg, bg,] num_heads, scale, order, with
the weights in nn.Linear's layout as the pair functions take them. On a CUDA
tensor they launch the hand-written kernel in ``csrc/stream_kernels.cu`` or
raise; on a CPU tensor they run the plain versions beside them
(``stream_block_plain``, ``gated_stream_block_plain``,
``stream_block_q8_plain``, ``gated_stream_block_q8_plain``), each the
composition of the port's plain pairs at their rounding points. Each wrapper
counts its launches in ``launches``.

The backward is the JAX package's VJP: recompute pass 1 with the bf16 pair
kernel (B1's launch, counted by the stream's backward and not as a pair
forward), then the pair backward (B3) twice, the gated one for pass 2 when
gated. The W8A8 Functions take the bf16 stream's backward unchanged
(straight-through), as the q8 pairs do. The forward saves only its inputs.
``fused_stream_block_bwd`` and ``fused_gated_stream_block_bwd`` count their
calls on the card; the B3 launches inside them count as the pair
backward's.

Source note. The kernel replaces the TPU kernel
``motionbert_tpu/ops/fused_stream.py:_stream_pallas`` (``_stream_kernel``).
On the TPU it keeps the whole clip resident in VMEM, so that the inter-pair
activation never reaches HBM. On the H100 neither the clip (4.2 MB per
(F, J*C) bf16 block at the flagship shape) nor one pair's weights (4 MiB)
fit an SM's 227 KB of shared memory, so the kernel runs both pairs' chains
over one workspace, and its outputs are the pair chains' bits; bound and
design are in the note at the top of the ``.cu`` file. Not ported, because
they are Mosaic's layout and VMEM machinery and mean nothing here:
``STREAM_TF``, ``STREAM_BUDGET``, ``_pick_stream_groups``, ``_pad_rows``,
``_same_frame_mask_jmajor`` and the pair fallback
``_stream_pairs_fallback``. The kernel takes every shape the pair kernels
take (F in 1..243) and raises beyond that, as they do, so there is nothing
to fall back from; the JAX package's fallback for F < 16 computes the pair
path, which is what the port computes for every F.
"""

from __future__ import annotations

import ctypes

import torch

from motionbert_tpu_torch.ops import _build
from motionbert_tpu_torch.ops import fused_pair as fp
from motionbert_tpu_torch.ops.attention import device_kind
from motionbert_tpu_torch.ops.pair_q8 import (
    gated_pair_block_q8_plain, pair_block_q8_plain, quant_cols)

N_PARAMS = len(fp.PAIR_PARAMS)
ORDERS = (("s", "t"), ("t", "s"))
# indices of the four weights in a pair's parameters, which the W8A8 chain
# takes quantised (int8 + per-output-channel scale)
_WEIGHTS = (2, 4, 8, 10)


def _modes(order) -> tuple:
    order = tuple(order)
    if order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, got {order!r}")
    return tuple("spatial" if a == "s" else "temporal" for a in order)


def _split(args, gated: bool) -> tuple:
    """(p1, p2, wg, bg, num_heads, scale, order) from a wrapper's arguments
    after x [and other]."""
    n = 2 * N_PARAMS + (2 if gated else 0) + 3
    if len(args) != n:
        raise TypeError(f"expected {n} arguments after x"
                        f"{' and other' if gated else ''}, got {len(args)}")
    p1, p2 = tuple(args[:N_PARAMS]), tuple(args[N_PARAMS:2 * N_PARAMS])
    wg, bg = args[2 * N_PARAMS:2 * N_PARAMS + 2] if gated else (None, None)
    num_heads, scale, order = args[-3:]
    return p1, p2, wg, bg, num_heads, scale, tuple(order)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _compose(pair_fn, gated_fn, x, other, p1, p2, wg, bg, num_heads, scale,
             order) -> torch.Tensor:
    m1, m2 = _modes(order)
    mid = pair_fn(x, *p1, num_heads, scale, m1)
    if other is None:
        return pair_fn(mid, *p2, num_heads, scale, m2)
    return gated_fn(mid, other, *p2, wg, bg, num_heads, scale, m2)


def stream_block_plain(x, *args) -> torch.Tensor:
    """The stream as two plain pairs. args: pass 1's 12 parameters, pass 2's
    12, num_heads, scale, order."""
    p1, p2, _, _, h, s, order = _split(args, False)
    return _compose(fp.pair_block_plain, fp.gated_pair_block_plain, x, None,
                    p1, p2, None, None, h, s, order)


def gated_stream_block_plain(x, other, *args) -> torch.Tensor:
    """The gated stream: two plain pairs, the second gated. args: pass 1's 12
    parameters, pass 2's 12, wg, bg, num_heads, scale, order."""
    p1, p2, wg, bg, h, s, order = _split(args, True)
    return _compose(fp.pair_block_plain, fp.gated_pair_block_plain, x, other,
                    p1, p2, wg, bg, h, s, order)


def stream_block_q8_plain(x, *args) -> torch.Tensor:
    """The W8A8 stream as two plain W8A8 pairs (``stream_block_plain``'s
    arguments)."""
    p1, p2, _, _, h, s, order = _split(args, False)
    return _compose(pair_block_q8_plain, gated_pair_block_q8_plain, x, None,
                    p1, p2, None, None, h, s, order)


def gated_stream_block_q8_plain(x, other, *args) -> torch.Tensor:
    """The gated W8A8 stream (``gated_stream_block_plain``'s arguments)."""
    p1, p2, wg, bg, h, s, order = _split(args, True)
    return _compose(pair_block_q8_plain, gated_pair_block_q8_plain, x, other,
                    p1, p2, wg, bg, h, s, order)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_void_p)] * 2
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_Q8_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_void_p)] * 2
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = _build.load("stream_kernels")
    if lib.mbt_stream_block.argtypes is None:
        lib.mbt_stream_block.argtypes = _ARGTYPES
        lib.mbt_stream_block.restype = ctypes.c_int
        lib.mbt_stream_block_q8.argtypes = _Q8_ARGTYPES
        lib.mbt_stream_block_q8.restype = ctypes.c_int
    return lib


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _quantised(p: tuple) -> tuple:
    """A pair's 12 parameters -> the W8A8 chain's 16: each of the four
    weights becomes its int8 values and fp32 scales, as the TPU stream
    quantises outside its kernel."""
    out = []
    for i, t in enumerate(p):
        out += list(quant_cols(t)) if i in _WEIGHTS else [t]
    return tuple(out)


def _launch(x, other, p1, p2, wg, bg, num_heads, scale, order,
            q8: bool) -> torch.Tensor:
    m1, m2 = _modes(order)
    # the pair kernels' conditions hold for each pass (the W8A8 chain has
    # the same ones, ops/pair_q8.py)
    fp.check_kernel_args(x, None, *p1, None, None, num_heads, m1)
    fp.check_kernel_args(x, other, *p2, wg, bg, num_heads, m2)
    hidden = p1[8].shape[0]
    if p2[8].shape[0] != hidden:
        raise ValueError(f"the two pairs of a stream share one hidden width, "
                         f"got {hidden} and {p2[8].shape[0]}")
    B, F, J, C = x.shape
    M = B * F * J
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        empty = lambda n, dtype=x.dtype: torch.empty((M, n), dtype=dtype,
                                                     device=dev)
        out = torch.empty_like(x)
        mid, qkv, attn, y = empty(C), empty(3 * C), empty(C), empty(C)
        ptr = lambda t: None if t is None else t.data_ptr()
        stream = torch.cuda.current_stream(dev).cuda_stream
        dims = (B, F, J, C, num_heads, hidden, float(scale),
                int(m1 == "temporal"), stream)
        if q8:
            q1, q2 = _quantised(p1), _quantised(p2)
            a8 = empty(max(C, hidden), torch.int8)
            ascale = torch.empty((M,), dtype=torch.float32, device=dev)
            act = empty(hidden, torch.float32)
            rc = lib.mbt_stream_block_q8(
                ptr(x), ptr(other), ptr(out), ptr(mid), ptr(a8), ptr(ascale),
                ptr(qkv), ptr(attn), ptr(y), ptr(act), _pointers(q1),
                _pointers(q2), ptr(wg), ptr(bg), *dims)
        else:
            hid = empty(hidden)
            rc = lib.mbt_stream_block(
                ptr(x), ptr(other), ptr(out), ptr(mid), ptr(qkv), ptr(attn),
                ptr(y), ptr(hid), _pointers(p1), _pointers(p2), ptr(wg),
                ptr(bg), *dims)
    if rc != 0:
        raise RuntimeError(f"stream kernel launch failed with CUDA error {rc}")
    return out


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _stream_bwd(x, other, g, p1, p2, wg, bg, num_heads, scale,
                order) -> tuple:
    """(dx, [dother,] pass 1's 12 gradients, pass 2's 12, [dwg, dbg])."""
    m1, m2 = _modes(order)
    if device_kind(x, "stream") == "cpu":
        mid = fp.pair_block_plain(x, *p1, num_heads, scale, m1)
    else:
        mid = fp._launch(x, None, *p1, None, None, num_heads, scale, m1)
    if other is None:
        g2 = fp.fused_pair_block_bwd(mid, g, *p2, num_heads, scale, m2)
        rest2, extra = g2[1:], ()
    else:
        g2 = fp.fused_gated_pair_block_bwd(mid, other, g, *p2, wg, bg,
                                           num_heads, scale, m2)
        rest2, extra = g2[2:2 + N_PARAMS], g2[2 + N_PARAMS:]
    g1 = fp.fused_pair_block_bwd(x, g2[0], *p1, num_heads, scale, m1)
    head = (g1[0],) if other is None else (g1[0], g2[1])
    return head + tuple(g1[1:]) + tuple(rest2) + tuple(extra)


def fused_stream_block_bwd(x, g, *args) -> tuple:
    """The stream's gradients at x for the output gradient g: (dx, pass 1's
    12 parameter gradients, pass 2's 12). args: as ``stream_block_plain``."""
    p1, p2, _, _, h, s, order = _split(args, False)
    grads = _stream_bwd(x, None, g, p1, p2, None, None, h, s, order)
    if device_kind(x, "stream") == "cuda":
        fused_stream_block_bwd.launches += 1
    return grads


fused_stream_block_bwd.launches = 0


def fused_gated_stream_block_bwd(x, other, g, *args) -> tuple:
    """The gated stream's gradients: (dx, dother, pass 1's 12 parameter
    gradients, pass 2's 12, dwg, dbg). args: as
    ``gated_stream_block_plain``."""
    p1, p2, wg, bg, h, s, order = _split(args, True)
    grads = _stream_bwd(x, other, g, p1, p2, wg, bg, h, s, order)
    if device_kind(x, "stream") == "cuda":
        fused_gated_stream_block_bwd.launches += 1
    return grads


fused_gated_stream_block_bwd.launches = 0


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def _forward(ctx, wrapper, plain, q8: bool, x, other, args) -> torch.Tensor:
    gated = other is not None
    p1, p2, wg, bg, h, s, order = _split(args, gated)
    _modes(order)
    tensors = (x,) + ((other,) if gated else ()) + p1 + p2 \
        + ((wg, bg) if gated else ())
    ctx.save_for_backward(*tensors)
    ctx.cfg = (h, s, order)
    if device_kind(x, "stream") == "cpu":
        return plain(*tensors, h, s, order)
    out = _launch(x, other, p1, p2, wg, bg, h, s, order, q8)
    wrapper.launches += 1
    return out


def _backward(ctx, g, gated: bool) -> tuple:
    saved = ctx.saved_tensors
    bwd = fused_gated_stream_block_bwd if gated else fused_stream_block_bwd
    return (*bwd(*saved[:1 + gated], g.contiguous(), *saved[1 + gated:],
                 *ctx.cfg), None, None, None)


class FusedStream(torch.autograd.Function):
    """``fused_stream_block`` with its backward (module note)."""

    @staticmethod
    def forward(ctx, x, *args):
        return _forward(ctx, fused_stream_block, stream_block_plain, False, x,
                        None, args)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, False)


class FusedGatedStream(torch.autograd.Function):
    """``fused_gated_stream_block`` with its backward (module note)."""

    @staticmethod
    def forward(ctx, x, other, *args):
        return _forward(ctx, fused_gated_stream_block,
                        gated_stream_block_plain, False, x, other, args)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, True)


class FusedStreamQ8(torch.autograd.Function):
    """``fused_stream_block_q8``: the W8A8 forward, the bf16 stream's
    backward (straight-through)."""

    @staticmethod
    def forward(ctx, x, *args):
        return _forward(ctx, fused_stream_block_q8, stream_block_q8_plain,
                        True, x, None, args)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, False)


class FusedGatedStreamQ8(torch.autograd.Function):
    """``fused_gated_stream_block_q8``: the W8A8 forward, the bf16 gated
    stream's backward (straight-through)."""

    @staticmethod
    def forward(ctx, x, other, *args):
        return _forward(ctx, fused_gated_stream_block_q8,
                        gated_stream_block_q8_plain, True, x, other, args)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, True)


def fused_stream_block(x, *args) -> torch.Tensor:
    """One stream on x (B, F, J, C), differentiable: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor. args: pass 1's 12
    parameters and pass 2's 12 (``PAIR_PARAMS`` order), num_heads, scale,
    order ("s", "t") or ("t", "s")."""
    return FusedStream.apply(x, *args)


fused_stream_block.launches = 0


def fused_gated_stream_block(x, other, *args) -> torch.Tensor:
    """``fused_stream_block`` followed by the att_fuse gate against
    ``other``. args: pass 1's 12 parameters, pass 2's 12, wg (2, 2C) with
    columns [:C] scoring ``other``, bg (2,), num_heads, scale, order."""
    return FusedGatedStream.apply(x, other, *args)


fused_gated_stream_block.launches = 0


def fused_stream_block_q8(x, *args) -> torch.Tensor:
    """The W8A8 forward of ``fused_stream_block``, same arguments (the
    full-precision weights; quantisation is internal); the gradients are the
    bf16 stream's."""
    return FusedStreamQ8.apply(x, *args)


fused_stream_block_q8.launches = 0


def fused_gated_stream_block_q8(x, other, *args) -> torch.Tensor:
    """The W8A8 forward of ``fused_gated_stream_block``, same arguments; the
    gate stays in the compute dtype."""
    return FusedGatedStreamQ8.apply(x, other, *args)


fused_gated_stream_block_q8.launches = 0
