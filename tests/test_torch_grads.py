"""The port's pair backward (motionbert_tpu_torch.ops.fused_pair) against the
JAX package's: ``jax.vjp`` of the Pallas pair kernels (their custom VJP runs
``_pair_bwd_pallas``, interpreted on the CPU) and of the XLA reference
compositions; and the autograd Functions around the port's wrappers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionbert_tpu.ops import fused_pair as jpair
from motionbert_tpu_torch.ops import fused_pair as tpair

B, F, J, C, H = 2, 9, 17, 32, 4
SCALE = (C // H) ** -0.5
# fp32 on the CPU on both sides; the sums run in different orders and the
# Pallas GELU uses a polynomial erf (|err| <= 1.5e-7)
TOL = dict(atol=1e-4, rtol=1e-4)
_ORDER = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_s",
          "ln2_b", "w1", "b1", "w2", "b2")
_DENSE = ("wqkv", "wproj", "w1", "w2", "wg")


def _mk(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def _inputs(gated):
    """Pair inputs and an output gradient in the JAX package's layout (Dense
    kernels (in, out))."""
    p = dict(x=_mk((B, F, J, C), 0),
             ln1_s=_mk((C,), 1, 0.1, 1.0), ln1_b=_mk((C,), 2, 0.1),
             wqkv=_mk((C, 3 * C), 3, 0.1), bqkv=_mk((3 * C,), 4, 0.1),
             wproj=_mk((C, C), 5, 0.1), bproj=_mk((C,), 6, 0.1),
             ln2_s=_mk((C,), 7, 0.1, 1.0), ln2_b=_mk((C,), 8, 0.1),
             w1=_mk((C, 2 * C), 9, 0.1), b1=_mk((2 * C,), 10, 0.1),
             w2=_mk((2 * C, C), 11, 0.1), b2=_mk((C,), 12, 0.1))
    if gated:
        p.update(other=_mk((B, F, J, C), 20), wg=_mk((2 * C, 2), 13, 0.3),
                 bg=_mk((2,), 14, 0.1, 0.5))
    return p, _mk((B, F, J, C), 30)


def _names(gated):
    return ["x"] + (["other"] if gated else []) + list(_ORDER) \
        + (["wg", "bg"] if gated else [])


def _jax_grads(p, g, gated, impl, dtype=jnp.float32):
    if gated:
        fn = jpair.fused_gated_pair_block if impl == "pallas" \
            else jpair._gated_pair_xla
    else:
        fn = jpair.fused_pair_block if impl == "pallas" else jpair._pair_xla
    args = [jnp.asarray(p[k]) if k.startswith("ln") else
            jnp.asarray(p[k]).astype(dtype) for k in _names(gated)]
    gj = jnp.asarray(g).astype(dtype)
    return lambda mode: jax.jit(lambda *a: jax.vjp(
        lambda *b: fn(*b, H, SCALE, mode), *a)[1](gj))(*args)


def _torch_args(p, gated, dtype=torch.float32):
    out = []
    for k in _names(gated):
        a = p[k].T if k in _DENSE else p[k]
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append(t if k.startswith("ln") else t.to(dtype))
    return out


def _as_jax_layout(name, t):
    a = t.float().numpy()
    return a.T if name in _DENSE else a


def _plain_bwd(args, g, gated, mode):
    fn = tpair.gated_pair_block_bwd_plain if gated \
        else tpair.pair_block_bwd_plain
    x, rest = args[0], args[1:]
    if gated:
        return fn(x, rest[0], g, *rest[1:], H, SCALE, mode)
    return fn(x, g, *rest, H, SCALE, mode)


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_plain_bwd_matches_jax_fp32(mode, gated, jax_impl):
    p, g = _inputs(gated)
    ref = _jax_grads(p, g, gated, jax_impl)(mode)
    out = _plain_bwd(_torch_args(p, gated), torch.from_numpy(g), gated, mode)
    assert len(out) == len(ref) == len(_names(gated))
    for name, o, r in zip(_names(gated), out, ref):
        assert o.dtype == torch.float32, name
        np.testing.assert_allclose(_as_jax_layout(name, o), np.asarray(r),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("gated", [False, True])
def test_plain_bwd_bf16_tracks_pallas_bf16(gated):
    """In bf16 the plain backward keeps the Pallas backward's rounding points,
    so the two differ by bf16 rounding flips; the bar is the one chip_smoke.py
    holds the CUDA backward to (2e-2 of max|ref| per tensor)."""
    p, g = _inputs(gated)
    jgrad = _jax_grads(p, g, gated, "pallas", jnp.bfloat16)
    args = _torch_args(p, gated, torch.bfloat16)
    for mode in ("spatial", "temporal"):
        ref = jgrad(mode)
        out = _plain_bwd(args, torch.from_numpy(g).bfloat16(), gated, mode)
        for name, o, r in zip(_names(gated), out, ref):
            want = torch.float32 if name.startswith("ln") else torch.bfloat16
            assert o.dtype == want, name
            r = np.asarray(r.astype(jnp.float32))
            err = np.abs(_as_jax_layout(name, o) - r).max() / np.abs(r).max()
            assert err <= 2e-2, (mode, name, err)


def _wrapper(gated):
    return tpair.fused_gated_pair_block if gated else tpair.fused_pair_block


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_grad_is_the_plain_bwd(gated, dtype):
    p, g = _inputs(gated)
    args = [a.requires_grad_() for a in _torch_args(p, gated, dtype)]
    gt = torch.from_numpy(g).to(dtype)
    for mode in ("spatial", "temporal"):
        out = _wrapper(gated)(*args, H, SCALE, mode)
        grads = torch.autograd.grad(out, args, gt)
        ref = _plain_bwd([a.detach() for a in args], gt, gated, mode)
        for name, a, r in zip(_names(gated), grads, ref):
            assert a.dtype == r.dtype and torch.equal(a, r), (mode, name)


@pytest.mark.parametrize("gated", [False, True])
def test_function_grad_matches_autograd_of_plain_fp32(gated):
    p, g = _inputs(gated)
    args = [a.requires_grad_() for a in _torch_args(p, gated)]
    plain = tpair.gated_pair_block_plain if gated else tpair.pair_block_plain
    gt = torch.from_numpy(g)
    for mode in ("spatial", "temporal"):
        got = torch.autograd.grad(_wrapper(gated)(*args, H, SCALE, mode),
                                  args, gt)
        want = torch.autograd.grad(plain(*args, H, SCALE, mode), args, gt)
        for name, a, r in zip(_names(gated), got, want):
            torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5,
                                       msg=f"{mode} {name}")


@pytest.mark.parametrize("gated", [False, True])
def test_gradcheck_tiny_pair(gated):
    rs = np.random.RandomState(3)
    c, heads, hidden = 8, 2, 16

    def t(*shape, scale=0.3, shift=0.0):
        return torch.from_numpy(rs.normal(size=shape) * scale + shift) \
            .double().requires_grad_()

    args = [t(1, 2, 3, c, scale=1.0)] + ([t(1, 2, 3, c, scale=1.0)]
                                         if gated else [])
    args += [t(c, shift=1.0), t(c), t(3 * c, c), t(3 * c), t(c, c), t(c),
             t(c, shift=1.0), t(c), t(hidden, c), t(hidden), t(c, hidden),
             t(c)]
    if gated:
        args += [t(2, 2 * c), t(2, shift=0.5)]
    fn = _wrapper(gated)
    for mode in ("spatial", "temporal"):
        assert torch.autograd.gradcheck(
            lambda *a: fn(*a, heads, c ** -0.5 / 2, mode), args)


def test_backward_counts_no_launch_on_the_cpu():
    p, g = _inputs(True)
    args = [a.requires_grad_() for a in _torch_args(p, True)]
    before = (tpair.fused_gated_pair_block_bwd.launches,
              tpair.fused_gated_pair_block.launches)
    out = tpair.fused_gated_pair_block(*args, H, SCALE, "spatial")
    out.backward(torch.from_numpy(g))
    assert (tpair.fused_gated_pair_block_bwd.launches,
            tpair.fused_gated_pair_block.launches) == before
    assert all(a.grad is not None for a in args)


def test_backward_wrapper_refuses_other_devices():
    p, g = _inputs(False)
    args = [a.to("meta") for a in _torch_args(p, False)]
    with pytest.raises(ValueError, match="no pair kernel"):
        tpair.fused_pair_block_bwd(args[0], torch.from_numpy(g).to("meta"),
                                   *args[1:], H, SCALE, "spatial")


def test_inference_mode_forward_still_counts_as_before():
    """Under inference_mode the Function runs only its forward; the plain
    version gives the same output as the wrapper."""
    p, _ = _inputs(False)
    args = _torch_args(p, False)
    with torch.inference_mode():
        out = tpair.fused_pair_block(*args, H, SCALE, "temporal")
    ref = tpair.pair_block_plain(*args, H, SCALE, "temporal")
    assert torch.equal(out, ref) and not out.requires_grad
