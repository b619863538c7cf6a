"""The port's pair functions (motionbert_tpu_torch.ops) against the JAX
package's: the Pallas pair kernels (interpreted on the CPU, as the JAX
package's own tests run them) and their XLA reference compositions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionbert_tpu.ops import attention as jattn
from motionbert_tpu.ops import fused_mlp as jmlp
from motionbert_tpu.ops import fused_pair as jpair
from motionbert_tpu_torch.ops import attention as tattn
from motionbert_tpu_torch.ops import fused_mlp as tmlp
from motionbert_tpu_torch.ops import fused_pair as tpair
from motionbert_tpu_torch.ops import pair_q8 as tq8

# fp32 on the CPU on both sides; the sums run in different orders
TOL = dict(atol=3e-5, rtol=3e-5)
B, F, J, C, H = 2, 9, 17, 32, 4


def _mk(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def _pair_np(gated):
    """Inputs in the JAX package's layout (Dense kernels (in, out)), with the
    seeds and scales of tests/test_fused_blocks.py."""
    p = dict(x=_mk((B, F, J, C), 0),
             ln1_s=_mk((C,), 1, 0.1, 1.0), ln1_b=_mk((C,), 2, 0.1),
             wqkv=_mk((C, 3 * C), 3, 0.1), bqkv=_mk((3 * C,), 4, 0.1),
             wproj=_mk((C, C), 5, 0.1), bproj=_mk((C,), 6, 0.1),
             ln2_s=_mk((C,), 7, 0.1, 1.0), ln2_b=_mk((C,), 8, 0.1),
             w1=_mk((C, 2 * C), 9, 0.1), b1=_mk((2 * C,), 10, 0.1),
             w2=_mk((2 * C, C), 11, 0.1), b2=_mk((C,), 12, 0.1))
    if gated:
        p.update(other=_mk((B, F, J, C), 20), wg=_mk((2 * C, 2), 13, 0.1),
                 bg=_mk((2,), 14, 0.1, 0.5))
    return p


_ORDER = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_s",
          "ln2_b", "w1", "b1", "w2", "b2")


def _jax_args(p, gated):
    head = ["x"] + (["other"] if gated else [])
    tail = ["wg", "bg"] if gated else []
    return [jnp.asarray(p[k]) for k in head + list(_ORDER) + tail]


def _torch_args(p, gated):
    """The same inputs in the port's layout: nn.Linear weights (out, in)."""
    head = ["x"] + (["other"] if gated else [])
    tail = ["wg", "bg"] if gated else []
    out = []
    for k in head + list(_ORDER) + tail:
        a = p[k]
        if k in ("wqkv", "wproj", "w1", "w2", "wg"):
            a = a.T
        out.append(torch.from_numpy(np.ascontiguousarray(a)))
    return out


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_pair_matches_jax(mode, gated, jax_impl):
    p = _pair_np(gated)
    scale = (C // H) ** -0.5
    if gated:
        jfn = jpair.fused_gated_pair_block if jax_impl == "pallas" \
            else jpair._gated_pair_xla
        tfn = tpair.fused_gated_pair_block
    else:
        jfn = jpair.fused_pair_block if jax_impl == "pallas" \
            else jpair._pair_xla
        tfn = tpair.fused_pair_block
    ref = np.asarray(jfn(*_jax_args(p, gated), H, scale, mode))
    out = tfn(*_torch_args(p, gated), H, scale, mode)
    assert out.dtype == torch.float32 and out.shape == (B, F, J, C)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_layer_norm_matches_jax():
    x = _mk((5, 7, 64), 0, 3.0, 1.5)
    w, b = _mk((64,), 1, 0.1, 1.0), _mk((64,), 2, 0.1)
    ref = np.asarray(jattn.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b)))
    out = tattn.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_attention_matches_jax(mode):
    q, k, v = (_mk((B, F, J, C), s) for s in (0, 1, 2))
    scale = (C // H) ** -0.5
    ref = np.asarray(jattn._attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, scale, mode))
    out = tattn.st_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             mode, H, scale)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_mlp_block_matches_jax():
    p = _pair_np(False)
    x = p["x"].reshape(-1, C)
    args = (x, p["ln2_s"], p["ln2_b"], p["w1"], p["b1"], p["w2"], p["b2"])
    ref = np.asarray(jmlp._fused_mlp_xla(*(jnp.asarray(a) for a in args),
                                         True, True))
    out = tmlp.mlp_block(torch.from_numpy(x), *(torch.from_numpy(a) for a in (
        p["ln2_s"], p["ln2_b"], p["w1"].T.copy(), p["b1"], p["w2"].T.copy(),
        p["b2"])))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


# positions of the four LayerNorm tensors in _torch_args (they stay fp32)
_LN_POS = {False: (1, 2, 7, 8), True: (2, 3, 8, 9)}


@pytest.mark.parametrize("gated", [False, True])
def test_bf16_plain_pair_tracks_pallas_bf16(gated):
    """In bf16 the plain version keeps the Pallas kernel's rounding points
    (qkv, P, attention output, y and the hidden activation in bf16, fp32
    sums). Both run in bf16, so they differ by bf16 rounding flips; the bar
    is the one chip_smoke.py holds the CUDA kernel to (2e-2 of max|ref|)."""
    p = _pair_np(gated)
    scale = (C // H) ** -0.5
    jargs = [a if k.startswith("ln") else a.astype(jnp.bfloat16) for k, a in
             zip((["x"] + (["other"] if gated else []) + list(_ORDER)
                  + (["wg", "bg"] if gated else [])), _jax_args(p, gated))]
    targs = [a if i in _LN_POS[gated] else a.bfloat16()
             for i, a in enumerate(_torch_args(p, gated))]
    jfn = jpair.fused_gated_pair_block if gated else jpair.fused_pair_block
    tfn = tpair.fused_gated_pair_block if gated else tpair.fused_pair_block
    for mode in ("spatial", "temporal"):
        ref = np.asarray(jfn(*jargs, H, scale, mode).astype(jnp.float32))
        out = tfn(*targs, H, scale, mode)
        assert out.dtype == torch.bfloat16
        err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= 2e-2, (mode, err)


def _bf16_kernel_args(gated, dtype=torch.bfloat16, C_=64, H_=2, F_=9):
    """Pair inputs for the kernel's argument checks; weights are scaled by
    fan_in^-0.5 and LayerNorm tensors stay fp32, as the model passes them."""
    rs = np.random.RandomState(0)

    def t(*shape, scale=1.0, dt=dtype):
        a = rs.normal(size=shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dt)

    f32, hid = torch.float32, 2 * C_
    args = [t(1, F_, J, C_)] + ([t(1, F_, J, C_)] if gated else [])
    args += [t(C_, dt=f32), t(C_, dt=f32), t(3 * C_, C_, scale=C_ ** -0.5),
             t(3 * C_), t(C_, C_, scale=C_ ** -0.5), t(C_), t(C_, dt=f32),
             t(C_, dt=f32), t(hid, C_, scale=C_ ** -0.5), t(hid),
             t(C_, hid, scale=hid ** -0.5), t(C_)]
    wg, bg = (t(2, 2 * C_), t(2)) if gated else (None, None)
    return args, wg, bg, H_


@pytest.mark.parametrize("gated", [False, True])
def test_check_kernel_args_accepts_supported_shapes(gated):
    for C_, H_ in ((64, 2), (256, 8), (512, 8)):
        args, wg, bg, H_ = _bf16_kernel_args(gated, C_=C_, H_=H_, F_=3)
        x, other = args[0], (args[1] if gated else None)
        rest = args[2:] if gated else args[1:]
        tpair.check_kernel_args(x, other, *rest, wg, bg, H_, "temporal")


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """t's values at an address 2 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    flat.copy_(t.reshape(-1))
    return flat.view(t.shape)


@pytest.mark.parametrize("case", [
    "fp32", "heads", "frames", "joints", "noncontig", "ln_dtype", "mode",
    "wshape", "empty", "rows", "rows_q8", "misaligned_x", "misaligned_w"])
def test_check_kernel_args_rejects(case):
    """rows: one row past what the chains take (the tensor-core core's
    32-bit item count at these heads), rows_q8: the same row through the
    W8A8 launcher (its s8 engine walks its tiles with persistent blocks like
    the bf16 engine, so the core binds it too); misaligned: x or a weight off
    the 16-byte boundary that the engines' TMA loads and every chain's
    vector loads need (the W8A8 launcher refuses them too)."""
    args, wg, bg, H = _bf16_kernel_args(False)
    mode = "spatial"
    if case == "fp32":
        args[0] = args[0].float()
    elif case == "heads":
        H = 4    # head dim 16 is not taken
    elif case == "frames":
        args[0] = torch.zeros(1, 244, J, 64, dtype=torch.bfloat16)
    elif case == "joints":
        args[0] = torch.zeros(1, 9, 16, 64, dtype=torch.bfloat16)
    elif case == "noncontig":
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "ln_dtype":
        args[1] = args[1].bfloat16()
    elif case == "mode":
        mode = "coupling"
    elif case == "wshape":
        args[3] = args[3][:, :32].contiguous()
    elif case == "empty":
        args[0] = torch.zeros(0, 9, J, 64, dtype=torch.bfloat16)
    elif case in ("rows", "rows_q8"):
        limit = tattn.core_max_rows(H)
        assert limit == (2 ** 31 - 1) // H
        args[0] = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16).expand(
            limit // J + 1, 1, J, 64)
    elif case == "misaligned_x":
        args[0] = _misaligned(args[0])
    elif case == "misaligned_w":
        args[3] = _misaligned(args[3])
    match = {"rows": "token rows", "rows_q8": "token rows",
             "misaligned_x": "16-byte-aligned",
             "misaligned_w": "16-byte-aligned"}.get(case)
    if case != "rows_q8":
        with pytest.raises(ValueError, match=match):
            tpair.check_kernel_args(args[0], None, *args[1:], wg, bg, H, mode)
    if case.startswith("misaligned") or case == "rows_q8":
        # the W8A8 launcher checks before it quantises or loads its library
        with pytest.raises(ValueError, match=match):
            tq8._launch(args[0], None, *args[1:], wg, bg, H, 0.125, mode)


def test_wrapper_refuses_other_devices():
    args, _, _, H = _bf16_kernel_args(False)
    args = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no pair kernel"):
        tpair.fused_pair_block(*args, H, 0.125, "spatial")


def test_cpu_wrapper_counts_no_launch():
    args, _, _, H = _bf16_kernel_args(False, dtype=torch.float32)
    before = tpair.fused_pair_block.launches
    tpair.fused_pair_block(*args, H, 0.125, "temporal")
    assert tpair.fused_pair_block.launches == before
