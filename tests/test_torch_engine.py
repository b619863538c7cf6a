"""The GEMM engine's plain version (``ops/fused_mlp.engine_gemm_plain``)
and the MLP chains built from it, against numpy, the port's plain MLP block
and the JAX package on the CPU.

On the card the MLP block kernels (B6, B7) are chains of engine launches
(``csrc/hopper_gemm.cuh``); ``tests/test_torch_cuda.py`` holds each launch
against this plain version. Here the plain version is held
- per (layout, epilogue) pair against a float64 numpy product rounded at the
  same point: 1e-6 relative for fp32 results (summation order only), one
  bf16 step (2**-8 relative) for bf16 results, where a rounding can land on
  either side;
- as a chain, against ``mlp_block_plain`` and ``mlp_block_bwd_plain``: every
  tensor bit for bit, except the weight gradients, which the engine sums in
  fixed row chunks (fp32 summation order: 1e-6 before rounding to bf16);
- as a chain in bf16 against the JAX package's ``fused_mlp_block`` and its
  VJP (Pallas interpreted): 2e-2 of max|reference| per tensor, as
  ``tests/test_torch_blocks.py`` holds the plain block.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

from motionbert_tpu.ops.fused_mlp import fused_mlp_block as j_mlp_block
from motionbert_tpu_torch.ops import fused_mlp as mlp
from motionbert_tpu_torch.ops.attention import layer_norm, weight_grad

torch.set_num_threads(1)

C, HID = 64, 128
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _t(shape, seed, scale=1.0, shift=0.0, dtype=torch.bfloat16):
    a = np.random.RandomState(seed).normal(size=shape) * scale + shift
    return torch.from_numpy(a.astype(np.float32)).to(dtype)


def _f64(t):
    return t.double().numpy()


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) \
        .double().numpy()


def _reference(layout, epi, a, w, bias, r, z, split):
    """float64 numpy: the product, the epilogue, the rounding."""
    A, W = _f64(a), _f64(w)
    if layout == "TN":
        return np.stack([A[s * split:(s + 1) * split].T
                         @ W[s * split:(s + 1) * split]
                         for s in range(mlp.ENGINE_TN_SPLITS)])
    acc = A @ (W.T if layout == "NT" else W)
    if epi == "f32":
        return acc
    cdf = lambda v: 0.5 * (1 + erf(v / np.sqrt(2)))
    if epi == "dgelu":
        zf = _f64(z)
        acc = acc * (cdf(zf) + zf * np.exp(-0.5 * zf * zf) / np.sqrt(2 * np.pi))
    if epi.startswith("bias"):
        acc = acc + _f64(bias)
    if epi in ("bias_res", "res"):
        acc = acc + _f64(r)
    if epi == "bias_gelu_z":
        return _bf16(acc * cdf(acc)), acc
    if epi == "bias_gelu":
        acc = acc * cdf(acc)
    return _bf16(acc)


def _close(got, want, tol):
    got = got.double().numpy() if torch.is_tensor(got) else got
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("layout,epi", mlp.ENGINE_CASES)
@pytest.mark.parametrize("M", [37, 300])
def test_engine_plain_matches_a_float64_product(layout, epi, M):
    """Ragged M (not a multiple of the 128-row tile, nor of the k-step), N
    and K multiples of 64 that leave partial 128-wide tiles."""
    N, K = 192, 64
    a = _t((M, N) if layout == "TN" else (M, K), 1)
    w = _t({"NT": (N, K), "NN": (K, N), "TN": (M, K)}[layout], 2, K ** -0.5)
    out_shape = (N, K) if layout == "TN" else (M, N)
    bias, r = _t(out_shape[-1:], 3, 0.1), _t(out_shape, 4)
    z = _t(out_shape, 5, dtype=torch.float32)
    got = mlp.engine_gemm(layout, epi, a, w, bias, r, z)  # CPU: the plain version
    want = _reference(layout, epi, a, w, bias, r, z, mlp.engine_split_rows(M))
    if epi == "bias_gelu_z":
        assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
        _close(got[0], want[0], 2 ** -8)
        _close(got[1], want[1], 1e-6)
    elif epi in ("f32", "partial"):
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got, want, 1e-6)
    else:
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _close(got, want, 2 ** -8)


@pytest.mark.parametrize("M", [1, 37, 512, 16524, 33048])
def test_engine_tn_chunks_are_fixed_whole_k_steps(M):
    """A chunk is the fewest whole 64-row k-steps that cover M in
    ENGINE_TN_SPLITS chunks, from M alone (never from the card's SM
    count)."""
    step, per = mlp.engine_split_rows(M), -(-M // mlp.ENGINE_TN_SPLITS)
    assert step % mlp.ENGINE_BK == 0
    assert per <= step < per + mlp.ENGINE_BK
    assert step * mlp.ENGINE_TN_SPLITS >= M


def test_engine_constants_match_the_sources():
    """fused_mlp's engine tables hold the headers' values, and
    mbt_hgemm_constant (block_kernels.cu), against which the wrapper checks
    them on the card, maps each of their names to the same constant."""
    csrc = Path(mlp.__file__).with_name("csrc")
    common = (csrc / "pair_common.cuh").read_text()
    engine = (csrc / "hopper_gemm.cuh").read_text()
    values = {}
    for enum in ("Layout", "Epilogue"):
        body = re.search(r"enum %s \{([^}]*)\}" % enum, common)[1]
        values.update((n, int(v)) for n, v in
                      re.findall(r"(\w+) = (\d+)", body))
    for name in ("HG_BK", "HG_TN_SPLITS"):
        values[name] = int(re.search(r"\b%s = (\d+)" % name, engine)[1])
    table = re.search(r"mbt_hgemm_constant\(.*?\{(.*?)\};",
                      (csrc / "block_kernels.cu").read_text(), re.S)[1]
    entries = dict(re.findall(r'\{"(\w+)", (\w+)\}', table))
    ours = mlp.engine_constants()
    assert set(entries) == set(ours)
    for name, value in ours.items():
        assert values[entries[name]] == value, name
    assert set(mlp.ENGINE_EPILOGUES) == {n[4:].lower() for n in values
                                         if n.startswith("EPI_")}


def _block(seed=0, lead=(3, 7)):
    f32 = torch.float32
    return (_t((*lead, C), seed), _t((C,), 1, 0.1, 1.0, f32),
            _t((C,), 2, 0.1, dtype=f32), _t((HID, C), 3, C ** -0.5),
            _t((HID,), 4, 0.1), _t((C, HID), 5, HID ** -0.5),
            _t((C,), 6, 0.1))


def _chain_forward(x, ln_w, ln_b, w1, b1, w2, b2, use_ln, residual):
    """block_kernels.cu's mbt_mlp_block, launch by launch."""
    x2 = x.reshape(-1, x.shape[-1])
    h = layer_norm(x2, ln_w, ln_b) if use_ln else x2    # ln_fwd_rows
    hid = mlp.engine_gemm_plain("NT", "bias_gelu", h, w1, b1)
    if residual:
        out = mlp.engine_gemm_plain("NT", "bias_res", hid, w2, b2, r=x2)
    else:
        out = mlp.engine_gemm_plain("NT", "bias", hid, w2, b2)
    return out.reshape(x.shape)


def _chain_backward(x, g, w1, b1, w2, residual):
    """block_kernels.cu's mbt_mlp_block_bwd without LayerNorm, launch by
    launch: (dx, dw1, db1, dw2, db2), the weight gradients as the fp32 sums
    of the chunk partials."""
    x2, g2 = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1])
    a, z = mlp.engine_gemm_plain("NT", "bias_gelu_z", x2, w1, b1)
    dw2 = mlp.engine_gemm_plain("TN", "partial", g2, a).sum(0)
    dz = mlp.engine_gemm_plain("NN", "dgelu", g2, w2, z=z)
    dw1 = mlp.engine_gemm_plain("TN", "partial", dz, x2).sum(0)
    if residual:
        dx = mlp.engine_gemm_plain("NN", "res", dz, w1, r=g2)
    else:
        dx = mlp.engine_gemm_plain("NN", "bf16", dz, w1)
    return (dx.reshape(x.shape), dw1, dz.float().sum(0), dw2,
            g2.float().sum(0))


@pytest.mark.parametrize("use_ln,residual", FLAGS)
def test_engine_chain_is_the_plain_mlp_block(use_ln, residual):
    args = _block()
    assert torch.equal(_chain_forward(*args, use_ln, residual),
                       mlp.mlp_block_plain(*args, use_ln, residual))


@pytest.mark.parametrize("residual", [False, True])
def test_engine_chain_is_the_plain_mlp_backward(residual):
    x, ln_w, ln_b, w1, b1, w2, _ = _block()
    g = _t(x.shape, 11)
    dx, dw1, db1, dw2, db2 = _chain_backward(x, g, w1, b1, w2, residual)
    want = mlp.mlp_block_bwd_plain(x, g, ln_w, ln_b, w1, b1, w2, False,
                                   residual)
    assert torch.equal(dx, want[0])
    assert torch.equal(db1.to(torch.bfloat16), want[4])
    assert torch.equal(db2.to(torch.bfloat16), want[6])
    a, z = mlp.engine_gemm_plain("NT", "bias_gelu_z", x.reshape(-1, C), w1, b1)
    dz = mlp.engine_gemm_plain("NN", "dgelu", g.reshape(-1, C), w2, z=z)
    _close(dw2, weight_grad(g, a).double().numpy(), 1e-6)
    _close(dw1, weight_grad(dz, x).double().numpy(), 1e-6)
    for got, w in ((dw1, want[3]), (dw2, want[5])):
        _close(got.to(torch.bfloat16), w.double().numpy(), 2 ** -8)


@pytest.mark.parametrize("residual", [False, True])
def test_engine_chain_matches_jax_bf16(residual):
    """The chain in bf16 against the JAX package's fused MLP block and its
    VJP (its Pallas kernels interpreted), without LayerNorm as the model
    calls it."""
    x, ln_w, ln_b, w1, b1, w2, b2 = _block(lead=(2, 5, 17))
    g = _t(x.shape, 11)
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    jf = lambda t: jnp.asarray(t.numpy(), jnp.float32)
    jargs = (j(x), jf(ln_w), jf(ln_b), j(w1).T, j(b1), j(w2).T, j(b2))
    out, vjp = jax.vjp(lambda *a: j_mlp_block(*a, False, residual), *jargs)
    jdx, _, _, jdw1, jdb1, jdw2, jdb2 = vjp(j(g))
    got = _chain_forward(x, ln_w, ln_b, w1, b1, w2, b2, False, residual)
    _close(got, np.asarray(out, np.float64), 2e-2)
    dx, dw1, db1, dw2, db2 = _chain_backward(x, g, w1, b1, w2, residual)
    for name, mine, theirs in (("dx", dx, jdx), ("dw1", dw1, jdw1.T),
                               ("db1", db1, jdb1), ("dw2", dw2, jdw2.T),
                               ("db2", db2, jdb2)):
        _close(mine.to(torch.bfloat16), np.asarray(theirs, np.float64), 2e-2)


def test_engine_wrappers_validate():
    """What the engine does not take raises ValueError: a misaligned
    address, through the checker the MLP block's launch path calls first;
    a device with no engine."""
    x, *p = _block(lead=(4,))
    mlp.check_mlp_args(x, *p)
    flat = torch.zeros(4 * C + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        mlp.check_mlp_args(flat[1:].view(4, C), *p)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        mlp.check_aligned("g", flat[1:])
    with pytest.raises(ValueError, match="no GEMM engine kernel"):
        mlp.engine_gemm("NT", "bias", x.to("meta"), p[2].to("meta"))
