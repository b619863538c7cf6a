"""The column sums of the backward chains and the one-pass LayerNorm
backward (csrc/pair_bwd_common.cuh) on the CPU: the constants the wrapper
and the sources share, the column sum's plain twin against the JAX
package's sums and float64, a float32 mirror of the LayerNorm backward's
fixed summation order against the order bound the card tests hold the
kernel to, and the wrapper's argument checks.

The bias gradients of the JAX package's backward kernels are ``jnp.sum``
over the token rows (``_pair_bwd_body``, ``_fused_block_bwd_kernel``,
``_fused_mlp_bwd_kernel``), and the LayerNorm's are ``_ln_bwd_rows``'s
``jnp.sum(dh * xhat)`` and ``jnp.sum(dh)``. Tolerances: the plain twin sums
in fp32 in another order than numpy's float64, 1e-5 of sum|terms|; the
mirror of the kernel's order within chip_smoke.order_bound of float64
((ceil(M / splits) + 8 + splits) * 2**-24 * sum|terms|, the bound of a
chain of that many fp32 additions), the bound the card tests hold the
kernels to. The kernels themselves run on the card only
(tests/test_torch_cuda.py, ``-k "ln_bwd or colsum"``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from motionbert_tpu.ops import attention as jat
from motionbert_tpu_torch.ops import attention as at

CSRC = Path(at.__file__).with_name("csrc")
ROWS = [17, 4131]          # neither a multiple of 32, 64 nor 256


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _mk(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def test_colsum_constants_match_the_sources():
    """attention's COLSUM_CONSTANTS hold pair_bwd_common.cuh's values, and
    mbt_colsum_constant (block_kernels.cu), against which the wrapper checks
    them on the card, maps each name to the same constant."""
    header = (CSRC / "pair_bwd_common.cuh").read_text()
    values = {name: int(v) for name, v in re.findall(
        r"constexpr int (\w+) = (\d+);", header)}
    values.update((n, int(v)) for n, v in re.findall(
        r"(COL_\w+) = (\d+)", re.search(r"enum ColMode \{([^}]*)\}",
                                        header)[1]))
    table = re.search(r"mbt_colsum_constant\(.*?\{(.*?)\};",
                      (CSRC / "block_kernels.cu").read_text(), re.S)[1]
    entries = dict(re.findall(r'\{"(\w+)", (\w+)\}', table))
    assert set(entries) == set(at.COLSUM_CONSTANTS)
    for name, value in at.COLSUM_CONSTANTS.items():
        assert values[entries[name]] == value, name
    assert [at.COLSUM_CONSTANTS[m] for m in at.COLSUM_MODES] == [0, 1, 2]


def test_chunk_counts_depend_on_the_rows_alone():
    """The row chunks of both sums are fixed constants (a chunk is
    ceil(M / splits) rows): nothing in the launchers reads the card's SM
    count, so two cards give the same bits."""
    header = (CSRC / "pair_bwd_common.cuh").read_text()
    for launcher in ("cudaError_t column_sum(", "cudaError_t launch_ln_bwd("):
        start = header.index(launcher)
        body = header[start:header.index("\n}\n", start)]
        assert re.search(r"const int chunk = \(M \+ (COL|LN)_SPLITS - 1\) / "
                         r"(COL|LN)_SPLITS;", body), launcher
        assert "multiProcessorCount" not in body
        assert "cudaDeviceGetAttribute" not in body
    assert at.COLSUM_CONSTANTS["ln_splits"] > at.COLSUM_CONSTANTS["splits"]


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("mode,N", [("bf16", 2), ("bf16", 512),
                                    ("f32", 1536), ("gate", 512)])
def test_column_sum_twin_matches_jax_sums(mode, N, M):
    """column_sum on a CPU tensor (the plain twin) against jnp.sum of the
    same terms in fp32 and float64, 1e-5 of sum|terms|; its bf16 output is
    the fp32 one rounded."""
    src = _mk((M, N), 3)
    w = _mk((M, 2), 4)
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    s = torch.from_numpy(src).to(dt)
    wt = torch.from_numpy(w) if mode == "gate" else None
    terms = s.double().numpy()
    if mode == "gate":
        terms = terms * torch.from_numpy(w[:, :1]).to(
            torch.bfloat16).double().numpy()
    got = at.column_sum(s, mode, wt)
    assert got.dtype == torch.float32 and got.shape == (N,)
    scale = np.abs(terms).sum(0)
    want = np.asarray(jnp.sum(jnp.asarray(terms, jnp.float32), axis=0))
    assert (np.abs(got.numpy() - want) <= 1e-5 * scale + 1e-30).all()
    assert (np.abs(got.double().numpy() - terms.sum(0))
            <= 1e-5 * scale + 1e-30).all()
    assert torch.equal(at.column_sum(s, mode, wt, torch.bfloat16),
                       got.to(torch.bfloat16))


def _ln_sums_in_kernel_order(dh, xhat, splits, warps=8):
    """The LayerNorm backward's parameter sums in ln_bwd_fused_kernel's
    fixed order, in float32: in row chunk y of ceil(M / splits) rows, warp w
    adds rows y * chunk + w, + warps, ... in row order; the block adds its
    warps' sums in warp order; the chunks are added in chunk order."""
    M, C = dh.shape
    chunk = -(-M // splits)
    f32 = np.float32
    total = np.zeros((2, C), f32)
    for y in range(splits):
        block = np.zeros((2, C), f32)
        for w in range(warps):
            acc = np.zeros((2, C), f32)
            for m in range(y * chunk + w, min(M, (y + 1) * chunk), warps):
                acc[0] = (acc[0].astype(np.float64) + dh[m].astype(
                    np.float64) * xhat[m]).astype(f32)
                acc[1] = acc[1] + dh[m]
            block = block + acc
        total = total + block
    return total


@pytest.mark.parametrize("M", ROWS)
def test_ln_bwd_order_stays_within_its_bound(M):
    """A float32 mirror of the one-pass LayerNorm backward's summation order
    (a fused multiply-add as the exact product added in float64, rounded
    once) lies within the order bound of the float64 sums, and the plain
    twin's parameter gradients match it."""
    C = 64
    x = torch.from_numpy(_mk((M, C), 0)).to(torch.bfloat16)
    dh = _mk((M, C), 1)
    stats = at.ln_row_stats(x)
    xhat = ((x.float() - stats[:, :1]) * stats[:, 1:]).numpy()
    splits = at.COLSUM_CONSTANTS["ln_splits"]
    got = _ln_sums_in_kernel_order(dh, xhat, splits)
    for i, terms in enumerate((dh.astype(np.float64) * xhat, dh)):
        terms = torch.from_numpy(terms.astype(np.float64))
        bound = chip_smoke.order_bound(terms, splits).numpy()
        assert (np.abs(got[i] - terms.sum(0).numpy()) <= bound).all(), i
    _, dln_w, dln_b = at.ln_bwd_plain(torch.from_numpy(dh), x, stats,
                                      torch.ones(C))
    for a, w in ((dln_w, got[0]), (dln_b, got[1])):
        assert np.allclose(a.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max()
                           + 1e-6)


def test_ln_bwd_twin_sums_what_the_jax_rows_sum():
    """ln_bwd_rows (the plain LayerNorm backward every plain twin calls)
    gives the JAX package's _ln_bwd_rows's dx and parameter sums (its
    accumulators starting at zero), 1e-5 of max."""
    M, C = 4131, 64
    xhat, dh = _mk((M, C), 5), _mk((M, C), 6)
    w = _mk((C,), 7, 0.1, 1.0)
    dls_ref, dlb_ref = [jnp.zeros(C)], [jnp.zeros(C)]
    jdx = jat._ln_bwd_rows(jnp.asarray(dh), jnp.asarray(xhat), 1.0,
                           [jnp.asarray(w)], dls_ref, dlb_ref)
    dx, dweight, dbias = at.ln_bwd_rows(torch.from_numpy(dh),
                                        torch.from_numpy(xhat),
                                        torch.ones(M, 1), torch.from_numpy(w))
    for a, b in ((dweight, dls_ref[0]), (dbias, dlb_ref[0]), (dx, jdx)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


def test_column_sum_args_refuse_what_the_kernel_does_not_take():
    src = torch.zeros(17, 512, dtype=torch.bfloat16)
    at.check_column_sum_args(src, "bf16", None, torch.float32)
    cases = (
        (dict(src=_misaligned(src)), "whole pair"),
        (dict(src=torch.zeros(17, 3, dtype=torch.bfloat16)), "N even"),
        (dict(src=src.float()), "bfloat16"),
        (dict(mode="f32"), "float32"),
        (dict(mode="gate"), "reads w"),
        (dict(mode="gate", w=torch.zeros(17, 1)), "w"),
        (dict(mode="rows"), "mode"),
        (dict(out_dtype=torch.float16), "bf16 or fp32"),
        (dict(src=src.t()), "N even|contiguous"))
    for change, match in cases:
        kw = dict(src=src, mode="bf16", w=None, out_dtype=torch.float32)
        kw.update(change)
        with pytest.raises(ValueError, match=match):
            at.check_column_sum_args(kw["src"], kw["mode"], kw["w"],
                                     kw["out_dtype"])
