"""The pair backward's tensor-core attention core (csrc/attention_tc.cuh)
and its chain (csrc/pair_bwd_kernels.cu) on the CPU: the core's plain twin
against the JAX package's attention core and its VJP, the constants the
wrapper and the sources share, and what the chain launches.

Inputs come from numpy seeds and go to both packages. The JAX core runs its
Pallas kernels interpreted (C = 128, the smallest width at which the JAX
package takes them). Tolerance: 2e-2 of max|reference| per tensor in bf16,
as tests/test_torch_legacy.py holds B8: single bf16 rounding flips of P, dS
and the outputs (the JAX backward also rounds the scores and dP to bf16
where the port keeps them in fp32). The kernels themselves run on the card
only (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from motionbert_tpu.ops.attention import _attention_fused
from motionbert_tpu_torch.ops import fused_pair as fp

C = 128
CSRC = Path(fp.__file__).with_name("csrc")


@pytest.fixture(autouse=True)
def _one_thread():
    """The shapes are tiny: one intra-op thread, so that the other test
    workers do not contend with a thread pool here."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _arrays(shape):
    return [np.random.RandomState(s).normal(size=shape).astype(np.float32)
            for s in range(4)]


@pytest.mark.parametrize("mode,n,H", [
    ("temporal", 1, 4), ("temporal", 5, 4), ("temporal", 16, 4),
    ("temporal", 17, 4), ("temporal", 100, 4), ("temporal", 243, 4),
    ("temporal", 17, 2), ("temporal", 243, 2),
    ("spatial", 17, 4), ("spatial", 17, 2)])
def test_attention_core_matches_the_jax_core(mode, n, H):
    """attention_core / attention_core_bwd on CPU tensors (the plain core)
    against the JAX core and its VJP, at the group sizes the card holds the
    kernel at (head dim 32 and 64)."""
    shape = (1, n, 2, C) if mode == "temporal" else (1, 4, 17, C)
    q, k, v, g = _arrays(shape)
    scale = (C // H) ** -0.5
    jout, vjp = jax.vjp(lambda *a: _attention_fused(*a, H, scale, mode),
                        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(g, jnp.bfloat16))
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g)]
    out = fp.attention_core(*t[:3], mode, H, scale)
    grads = fp.attention_core_bwd(*t, mode, H, scale)
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out,) + grads,
                          (jout,) + tuple(jgrads)):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == shape, name
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), name


def test_core_constants_match_the_sources():
    """fused_pair's CORE_CONSTANTS hold attention_tc.cuh's values, and
    mbt_attn_core_constant (pair_bwd_kernels.cu), against which the wrapper
    checks them on the card, maps each name to the same constant."""
    header = (CSRC / "attention_tc.cuh").read_text()
    values = {name: int(re.search(r"\b%s = (\d+)" % name, header)[1])
              for name in ("TC_MAX_KEYS", "TC_KEY_TILE")}
    table = re.search(r"mbt_attn_core_constant\(.*?\{(.*?)\};",
                      (CSRC / "pair_bwd_kernels.cu").read_text(), re.S)[1]
    entries = dict(re.findall(r'\{"(\w+)", (\w+)\}', table))
    assert set(entries) == set(fp.CORE_CONSTANTS)
    for name, value in fp.CORE_CONSTANTS.items():
        assert values[entries[name]] == value, name


def test_core_key_tiles_pick_an_instantiated_kernel():
    """Every group size the core takes pads to a key-tile count that
    tc_launch_d instantiates, and to no more than twice its rows (16 at
    least)."""
    cases = re.search(r"tc_launch_d\(.*?switch.*?\{(.*?)default",
                      (CSRC / "attention_tc.cuh").read_text(), re.S)[1]
    instantiated = {int(c) for c in re.findall(r"case (\d+):", cases)}
    tile = fp.CORE_CONSTANTS["key_tile"]
    for n in range(1, fp.CORE_CONSTANTS["max_keys"] + 1):
        kt = fp.core_key_tiles(n)
        assert kt in instantiated and n <= kt * tile <= max(2 * n, tile), n


def test_pair_bwd_chain_runs_only_the_engine_and_the_tensor_core_core():
    """The pair backward's chain launches every product on the GEMM engine
    and its attention core on tensor cores: no launch of the WMMA GEMM or
    of the CUDA-core attention kernels is left in its source."""
    src = (CSRC / "pair_bwd_kernels.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for retired in ("launch_gemm", "gemm_kernel", "weight_grad(",
                    "launch_attention_any", "launch_attention_bwd_any",
                    "launch_st_attention_any", "attention_kernel",
                    "attention_bwd_kernel", "ATTN_THREADS", "gemm_q8_kernel",
                    "launch_gemm_q8", "mma_s8"):
        hits = [m.start() for m in re.finditer(re.escape(retired), code)
                if not code[max(0, m.start() - 3):m.start()].endswith("hg_")]
        assert not hits, retired
    assert code.count("hg_gemm<") == 8        # 7 products + the gated out_b
    assert code.count("hg_weight_grad(") == 4
    assert code.count("launch_attention_tc(core") == 2


@pytest.mark.parametrize("mode,gflop", [("temporal", 215.3),
                                        ("spatial", 192.3)])
def test_pair_bwd_bound_counts_fc2_twice_when_ungated(mode, gflop):
    """chip_smoke's bound of the pair backward: the ungated chain runs fc2
    twice (dW2, dz), every other product and the core three times; the
    gated chain recomputes out_b and runs fc2 three times."""
    flops, _ = chip_smoke.pair_bwd_cost(mode, False)
    gated, _ = chip_smoke.pair_bwd_cost(mode, True)
    fwd, _ = chip_smoke.pair_cost(mode, False)
    fc2 = 2 * chip_smoke.B * chip_smoke.FRAMES * chip_smoke.J \
        * chip_smoke.C * chip_smoke.HIDDEN
    assert round(flops / 1e9, 1) == gflop
    assert flops == 3 * fwd - fc2
    assert gated == 3 * chip_smoke.pair_cost(mode, True)[0]
