"""The bf16 forward pair chain (csrc/pair_chain.cuh) on the CPU: what it
launches, read from the sources, and a plain mirror of it launch by launch,
held against the port's plain pairs and the JAX package's.

On the card B1 (``fused_pair_block``), B2 (``fused_gated_pair_block``) and
both bf16 passes of B10 run ``pair_chain``: two LayerNorm row passes, four
products on the GEMM engine and the tensor-core attention core
(``tests/test_torch_cuda.py`` holds them against the plain pairs). Here the
mirror ``_chain`` takes each launch's plain twin in the chain's order
(``layer_norm`` for ``ln_fwd_rows``, ``engine_gemm_plain`` for ``hg_gemm``,
``st_attention_plain`` for the core, ``gate_plain`` for the gate) and is
held
- against ``pair_block_plain`` / ``gated_pair_block_plain`` bit for bit: the
  chain keeps the plain pair's rounding points;
- in fp32 against the JAX package's pair (its Pallas kernels interpreted,
  and its XLA reference ``_pair_xla`` / ``_gated_pair_xla``): 3e-5 absolute
  and relative, as tests/test_torch_ops.py holds the plain pair (the same
  math, sums in another order);
- in bf16 against the interpreted Pallas pair: 2e-2 of max|reference|,
  the bar chip_smoke.py holds the kernels to (single bf16 rounding flips of
  qkv, P, the attention output, y and the hidden activation).
Both modes and both head dims the kernels take (32 and 64, at C 128).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from motionbert_tpu.ops import fused_pair as jpair
from motionbert_tpu_torch.ops import fused_pair as fp
from motionbert_tpu_torch.ops.attention import layer_norm, st_attention_plain
from motionbert_tpu_torch.ops.fused_mlp import engine_gemm_plain

CSRC = Path(fp.__file__).with_name("csrc")
B, F, J, C = 1, 6, 17, 128
TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = 2e-2
MODES = ["temporal", "spatial"]
HEADS = [2, 4]                          # head dim 64 and 32
JAX_NAMES = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_s",
             "ln2_b", "w1", "b1", "w2", "b2")


@pytest.fixture(autouse=True)
def _one_thread():
    """The shapes are tiny: one intra-op thread, so that the other test
    workers do not contend with a thread pool here."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _code(name: str) -> str:
    """A source with its // comments removed."""
    text = (CSRC / name).read_text()
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def _mk(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def _pair_np(gated: bool) -> dict:
    """Pair inputs in the JAX package's layout (Dense kernels (in, out)),
    weights scaled by fan_in^-0.5 so that each sub-block moves the stream
    by O(1), as the model's are."""
    hid = 2 * C
    p = dict(x=_mk((B, F, J, C), 0),
             ln1_s=_mk((C,), 1, 0.1, 1.0), ln1_b=_mk((C,), 2, 0.1),
             wqkv=_mk((C, 3 * C), 3, C ** -0.5), bqkv=_mk((3 * C,), 4, 0.1),
             wproj=_mk((C, C), 5, C ** -0.5), bproj=_mk((C,), 6, 0.1),
             ln2_s=_mk((C,), 7, 0.1, 1.0), ln2_b=_mk((C,), 8, 0.1),
             w1=_mk((C, hid), 9, C ** -0.5), b1=_mk((hid,), 10, 0.1),
             w2=_mk((hid, C), 11, hid ** -0.5), b2=_mk((C,), 12, 0.1))
    if gated:
        p.update(other=_mk((B, F, J, C), 20),
                 wg=_mk((2 * C, 2), 13, (2 * C) ** -0.5),
                 bg=_mk((2,), 14, 0.1, 0.5))
    return p


def _names(gated: bool) -> list:
    return (["x"] + (["other"] if gated else []) + list(JAX_NAMES)
            + (["wg", "bg"] if gated else []))


def _jax_args(p: dict, gated: bool, dtype) -> list:
    """LayerNorm parameters stay fp32, as the model passes them."""
    return [jnp.asarray(p[k], jnp.float32 if k.startswith("ln") else dtype)
            for k in _names(gated)]


def _torch_args(p: dict, gated: bool, dtype) -> dict:
    """The same inputs in the port's layout: nn.Linear weights (out, in)."""
    out = {}
    for k in _names(gated):
        a = p[k].T if k in ("wqkv", "wproj", "w1", "w2", "wg") else p[k]
        t = torch.from_numpy(np.ascontiguousarray(a))
        out[k] = t if k.startswith("ln") else t.to(dtype)
    return out


def _plain_args(t: dict, gated: bool) -> list:
    return [t[k] for k in _names(gated)]


def _chain(t: dict, H: int, scale: float, mode: str) -> torch.Tensor:
    """pair_chain.cuh's pair_chain (and pair_kernels.cu's gate), launch by
    launch, each launch's plain twin on the chain's buffers."""
    x = t["x"]
    x2 = x.reshape(-1, C)
    attn = layer_norm(x2, t["ln1_s"], t["ln1_b"])        # 1. ln_fwd_rows: h1
    qkv = engine_gemm_plain("NT", "bias", attn, t["wqkv"], t["bqkv"])
    qkv = qkv.reshape(*x.shape[:3], 3 * C)               # 2. qkv
    attn = st_attention_plain(qkv[..., :C], qkv[..., C:2 * C],
                              qkv[..., 2 * C:], mode, H, scale)
    attn = attn.reshape(-1, C)                           # 3. the core
    y = engine_gemm_plain("NT", "bias_res", attn, t["wproj"], t["bproj"],
                          r=x2)                          # 4. proj + x
    attn = layer_norm(y, t["ln2_s"], t["ln2_b"])         # 5. ln_fwd_rows: h2
    hid = engine_gemm_plain("NT", "bias_gelu", attn, t["w1"], t["b1"])
    out = engine_gemm_plain("NT", "bias_res", hid, t["w2"], t["b2"],
                            r=y).reshape(x.shape)        # 6, 7. fc1, fc2 + y
    if "other" not in t:
        return out
    return fp.gate_plain(t["other"], out, t["wg"], t["bg"])  # 8. the gate


def test_pair_chain_runs_only_the_engine_and_the_tensor_core_core():
    """The forward chain launches every product on the GEMM engine, its
    attention core on tensor cores and its LayerNorms as row passes, in
    _chain's order: no launch of the WMMA GEMM or of the CUDA-core
    attention kernel is left in its source, and the pair and stream
    libraries take their bf16 chain from it."""
    code = _code("pair_chain.cuh")
    for retired in ("launch_gemm", "gemm_kernel", "launch_attention_any",
                    "launch_st_attention_any", "attention_kernel",
                    "ATTN_THREADS", "gemm_q8_kernel", "launch_gemm_q8",
                    "mma_s8"):
        hits = [m.start() for m in re.finditer(re.escape(retired), code)
                if not code[max(0, m.start() - 3):m.start()].endswith("hg_")]
        assert not hits, retired
    assert code.count("hg_gemm<") == 4
    assert code.count("launch_attention_tc(") == 1
    assert code.count("launch_ln_fwd_rows(") == 2
    launches = re.findall(r"hg_gemm<NT, (EPI_\w+)>|(launch_attention_tc)\(|"
                          r"(launch_ln_fwd_rows)\(", code)
    assert ["".join(hit) for hit in launches] == [
        "launch_ln_fwd_rows", "EPI_BIAS", "launch_attention_tc",
        "EPI_BIAS_RES", "launch_ln_fwd_rows", "EPI_BIAS_GELU", "EPI_BIAS_RES"]
    for name in ("pair_kernels.cu", "stream_kernels.cu"):
        src = _code(name)
        assert '#include "pair_chain.cuh"' in src, name
        assert "launch_gemm" not in src and "launch_attention" not in src
    assert "pair_chain(" not in _code("pair_common.cuh")
    assert _code("stream_kernels.cu").count(" pair_chain(") == 2


@pytest.mark.parametrize("gated", [False, True])
def test_pair_records_count_the_chain_launches(gated):
    """chip_smoke's device-record counts of one pair and one stream call
    are the launches in the sources: the chain's seven, the gate's one."""
    chain = sum(_code("pair_chain.cuh").count(s) for s in (
        "hg_gemm<", "launch_attention_tc(", "launch_ln_fwd_rows("))
    gate = int(gated) * _code("pair_kernels.cu").count("launch_gate(")
    assert chip_smoke.pair_records(gated) == chain + gate
    assert chip_smoke.stream_records(gated, False) == 2 * chain + gate


@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gated", [False, True])
def test_chain_mirror_is_the_plain_pair(gated, mode, H):
    """Launch by launch in bf16, the chain's rounding points are the plain
    pair's, bit for bit."""
    t = _torch_args(_pair_np(gated), gated, torch.bfloat16)
    scale = (C // H) ** -0.5
    plain = fp.gated_pair_block_plain if gated else fp.pair_block_plain
    got = _chain(t, H, scale, mode)
    assert got.dtype == torch.bfloat16 and got.shape == (B, F, J, C)
    assert torch.equal(got, plain(*_plain_args(t, gated), H, scale, mode))


@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gated", [False, True])
def test_chain_mirror_matches_jax_fp32(gated, mode, H, jax_impl):
    p = _pair_np(gated)
    scale = (C // H) ** -0.5
    if jax_impl == "pallas":
        jfn = jpair.fused_gated_pair_block if gated \
            else jpair.fused_pair_block
    else:
        jfn = jpair._gated_pair_xla if gated else jpair._pair_xla
    ref = np.asarray(jfn(*_jax_args(p, gated, jnp.float32), H, scale, mode))
    got = _chain(_torch_args(p, gated, torch.float32), H, scale, mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gated", [False, True])
def test_chain_mirror_tracks_pallas_bf16(gated, mode, H):
    p = _pair_np(gated)
    scale = (C // H) ** -0.5
    jfn = jpair.fused_gated_pair_block if gated else jpair.fused_pair_block
    ref = np.asarray(jfn(*_jax_args(p, gated, jnp.bfloat16), H, scale,
                         mode).astype(jnp.float32))
    got = _chain(_torch_args(p, gated, torch.bfloat16), H, scale, mode)
    err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= BF16_TOL, err
