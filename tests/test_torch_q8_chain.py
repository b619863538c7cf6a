"""The W8A8 pair chain (csrc/pair_q8_common.cuh's q8_pair_chain) and its
s8 engine (csrc/hopper_gemm_s8.cuh) on the CPU: what the chain
launches, read from the sources; the first design's kernels gone from the
tree; the engine's plain twin against an exact integer product; and a plain
mirror of the chain launch by launch, held against the port's plain W8A8
pairs and the JAX package's.

On the card B9 (``fused_pair_block_q8``, ``fused_gated_pair_block_q8``) and
the W8A8 passes of B10 run ``q8_pair_chain``: per-row quantisers, four
products on the s8 engine and the tensor-core attention core
(``tests/test_torch_cuda.py`` holds them against the plain pairs). Here the
mirror ``_chain`` takes each launch's plain twin in the chain's order
(``q8_rows`` of ``ln_fwd_stats`` for ``ln_quant_rows``, ``q8_rows`` for
``quant_rows``, ``engine_gemm_q8_plain`` for ``hg_gemm_s8``,
``st_attention_plain`` for the core, ``gate_plain`` for the gate) and is
held
- against ``pair_block_q8_plain`` / ``gated_pair_block_q8_plain`` bit for
  bit, in bf16 and in fp32: the chain keeps the plain pair's rounding points;
- in fp32 against the JAX package's ``_q8_launch`` (its Pallas kernel
  interpreted, as tests/test_torch_q8.py runs it) at that file's bar, 5e-4
  of max|reference|: the integer products are exact on both sides, so the
  two differ by summation order in LayerNorm and attention and, where that
  moves an activation across a quantiser boundary, one int8 step of one term;
- in bf16 against the interpreted ``_q8_launch`` at tests/test_torch_q8.py's
  bf16 bars (2e-2 of max|reference|, relative L2 2e-3, at most 2 % of the
  outputs differing), which a moved rounding point fails.
Both modes and both head dims the kernels take (64 and 32, at C 128).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from motionbert_tpu.ops import pair_q8 as jq8
from motionbert_tpu_torch.ops import fused_pair as fp
from motionbert_tpu_torch.ops import pair_q8 as q8
from motionbert_tpu_torch.ops.attention import ln_fwd_stats, st_attention_plain

CSRC = Path(q8.__file__).with_name("csrc")
B, F, J, C = 1, 6, 17, 128
HID = 2 * C
MODES = ["temporal", "spatial"]
HEADS = [2, 4]                          # head dim 64 and 32
JAX_TOL = 5e-4
BF16_TOL, BF16_L2_TOL, BF16_DIFFER = 2e-2, 2e-3, 0.02
JAX_NAMES = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_s",
             "ln2_b", "w1", "b1", "w2", "b2")
# the first design's CUDA-core attention core and int8 mma.sync GEMM
RETIRED = ("attention_kernel", "launch_attention_any",
           "launch_st_attention_any", "ATTN_THREADS", "gemm_q8_kernel",
           "launch_gemm_q8", "mma_s8")
# q8_pair_chain's launches, in order
CHAIN = ["launch_ln_quant", "hg_gemm_s8<Q8_BIAS>", "launch_attention_tc",
         "launch_quant_rows<bf16>", "hg_gemm_s8<Q8_BIAS_RES>",
         "launch_ln_quant", "hg_gemm_s8<Q8_BIAS_GELU_F32>",
         "launch_quant_rows<float>", "hg_gemm_s8<Q8_BIAS_RES>"]
LAUNCH = re.compile(r"\b(launch_\w+(?:<\w+>)?|hg_gemm\w*<\w+>|\w+_kernel\w*)"
                    r"\s*(?:<<<|\()")


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


def _body(code: str, signature: str) -> str:
    """The body of the function whose definition starts with signature."""
    start = code.index("{", code.index(signature))
    depth = 0
    for i in range(start, len(code)):
        depth += {"{": 1, "}": -1}.get(code[i], 0)
        if depth == 0:
            return code[start:i + 1]
    raise AssertionError(f"unbalanced braces after {signature}")


def _mk(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def _pair_np(gated: bool) -> dict:
    """Pair inputs in the JAX package's layout (Dense kernels (in, out)),
    weights scaled by fan_in^-0.5, as the model's are."""
    p = dict(x=_mk((B, F, J, C), 0),
             ln1_s=_mk((C,), 1, 0.1, 1.0), ln1_b=_mk((C,), 2, 0.1),
             wqkv=_mk((C, 3 * C), 3, C ** -0.5), bqkv=_mk((3 * C,), 4, 0.1),
             wproj=_mk((C, C), 5, C ** -0.5), bproj=_mk((C,), 6, 0.1),
             ln2_s=_mk((C,), 7, 0.1, 1.0), ln2_b=_mk((C,), 8, 0.1),
             w1=_mk((C, HID), 9, C ** -0.5), b1=_mk((HID,), 10, 0.1),
             w2=_mk((HID, C), 11, HID ** -0.5), b2=_mk((C,), 12, 0.1))
    if gated:
        p.update(other=_mk((B, F, J, C), 20),
                 wg=_mk((2 * C, 2), 13, (2 * C) ** -0.5),
                 bg=_mk((2,), 14, 0.1, 0.5))
    return p


def _names(gated: bool) -> list:
    return (["x"] + (["other"] if gated else []) + list(JAX_NAMES)
            + (["wg", "bg"] if gated else []))


def _torch_args(p: dict, gated: bool, dtype) -> dict:
    """The inputs in the port's layout (nn.Linear weights (out, in));
    LayerNorm parameters stay fp32."""
    out = {}
    for k in _names(gated):
        a = p[k].T if k in ("wqkv", "wproj", "w1", "w2", "wg") else p[k]
        t = torch.from_numpy(np.ascontiguousarray(a))
        out[k] = t if k.startswith("ln") else t.to(dtype)
    return out


def _jax_launch(p: dict, gated: bool, dtype, H: int, scale: float,
                mode: str) -> np.ndarray:
    """The JAX package's _q8_launch, its Pallas kernel interpreted."""
    cast = lambda k: jnp.asarray(p[k], jnp.float32 if k.startswith("ln")
                                 else dtype)
    weights = tuple(cast(k) for k in JAX_NAMES) \
        + ((cast("wg"), cast("bg")) if gated else ())
    body = jq8._gated_pair_q8_kernel if gated else jq8._pair_q8_kernel
    out = jq8._q8_launch(body, cast("x"), cast("other") if gated else None,
                         weights, H, scale, mode)
    return np.asarray(out.astype(jnp.float32))


def _chain(t: dict, H: int, scale: float, mode: str) -> torch.Tensor:
    """pair_q8_common.cuh's q8_pair_chain (and pair_q8_kernels.cu's gate),
    launch by launch, each launch's plain twin on the chain's buffers."""
    x = t["x"]
    x2 = x.reshape(-1, C)
    w = {k: q8.quant_cols(t[k]) for k in ("wqkv", "wproj", "w1", "w2")}
    a8, s = q8.q8_rows(ln_fwd_stats(x2, t["ln1_s"], t["ln1_b"])[2])  # 1.
    qkv = q8.engine_gemm_q8_plain("bias", a8, s, *w["wqkv"], t["bqkv"])
    qkv = qkv.reshape(*x.shape[:3], 3 * C)                          # 2.
    attn = st_attention_plain(qkv[..., :C], qkv[..., C:2 * C],
                              qkv[..., 2 * C:], mode, H, scale)     # 3.
    a8, s = q8.q8_rows(attn.reshape(-1, C))                         # 4.
    y = q8.engine_gemm_q8_plain("bias_res", a8, s, *w["wproj"],
                                t["bproj"], r=x2)                   # 5.
    a8, s = q8.q8_rows(ln_fwd_stats(y, t["ln2_s"], t["ln2_b"])[2])   # 6.
    act = q8.engine_gemm_q8_plain("bias_gelu_f32", a8, s, *w["w1"],
                                  t["b1"])                          # 7.
    a8, s = q8.q8_rows(act)                                         # 8.
    out = q8.engine_gemm_q8_plain("bias_res", a8, s, *w["w2"], t["b2"],
                                  r=y).reshape(x.shape)             # 9.
    if "other" not in t:
        return out
    return fp.gate_plain(t["other"], out, t["wg"], t["bg"])         # 10.


# ---------------------------------------------------------------------------
# the sources
# ---------------------------------------------------------------------------

def test_q8_chain_runs_the_quantisers_the_s8_engine_and_the_core():
    """q8_pair_chain launches the quantisers, the s8 engine for all four
    products and the tensor-core core, in _chain's order and nothing else;
    the pair entry adds only the gate, and the W8A8 stream runs the chain
    once a pass."""
    body = _body(_code("pair_q8_common.cuh"), "cudaError_t q8_pair_chain(")
    assert LAUNCH.findall(body) == CHAIN
    assert "tc_packed_args(qkv" in body and "core.ld_out = C;" in body
    entry = _body(_code("pair_q8_kernels.cu"),
                  'extern "C" int mbt_pair_block_q8(')
    assert LAUNCH.findall(entry) == ["launch_gate"]
    assert entry.count("q8_pair_chain(") == 1
    stream = _body(_code("stream_kernels.cu"),
                   'extern "C" int mbt_stream_block_q8(')
    assert stream.count("q8_pair_chain(") == 2
    assert LAUNCH.findall(stream) == ["launch_gate"]


def test_st_attention_launches_the_tensor_core_core():
    """B8's entry point hands its separate q, k, v to the tensor-core
    forward core, with a contiguous output."""
    entry = _body(_code("st_attention_kernels.cu"),
                  'extern "C" int mbt_st_attention(')
    assert LAUNCH.findall(entry) == ["launch_attention_tc"]
    assert "a.ld_out = C;" in entry
    assert "launch_attention_tc(a, false," in entry


@pytest.mark.parametrize("name", RETIRED)
def test_the_first_design_is_gone_from_the_sources(name):
    """No source or header under csrc/, comments included, names the
    first design's CUDA-core attention core or its int8 GEMM."""
    for path in sorted(CSRC.glob("*.cu*")):
        assert not re.search(rf"\b{name}\b", path.read_text()), \
            (name, path.name)


@pytest.mark.parametrize("gated", [False, True])
def test_q8_records_count_the_chain_launches(gated):
    """chip_smoke's count of a W8A8 pair call's chain kernels is the
    launches in the sources: the chain's nine and the gate."""
    chain = len(LAUNCH.findall(_body(_code("pair_q8_common.cuh"),
                                     "cudaError_t q8_pair_chain(")))
    assert chip_smoke.pair_q8_records(gated) == chain + int(gated)
    assert chip_smoke.stream_q8_records(gated) == 2 * chain + int(gated)


@pytest.mark.parametrize("kernel,policy", [("hg_gemm_kernel", "HgBf16"),
                                           ("hg_gemm_s8_kernel", "HgS8")])
def test_both_engines_run_one_pipeline(kernel, policy):
    """The bf16 and the int8 engine's kernels are hopper_gemm.cuh's one
    pipeline (hg_gemm_body) under an MMA policy, launched by its one
    launcher: the int8 header holds no ring, TMA load, tile walk or launch
    logic of its own."""
    code = _code("hopper_gemm.cuh") + _code("hopper_gemm_s8.cuh")
    body = _body(code, f"\n{kernel}(")[1:-1]
    assert re.fullmatch(rf"\s*hg_gemm_body<(?:LAYOUT|NT), {policy}>\([^;]*\);\s*",
                        body), body
    s8 = _code("hopper_gemm_s8.cuh")
    for name in ("mbar_", "tma_load", "__shfl", "cudaFuncSetAttribute",
                 "hg_resident_blocks", "<<<"):
        assert name not in s8, name
    assert code.count("hg_launch<") == 2
    assert _code("hopper_gemm.cuh").count("<<<") == 1


def test_q8_epilogues_match_the_header():
    """ops/pair_q8.py's Q8_EPILOGUES are hopper_gemm_s8.cuh's enum, and the
    engine's test entry launches each."""
    enum = re.search(r"enum Q8Epilogue \{(.*?)\};",
                     _code("hopper_gemm_s8.cuh"), re.S)[1]
    values = {k: int(v) for k, v in re.findall(r"(Q8_\w+) = (\d+)", enum)}
    assert {f"Q8_{k.upper()}": v for k, v in q8.Q8_EPILOGUES.items()} == values
    entry = _body(_code("pair_q8_kernels.cu"),
                  'extern "C" int mbt_q8_gemm_test(')
    assert LAUNCH.findall(entry) == [f"hg_gemm_s8<{n}>" for n in values]


# ---------------------------------------------------------------------------
# the s8 engine's plain twin
# ---------------------------------------------------------------------------

def _engine_operands(M, N, K, seed):
    rs = np.random.RandomState(seed)
    a8 = rs.randint(-127, 128, size=(M, K)).astype(np.int8)
    w8 = rs.randint(-127, 128, size=(N, K)).astype(np.int8)
    a8[0], w8[0] = 127, 127                 # the largest sum a row can take
    ascale = rs.uniform(1e-3, 1e-1, M).astype(np.float32)
    wscale = rs.uniform(1e-4, 1e-2, N).astype(np.float32)
    bias = rs.normal(size=N).astype(np.float32)
    r = rs.normal(size=(M, N)).astype(np.float32)
    return a8, ascale, w8, wscale, bias, r


@pytest.mark.parametrize("epi", ["bias", "bias_res"])
@pytest.mark.parametrize("M,N,K", [(37, 64, 64), (130, 192, 512),
                                   (5, 128, 1024), (3, 64, 2048)])
def test_s8_engine_plain_is_the_exact_product(epi, M, N, K):
    """engine_gemm_q8_plain on bf16 bias and residual equals the int64
    product dequantised step by step in float32 (numpy, no fused
    multiply-add), rounded once to bf16: bit for bit, ragged M and the
    float64 route (K 2048) included; the card's engine is held to the same
    bits (tests/test_torch_cuda.py)."""
    a8, ascale, w8, wscale, bias, r = _engine_operands(M, N, K, M + K)
    bias_t = torch.from_numpy(bias).bfloat16()
    r_t = torch.from_numpy(r).bfloat16()
    acc = (a8.astype(np.int64) @ w8.astype(np.int64).T).astype(np.float32)
    want = acc * ascale[:, None] * wscale + bias_t.float().numpy()
    if epi == "bias_res":
        want = want + r_t.float().numpy()
    want = torch.from_numpy(want).bfloat16()
    args = [torch.from_numpy(a) for a in (a8, ascale, w8, wscale)]
    got = q8.engine_gemm_q8(epi, *args, bias_t,
                            r_t if epi == "bias_res" else None)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.equal(got, want)


def test_s8_engine_cpu_entry_counts_no_launch():
    """On CPU tensors the engine's entry runs the plain twin (the fp32
    GELU epilogue included) and counts no launch; other devices raise."""
    a8, ascale, w8, wscale, bias, _ = _engine_operands(9, 64, 128, 1)
    args = [torch.from_numpy(a) for a in (a8, ascale, w8, wscale, bias)]
    before = q8.engine_gemm_q8.launches
    got = q8.engine_gemm_q8("bias_gelu_f32", *args)
    z = q8._int_matmul(args[0], args[2]) * args[1][:, None] * args[3] \
        + args[4]
    assert got.dtype == torch.float32 and q8.engine_gemm_q8.launches == before
    assert torch.equal(got, 0.5 * z * (1.0 + torch.erf(
        z * 0.7071067811865476)))
    with pytest.raises(ValueError, match="no s8 engine"):
        q8.engine_gemm_q8("bias", *(t.to("meta") for t in args))


# ---------------------------------------------------------------------------
# the chain's mirror
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gated", [False, True])
def test_q8_chain_mirror_is_the_plain_pair(gated, mode, H, dtype):
    """Launch by launch, the chain's rounding points are the plain W8A8
    pair's, bit for bit."""
    t = _torch_args(_pair_np(gated), gated, dtype)
    scale = (C // H) ** -0.5
    plain = q8.gated_pair_block_q8_plain if gated else q8.pair_block_q8_plain
    got = _chain(t, H, scale, mode)
    assert got.dtype == dtype and got.shape == (B, F, J, C)
    assert torch.equal(got, plain(*[t[k] for k in _names(gated)], H, scale,
                                  mode))


@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gated", [False, True])
def test_q8_chain_mirror_matches_the_jax_kernel(gated, mode, H):
    p = _pair_np(gated)
    scale = (C // H) ** -0.5
    ref = _jax_launch(p, gated, jnp.float32, H, scale, mode)
    got = _chain(_torch_args(p, gated, torch.float32), H, scale, mode)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err <= JAX_TOL, err


@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gated", [False, True])
def test_q8_chain_mirror_tracks_the_jax_kernel_in_bf16(gated, mode, H):
    p = _pair_np(gated)
    scale = (C // H) ** -0.5
    ref = _jax_launch(p, gated, jnp.bfloat16, H, scale, mode)
    got = _chain(_torch_args(p, gated, torch.bfloat16), H, scale,
                 mode).float().numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    l2 = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    differ = (got != ref).mean()
    assert err <= BF16_TOL and l2 <= BF16_L2_TOL and differ <= BF16_DIFFER, \
        (err, l2, differ)
