"""The standalone attention block's chains (B4 ``mbt_attention_block`` and
B5 ``mbt_attention_block_bwd`` in csrc/block_kernels.cu) on the CPU: what
they launch, read from the sources, and a plain mirror of each launch by
launch, held against the port's plain block and the JAX package's.

On the card B4 runs [LayerNorm rows ->] the qkv product on the GEMM engine
-> the tensor-core attention core -> the output product, and B5 the same
recompute, then every product of its backward on the engine and the core's
backward on tensor cores (``tests/test_torch_cuda.py`` holds them against
the plain block). Here the mirrors take each launch's plain twin in the
chain's order (``layer_norm`` / ``ln_fwd_stats`` for ``ln_fwd_rows``,
``engine_gemm_plain`` for ``hg_gemm`` and ``hg_weight_grad``,
``st_attention_plain`` and ``_core_bwd`` for the core, fp32 sums
for the column sums, ``ln_bwd_rows`` for the LayerNorm backward) and are
held
- against ``attention_block_plain`` / ``attention_block_bwd_plain`` bit for
  bit, but the weight gradients, which the engine sums in fixed row chunks:
  their fp32 summation order may move a rounding by one bf16 step, at most
  2**-7 of max|reference|;
- in fp32 against the JAX package's XLA reference ``_fused_block_xla`` and
  its VJP: 3e-5 forward and 1e-4 backward, absolute and relative, as
  tests/test_torch_blocks.py holds the plain block (the same math, sums in
  another order);
- in bf16 against the interpreted Pallas block and its backward
  (``_fused_block_pallas``, ``_fused_block_bwd_pallas``): 2e-2 of
  max|reference| per tensor, the bar chip_smoke.py holds the kernels to
  (single bf16 rounding flips of qkv, P, attn, dattn, dS and dqkv).
Both modes, every (use_ln, residual) pair and both head dims the kernels
take (64 and 32, at C 128).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from motionbert_tpu.ops.attention import (
    _fused_block_xla, fused_attention_block as j_attention_block)
from motionbert_tpu_torch.ops import attention as at
from motionbert_tpu_torch.ops.fused_mlp import engine_gemm_plain

CSRC = Path(at.__file__).with_name("csrc")
B, F, J, C = 1, 6, 17, 128
MODES = ["temporal", "spatial"]
HEADS = [2, 4]                          # head dim 64 and 32
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
GRADS = ("dx", "dln_w", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj")
WEIGHT_GRADS = ("dwqkv", "dwproj")
# the retired kernels and their launchers: the WMMA GEMM and its TN weight
# gradient, the CUDA-core attention forward and backward, the int8 mma.sync
# GEMM
RETIRED = ("launch_gemm", "gemm_kernel", "weight_grad(",
           "launch_attention_any", "launch_st_attention_any",
           "attention_kernel", "launch_attention_bwd", "attention_bwd_kernel",
           "ATTN_THREADS", "gemm_q8_kernel", "launch_gemm_q8", "mma_s8")
# device records of each launcher (a weight gradient, a column sum and the
# LayerNorm backward are the fixed-chunk partials and the in-order pass)
RECORDS = {"hg_weight_grad": 2, "column_sum": 2, "launch_ln_bwd": 2}
# the separate LayerNorm parameter sums and row pass that the one-pass
# LayerNorm backward (launch_ln_bwd) took the place of
RETIRED_LN = ("COL_LN_W", "ln_bwd_rows_kernel", "launch_ln_bwd_rows",
              "colsum_kernel<")


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
    """The braced body of the function whose definition starts with
    ``signature``."""
    start = code.index("{", code.index(signature))
    depth = 0
    for i in range(start, len(code)):
        depth += {"{": 1, "}": -1}.get(code[i], 0)
        if depth == 0:
            return code[start:i + 1]
    raise AssertionError(signature)


def _launches(body: str) -> list:
    """The launch sites of a chain, in order: the engine (with its layout
    and epilogue), its weight gradient and the block's last product, the
    core (forward or backward), the LayerNorm rows forward, its one-pass
    backward, the column sums and the input gradient."""
    found = re.findall(
        r"(hg_gemm<\w+, \w+>|hg_weight_grad|nt_out|column_sum<\w+>|"
        r"launch_ln_fwd_rows|launch_ln_bwd|input_grad)\(|"
        r"(launch_attention_tc)\(core, (true|false)", body)
    return [a or f"{b}/{'bwd' if c == 'true' else 'fwd'}"
            for a, b, c in found]


def _hits(code: str, name: str) -> list:
    """Where ``name`` occurs in code, other than as the engine's hg_ twin."""
    return [m.start() for m in re.finditer(re.escape(name), code)
            if not code[max(0, m.start() - 3):m.start()].endswith("hg_")]


def test_block_chains_run_only_the_engine_and_the_tensor_core_core():
    """The attention block's chains launch every product on the GEMM
    engine, the attention core on tensor cores, and beside them only the
    LayerNorm rows and the column sums; the WMMA GEMM, its weight gradient,
    the CUDA-core attention forward and backward and the int8 mma.sync GEMM
    are gone from the tree."""
    code = _code("block_kernels.cu")
    for retired in RETIRED:
        assert not _hits(code, retired), retired
    assert '#include "attention_tc.cuh"' in code
    fwd = _body(code, "int mbt_attention_block(")
    bwd = _body(code, "int mbt_attention_block_bwd(")
    dx = _body(code, "cudaError_t input_grad(")
    last = _body(code, "cudaError_t nt_out(")
    assert _launches(fwd) == [
        "launch_ln_fwd_rows", "hg_gemm<NT, EPI_BIAS>",
        "launch_attention_tc/fwd", "nt_out"]
    assert _launches(bwd) == [
        "launch_ln_fwd_rows", "hg_gemm<NT, EPI_BIAS>",
        "launch_attention_tc/fwd", "hg_gemm<NN, EPI_BF16>", "hg_weight_grad",
        "column_sum<COL_BF16>", "launch_attention_tc/bwd", "hg_weight_grad",
        "column_sum<COL_F32>", "input_grad"]
    assert _launches(dx) == [
        "hg_gemm<NN, EPI_RES>", "hg_gemm<NN, EPI_BF16>",
        "hg_gemm<NN, EPI_F32>", "launch_ln_bwd"]
    assert _launches(last) == ["hg_gemm<NT, EPI_BIAS_RES>",
                               "hg_gemm<NT, EPI_BIAS>"]
    # the LayerNorm rows run only with use_ln
    for body in (fwd, bwd):
        assert re.search(r"if \(use_ln\) \{\s*CHECK\(launch_ln_fwd_rows",
                         body)
    # nothing in the tree defines or launches the retired code
    for name in sorted(p.name for p in CSRC.glob("*.cu*")):
        src = _code(name)
        for retired in ("launch_gemm<", "gemm_kernel<", "weight_grad(",
                        "attention_bwd_kernel", "launch_attention_bwd",
                        "attention_kernel", "gemm_q8_kernel", "mma_s8"):
            assert not _hits(src, retired), (name, retired)
    assert "wmma" not in _code("pair_common.cuh")
    assert not re.search(r"\battention_bwd_kernel\b|\bweight_grad\(",
                         _code("pair_bwd_common.cuh"))


def test_no_chain_sums_the_layer_norm_parameters_apart():
    """Every LayerNorm backward of the chains (B3's two, B5's and B7's
    through input_grad, mbt_ln_bwd) is launch_ln_bwd, the one pass with its
    parameter sums and their in-order chunk sum: no csrc file defines or
    launches a LayerNorm-parameter column sum (COL_LN_W) or a separate
    LayerNorm backward row pass any more."""
    for name in sorted(p.name for p in CSRC.glob("*.cu*")):
        code = _code(name)
        for retired in RETIRED_LN:
            assert retired not in code, (name, retired)
    assert _code("pair_bwd_kernels.cu").count("launch_ln_bwd(") == 2
    assert _code("block_kernels.cu").count("launch_ln_bwd(") == 2


def _chain_records(body: str, use_ln: bool, dx_records: int = 0) -> int:
    records = 0
    for launch in _launches(body):
        if launch == "launch_ln_fwd_rows" and not use_ln:
            continue
        if launch == "input_grad":
            records += dx_records
            continue
        records += RECORDS.get(launch.split("<")[0], 1)
    return records


@pytest.mark.parametrize("use_ln", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_block_records_count_the_chain_launches(backward, use_ln):
    """chip_smoke's device-record counts of one attention block call are the
    launches in the sources: the chain's, the input gradient's (one product
    without LayerNorm; with it an fp32 product and the one-pass LayerNorm
    backward with its chunk sum), and without LayerNorm the wrapper's two
    zero LayerNorm gradients."""
    code = _code("block_kernels.cu")
    if not backward:
        want = _chain_records(_body(code, "int mbt_attention_block("), use_ln)
    else:
        dx = _body(code, "cudaError_t input_grad(")
        dx_records = _chain_records(
            dx[dx.index("hg_gemm<NN, EPI_F32>"):], True) if use_ln else 1
        want = _chain_records(_body(code, "int mbt_attention_block_bwd("),
                              use_ln, dx_records) + (0 if use_ln else 2)
    assert chip_smoke.block_records("attention", backward, use_ln) == want


def _mk(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def _block_np() -> dict:
    """Block inputs in the JAX package's layout (Dense kernels (in, out)),
    weights scaled by fan_in^-0.5, and an output gradient."""
    return dict(x=_mk((B, F, J, C), 0), ln_w=_mk((C,), 1, 0.1, 1.0),
                ln_b=_mk((C,), 2, 0.1), wqkv=_mk((C, 3 * C), 3, C ** -0.5),
                bqkv=_mk((3 * C,), 4, 0.1), wproj=_mk((C, C), 5, C ** -0.5),
                bproj=_mk((C,), 6, 0.1), g=_mk((B, F, J, C), 11))


NAMES = ("x", "ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj")


def _torch_args(p: dict, dtype) -> dict:
    """The port's layout: nn.Linear weights (out, in); LayerNorm fp32."""
    out = {}
    for k in NAMES + ("g",):
        a = p[k].T if k in ("wqkv", "wproj") else p[k]
        t = torch.from_numpy(np.ascontiguousarray(a))
        out[k] = t if k.startswith("ln") else t.to(dtype)
    return out


def _plain_args(t: dict) -> list:
    return [t[k] for k in NAMES]


def _fwd_chain(t: dict, H: int, scale: float, mode: str, use_ln: bool,
               residual: bool) -> torch.Tensor:
    """block_kernels.cu's mbt_attention_block, launch by launch, each
    launch's plain twin on the chain's buffers."""
    x = t["x"]
    x2 = x.reshape(-1, C)
    attn = at.layer_norm(x2, t["ln_w"], t["ln_b"]) if use_ln else x2  # 1. h
    qkv = engine_gemm_plain("NT", "bias", attn, t["wqkv"], t["bqkv"])
    qkv = qkv.reshape(*x.shape[:3], 3 * C)                            # 2. qkv
    attn = at.st_attention_plain(qkv[..., :C], qkv[..., C:2 * C],
                                 qkv[..., 2 * C:], mode, H, scale)
    attn = attn.reshape(-1, C)                                        # 3. core
    if residual:                                                      # 4. out
        out = engine_gemm_plain("NT", "bias_res", attn, t["wproj"],
                                t["bproj"], r=x2)
    else:
        out = engine_gemm_plain("NT", "bias", attn, t["wproj"], t["bproj"])
    return out.reshape(x.shape)


def _core_bwd(q, k, v, do, mode: str, H: int, scale: float) -> tuple:
    """The tensor-core core's backward on (B, F, J, C) q, k, v and dO: fp32
    P recomputed, dv from P rounded to the compute dtype, dS = P (dP -
    sum(dP P)) * scale rounded before dq and dk, every product summed in
    fp32; (dq, dk, dv) left in fp32, as the core writes them beside their
    bf16 copies (the block sums the fp32 ones for its qkv bias)."""
    dt = q.dtype
    qh, kh, vh, dh = (at.wide(at.to_groups(a, mode, H)) for a in (q, k, v, do))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dv = torch.matmul(at.wide(p.to(dt)).transpose(-1, -2), dh)
    dp = torch.matmul(dh, vh.transpose(-1, -2))
    ds = at.wide((p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dt))
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(at.from_groups(a, mode) for a in (dq, dk, dv))


def _bwd_chain(t: dict, H: int, scale: float, mode: str, use_ln: bool,
               residual: bool) -> tuple:
    """block_kernels.cu's mbt_attention_block_bwd, launch by launch: (dx,
    dln_w, dln_b, dwqkv, dbqkv, dwproj, dbproj); the weight gradients as the
    fp32 sums of the engine's chunk partials, the bias gradients as fp32
    column sums, the LayerNorm gradients None without use_ln."""
    x, g = t["x"], t["g"]
    dt = x.dtype
    x2, g2 = x.reshape(-1, C), g.reshape(-1, C)
    if use_ln:                                          # 1. h, row stats
        xhat, rstd, hf = at.ln_fwd_stats(x2, t["ln_w"], t["ln_b"])
        h = hf.to(dt)
    else:
        h = x2
    qkv = engine_gemm_plain("NT", "bias", h, t["wqkv"], t["bqkv"])
    q, k, v = (qkv.reshape(*x.shape[:3], 3 * C)[..., i * C:(i + 1) * C]
               for i in range(3))                       # 2. qkv
    attn = at.st_attention_plain(q, k, v, mode, H, scale).reshape(-1, C)
    dattn = engine_gemm_plain("NN", "bf16", g2, t["wproj"])      # 3, 4.
    dwproj = engine_gemm_plain("TN", "partial", g2, attn).sum(0)  # 5.
    dbproj = at.wide(g2).sum(0)
    grads = _core_bwd(q, k, v, dattn.reshape(x.shape), mode, H, scale)  # 6.
    dqkv = torch.cat(grads, -1).reshape(-1, 3 * C)
    dqkvb = dqkv.to(dt)
    dwqkv = engine_gemm_plain("TN", "partial", dqkvb, h).sum(0)  # 7.
    dbqkv = dqkv.sum(0)
    dln_w = dln_b = None                                # 8. input_grad
    if use_ln:
        dh = engine_gemm_plain("NN", "f32", dqkvb, t["wqkv"])
        dx, dln_w, dln_b = at.ln_bwd_rows(dh, xhat, rstd, t["ln_w"])
        dx = (dx + at.wide(g2) if residual else dx).to(dt)
    elif residual:
        dx = engine_gemm_plain("NN", "res", dqkvb, t["wqkv"], r=g2)
    else:
        dx = engine_gemm_plain("NN", "bf16", dqkvb, t["wqkv"])
    return (dx.reshape(x.shape), dln_w, dln_b, dwqkv, dbqkv, dwproj, dbproj)


def _rel_close(got, want, tol, what):
    got, want = got.double(), want.double()
    err = (got - want).abs().max().item()
    assert err <= tol * max(want.abs().max().item(), 1e-30), (what, err)


@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("mode", MODES)
def test_block_mirrors_are_the_plain_block(mode, flags, H):
    """In bf16, the chains' rounding points are the plain block's: the
    forward bit for bit, the backward bit for bit but the weight
    gradients' summation order."""
    use_ln, residual = flags
    t = _torch_args(_block_np(), torch.bfloat16)
    scale = (C // H) ** -0.5
    out = _fwd_chain(t, H, scale, mode, use_ln, residual)
    assert out.dtype == torch.bfloat16 and out.shape == (B, F, J, C)
    assert torch.equal(out, at.attention_block_plain(
        *_plain_args(t), H, scale, mode, use_ln, residual))
    got = _bwd_chain(t, H, scale, mode, use_ln, residual)
    want = at.attention_block_bwd_plain(t["x"], t["g"], *_plain_args(t)[1:6],
                                        H, scale, mode, use_ln, residual)
    for name, a, w in zip(GRADS, got, want):
        if a is None:
            assert not use_ln and not w.any(), name
        elif name in WEIGHT_GRADS:
            _rel_close(a.to(w.dtype), w, 2 ** -7, name)
        else:
            assert torch.equal(a.to(w.dtype), w), name


def _jax_args(p: dict, dtype) -> list:
    """LayerNorm parameters stay fp32, as the model passes them."""
    return [jnp.asarray(p[k], jnp.float32 if k.startswith("ln") else dtype)
            for k in NAMES]


def _as_jax_layout(grads) -> list:
    """The mirror's gradients as fp32 arrays in the JAX op's layout
    (Dense kernels (in, out))."""
    return [None if t is None else
            (t.float().numpy().T if n in WEIGHT_GRADS else t.float().numpy())
            for n, t in zip(GRADS, grads)]


@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("mode", MODES)
def test_block_mirrors_match_jax_fp32(mode, flags, H):
    """The mirrors in fp32 against the JAX package's XLA block and its VJP."""
    use_ln, residual = flags
    p = _block_np()
    scale = (C // H) ** -0.5
    jargs = _jax_args(p, jnp.float32)
    ref, vjp = jax.vjp(lambda *a: _fused_block_xla(*a, H, scale, mode, use_ln,
                                                   residual), *jargs)
    jgrads = vjp(jnp.asarray(p["g"]))
    t = _torch_args(p, torch.float32)
    got = _fwd_chain(t, H, scale, mode, use_ln, residual)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=3e-5)
    grads = _bwd_chain(t, H, scale, mode, use_ln, residual)
    for name, a, b in zip(GRADS, _as_jax_layout(grads), jgrads):
        if a is None:
            assert not np.asarray(b).any(), name
        else:
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=1e-4,
                                       err_msg=name)


@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("mode", MODES)
def test_block_mirrors_track_pallas_bf16(mode, flags, H):
    """The mirrors in bf16 against the interpreted Pallas block and its
    Pallas backward, each tensor to 2e-2 of max|reference|."""
    use_ln, residual = flags
    p = _block_np()
    scale = (C // H) ** -0.5
    ref, vjp = jax.vjp(lambda *a: j_attention_block(*a, H, scale, mode,
                                                    use_ln, residual),
                       *_jax_args(p, jnp.bfloat16))
    jgrads = vjp(jnp.asarray(p["g"], jnp.bfloat16))
    t = _torch_args(p, torch.bfloat16)
    got = _fwd_chain(t, H, scale, mode, use_ln, residual).float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
    grads = _bwd_chain(t, H, scale, mode, use_ln, residual)
    grads = [t if n in ("dx", "dln_w", "dln_b") or t is None
             else t.to(torch.bfloat16) for n, t in zip(GRADS, grads)]
    for name, a, b in zip(GRADS, _as_jax_layout(grads), jgrads):
        b = np.asarray(jnp.asarray(b, jnp.float32))
        if a is None:
            assert not b.any(), name
        else:
            assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), name


def test_block_wrappers_validate():
    """What the chains do not take raises ValueError before any launch: a
    misaligned x, weight or g (the engine's TMA loads), more token rows
    than the tensor-core core numbers, a head dim other than 32 or 64."""
    t = _torch_args(_block_np(), torch.bfloat16)
    args = _plain_args(t)
    at.check_attention_args(*args, 2, "temporal")
    flat = torch.zeros(t["x"].numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(t["x"].shape)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        at.check_attention_args(shifted, *args[1:], 2, "temporal")
    w = torch.zeros(t["wqkv"].numel() + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        at.check_attention_args(args[0], *args[1:3],
                                w[1:].view(t["wqkv"].shape), *args[4:], 2,
                                "temporal")
    with pytest.raises(ValueError, match="16-byte-aligned"):
        at.check_aligned("g", shifted)
    with pytest.raises(ValueError, match="head dim"):
        at.check_attention_args(*args, 8, "temporal")
    assert at.core_max_rows(8) == (2 ** 31 - 1) // 8
    big = torch.empty((1, 243, 17, C), dtype=torch.bfloat16).expand(
        at.core_max_rows(4) // (243 * 17) + 1, -1, -1, -1)
    with pytest.raises(ValueError, match="token rows"):
        at.check_attention_args(big, *args[1:], 4, "temporal")
