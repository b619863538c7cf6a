"""The tensor-parallel modes of the block kernels (B4_tp, B5_tp, B6_tp, B7_tp)
and the LayerNorm backward entry (``mbt_ln_bwd``, csrc/block_kernels.cu) on
the CPU: their plain twins at small widths, the chains' launches read from
the source and mirrored launch by launch, and the wrappers' argument checks.

A head group's shards of a block with T model ranks: wqkv (3 Ci, C), the q,
k and v rows of the group's heads, and wproj (C, Ci), proj's columns of
those heads, Ci = C / T; a hidden slice of the MLP, w1 (hid / T, C) and w2
(C, hid / T). Held:
- in fp32 against the JAX package's XLA formulation
  (``motionbert_tpu/ops/attention.py`` ``layer_norm`` and
  ``_attention_xla``, ``motionbert_tpu/ops/fused_mlp.py``
  ``_fused_mlp_xla``) on the same shard-sliced weights, each shard's
  partial product and, summed over the shards in fp32 with the output bias
  and x, the JAX package's whole block (``_fused_block_xla``,
  ``_fused_mlp_xla`` with use_ln and the residual): 3e-5 of max|reference|
  forward, as ``tests/test_torch_blocks.py`` holds the plain blocks (the
  same math, sums in another order); the backward twins' weight and bias
  gradients and the fp32 gradient at the LayerNorm's output against
  ``jax.vjp`` of the shard's partial, 1e-4;
- at T = 1 in bf16 against the non-TP twins, bit for bit: the partial plus
  the output bias plus x, rounded once, is ``attention_block_plain`` /
  ``mlp_block_plain`` with LayerNorm and residual, and the backward twin
  followed by ``ln_bwd_plain`` is ``attention_block_bwd_plain`` /
  ``mlp_block_bwd_plain``;
- ``ln_bwd_plain`` against ``jax.vjp`` of the JAX package's LayerNorm
  reference (``layer_norm``), 2e-5 of max|reference| (fp32; the analytic
  backward against autodiff of var = E[x^2] - mean^2);
- the autograd Functions of ``parallel/tensor.py`` (one rank, no
  collective) by ``torch.autograd.gradcheck`` in float64.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from motionbert_tpu.ops import attention as jat
from motionbert_tpu.ops import fused_mlp as jmlp
from motionbert_tpu_torch.ops import attention as at
from motionbert_tpu_torch.ops import fused_mlp as mlp
from motionbert_tpu_torch.ops.fused_mlp import engine_gemm_plain
from motionbert_tpu_torch.parallel import tensor as tpt

CSRC = Path(at.__file__).with_name("csrc")
B, F, J, C, HID = 1, 6, 17, 128, 256
MODES = ["temporal", "spatial"]
FWD_TOL, BWD_TOL, LN_TOL = 3e-5, 1e-4, 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _mk(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def _params() -> dict:
    """A block's inputs in nn.Linear's layout, fp32 numpy."""
    return dict(x=_mk((B, F, J, C), 0), ln_w=_mk((C,), 1, 0.1, 1.0),
                ln_b=_mk((C,), 2, 0.1), wqkv=_mk((3 * C, C), 3, C ** -0.5),
                bqkv=_mk((3 * C,), 4, 0.1), wproj=_mk((C, C), 5, C ** -0.5),
                bproj=_mk((C,), 6, 0.1), w1=_mk((HID, C), 7, C ** -0.5),
                b1=_mk((HID,), 8, 0.1), w2=_mk((C, HID), 9, HID ** -0.5),
                b2=_mk((C,), 10, 0.1), g=_mk((B, F, J, C), 11))


def _heads_idx(r: int, T: int) -> np.ndarray:
    """qkv's rows of head group r of T: its q, k and v rows."""
    ci = C // T
    return np.concatenate([np.arange(r * ci, (r + 1) * ci) + i * C
                           for i in range(3)])


def _shard(p: dict, r: int, T: int) -> dict:
    """Head group r's and hidden slice r's weights (parallel.mesh's
    layout)."""
    ci, hl = C // T, HID // T
    return dict(wqkv=p["wqkv"][_heads_idx(r, T)],
                bqkv=p["bqkv"][_heads_idx(r, T)],
                wproj=p["wproj"][:, r * ci:(r + 1) * ci],
                w1=p["w1"][r * hl:(r + 1) * hl],
                b1=p["b1"][r * hl:(r + 1) * hl],
                w2=p["w2"][:, r * hl:(r + 1) * hl])


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _rel_close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


# ---------------------------------------------------------------------------
# the JAX side: a shard's partial from the JAX package's XLA pieces
# ---------------------------------------------------------------------------

def _j_attn_partial(x, ln_w, ln_b, wqkv, bqkv, wproj, heads, scale, mode):
    """nn.Linear-layout shards; flax computes h @ W^T."""
    ci = wqkv.shape[0] // 3
    h = jat.layer_norm(x, ln_w, ln_b)
    qkv = h @ wqkv.T + bqkv
    attn = jat._attention_xla(qkv[..., :ci], qkv[..., ci:2 * ci],
                              qkv[..., 2 * ci:], heads, scale, mode)
    return attn @ wproj.T


def _j_mlp_partial(x, ln_w, ln_b, w1, b1, w2):
    return jmlp._fused_mlp_xla(x, ln_w, ln_b, w1.T, b1, w2.T,
                               jnp.zeros((w2.shape[0],), jnp.float32), True,
                               False)


@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_tp_twins_match_the_jax_blocks_on_shards(mode, T):
    """Each shard's fp32 partial against the JAX package's XLA pieces on the
    same shard; the partials summed with the output bias and x against the
    JAX package's whole block."""
    p, H = _params(), 4
    heads, scale = H // T, (C // H) ** -0.5
    x = _t(p["x"])
    ln = (_t(p["ln_w"]), _t(p["ln_b"]))
    jx, jln = jnp.asarray(p["x"]), (jnp.asarray(p["ln_w"]),
                                    jnp.asarray(p["ln_b"]))
    attn_sum = np.zeros(x.shape, np.float64)
    mlp_sum = np.zeros(x.shape, np.float64)
    for r in range(T):
        s = _shard(p, r, T)
        got = at.attention_block_tp_plain(
            x, *ln, _t(s["wqkv"]), _t(s["bqkv"]), _t(s["wproj"]), heads,
            scale, mode)
        want = _j_attn_partial(jx, *jln, s["wqkv"], s["bqkv"], s["wproj"],
                               heads, scale, mode)
        assert got.dtype == torch.float32
        _rel_close(got.numpy(), want, FWD_TOL, f"attention shard {r}")
        attn_sum += got.numpy()
        got = mlp.mlp_block_tp_plain(x, *ln, _t(s["w1"]), _t(s["b1"]),
                                     _t(s["w2"]))
        want = _j_mlp_partial(jx, *jln, s["w1"], s["b1"], s["w2"])
        _rel_close(got.numpy(), want, FWD_TOL, f"MLP shard {r}")
        mlp_sum += got.numpy()
    whole = jat._fused_block_xla(
        jx, *jln, p["wqkv"].T, p["bqkv"], p["wproj"].T, p["bproj"], H,
        scale, mode, True, True)
    _rel_close(attn_sum + p["bproj"] + p["x"], whole, FWD_TOL,
               "attention, summed")
    whole = jmlp._fused_mlp_xla(jx, *jln, p["w1"].T, p["b1"], p["w2"].T,
                                p["b2"], True, True)
    _rel_close(mlp_sum + p["b2"] + p["x"], whole, FWD_TOL, "MLP, summed")


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_tp_bwd_twins_match_jax_vjp_on_shards(mode, T):
    """The backward twins' shard gradients and the fp32 gradient at the
    LayerNorm's output against jax.vjp of the shard's partial (as a
    function of the LayerNorm's output and the shard's weights); the row
    statistics against the LayerNorm's mean and rstd."""
    p, H = _params(), 4
    heads, scale = H // T, (C // H) ** -0.5
    x, g = _t(p["x"]), _t(p["g"])
    ln = (_t(p["ln_w"]), _t(p["ln_b"]))
    h = np.asarray(jat.layer_norm(jnp.asarray(p["x"]),
                                  jnp.asarray(p["ln_w"]),
                                  jnp.asarray(p["ln_b"])))
    xf = p["x"].astype(np.float64)
    mean = xf.mean(-1, keepdims=True)
    rstd = 1 / np.sqrt((xf * xf).mean(-1, keepdims=True) - mean ** 2 + 1e-6)
    for r in range(T):
        s = _shard(p, r, T)

        def attn_of_h(h, wqkv, bqkv, wproj):
            ci = wqkv.shape[0] // 3
            qkv = h @ wqkv.T + bqkv
            attn = jat._attention_xla(qkv[..., :ci], qkv[..., ci:2 * ci],
                                      qkv[..., 2 * ci:], heads, scale, mode)
            return attn @ wproj.T

        _, vjp = jax.vjp(attn_of_h, h, s["wqkv"], s["bqkv"], s["wproj"])
        dh, dwqkv, dbqkv, dwproj = vjp(jnp.asarray(p["g"]))
        got = at.attention_block_tp_bwd_plain(
            x, g, *ln, _t(s["wqkv"]), _t(s["bqkv"]), _t(s["wproj"]), heads,
            scale, mode)
        for name, a, w in zip(("dwqkv", "dbqkv", "dwproj", "dh"), got,
                              (dwqkv, dbqkv, dwproj, dh)):
            _rel_close(a.numpy(), w, BWD_TOL, f"attention shard {r} {name}")
        _rel_close(got[4].numpy(), np.concatenate([mean, rstd], -1), 1e-6,
                   "row statistics")

        def mlp_of_h(h, w1, b1, w2):
            z = jax.nn.gelu(h @ w1.T + b1, approximate=False)
            return z @ w2.T

        _, vjp = jax.vjp(mlp_of_h, h, s["w1"], s["b1"], s["w2"])
        dh, dw1, db1, dw2 = vjp(jnp.asarray(p["g"]))
        got = mlp.mlp_block_tp_bwd_plain(x, g, *ln, _t(s["w1"]), _t(s["b1"]),
                                         _t(s["w2"]))
        for name, a, w in zip(("dw1", "db1", "dw2", "dh"), got,
                              (dw1, db1, dw2, dh)):
            _rel_close(a.numpy(), w, BWD_TOL, f"MLP shard {r} {name}")


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(B, F, J, C), (4131, C)])
def test_ln_bwd_twin_matches_jax_vjp_of_layer_norm(shape, residual):
    """ln_bwd_plain(dh, x, stats, w, g) = (vjp of layer_norm's x [+ g], its
    scale and bias gradients), fp32, LN_TOL of max|reference|, at 102 and
    4131 rows: neither a multiple of the kernels' chunk counts (64, 256) nor
    of their load batch (32)."""
    p = _params()
    xa, dh, ga = _mk(shape, 0), _mk(shape, 12), _mk(shape, 11)
    _, vjp = jax.vjp(jat.layer_norm, jnp.asarray(xa),
                     jnp.asarray(p["ln_w"]), jnp.asarray(p["ln_b"]))
    dx, dw, db = vjp(jnp.asarray(dh))
    x = _t(xa)
    got = at.ln_bwd_plain(_t(dh), x, at.ln_row_stats(x), _t(p["ln_w"]),
                          _t(ga) if residual else None)
    want_dx = np.asarray(dx) + (ga if residual else 0.0)
    for name, a, w in zip(("dx", "dln_w", "dln_b"), got, (want_dx, dw, db)):
        assert a.dtype == torch.float32
        _rel_close(a.numpy(), w, LN_TOL, name)


@pytest.mark.parametrize("mode", MODES)
def test_tp_twins_at_one_rank_are_the_whole_block_bitwise(mode):
    """bf16, T = 1: the TP forward plus its epilogue is the non-TP block
    with LayerNorm and residual bit for bit, and the TP backward with the
    LayerNorm backward is its backward."""
    p, H = _params(), 4
    scale = (C // H) ** -0.5
    bf = torch.bfloat16
    t = {k: (_t(v) if k.startswith("ln") else _t(v, bf))
         for k, v in p.items()}
    x, g, ln = t["x"], t["g"], (t["ln_w"], t["ln_b"])
    a = at.attention_block_tp_plain(x, *ln, t["wqkv"], t["bqkv"], t["wproj"],
                                    H, scale, mode)
    y = ((a + at.wide(t["bproj"])) + at.wide(x)).to(bf)
    assert torch.equal(y, at.attention_block_plain(
        x, *ln, t["wqkv"], t["bqkv"], t["wproj"], t["bproj"], H, scale, mode,
        True, True))
    dwqkv, dbqkv, dwproj, dh, stats = at.attention_block_tp_bwd_plain(
        x, g, *ln, t["wqkv"], t["bqkv"], t["wproj"], H, scale, mode)
    dx, dln_w, dln_b = at.ln_bwd_plain(dh, x, stats, t["ln_w"], g)
    want = at.attention_block_bwd_plain(x, g, *ln, t["wqkv"], t["bqkv"],
                                        t["wproj"], H, scale, mode, True,
                                        True)
    got = (dx, dln_w, dln_b, dwqkv, dbqkv, dwproj,
           at.rows(g).sum(0).to(bf))
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
    b = mlp.mlp_block_tp_plain(y, *ln, t["w1"], t["b1"], t["w2"])
    out = ((b + at.wide(t["b2"])) + at.wide(y)).to(bf)
    assert torch.equal(out, mlp.mlp_block_plain(
        y, *ln, t["w1"], t["b1"], t["w2"], t["b2"], True, True))
    dw1, db1, dw2, dh, stats = mlp.mlp_block_tp_bwd_plain(
        y, g, *ln, t["w1"], t["b1"], t["w2"])
    dy, dln_w, dln_b = at.ln_bwd_plain(dh, y, stats, t["ln_w"], g)
    want = mlp.mlp_block_bwd_plain(y, g, *ln, t["w1"], t["b1"], t["w2"],
                                   True, True)
    got = (dy, dln_w, dln_b, dw1, db1, dw2, at.rows(g).sum(0).to(bf))
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


def test_tp_gate_gradcheck():
    """The gate Function (gate_plain forward, gate_bwd_plain backward at
    B3's rounding points) is the gate's derivative in float64."""
    rs = np.random.RandomState(4)
    c = 8

    def r(*shape, scale=1.0):
        return torch.from_numpy(rs.normal(size=shape) * scale).to(
            torch.float64).requires_grad_()

    args = (r(1, 3, J, c), r(1, 3, J, c), r(2, 2 * c, scale=0.3),
            r(2, scale=0.1))
    assert torch.autograd.gradcheck(tpt.Gate.apply, args, eps=1e-6,
                                    atol=1e-6)


@pytest.mark.parametrize("half", ["attention", "mlp"])
def test_tp_halves_gradcheck(half):
    """The halves' autograd Functions on one rank (no collective), float64:
    the backward the TP twins and the LayerNorm backward compose is the
    forward's derivative."""
    rs = np.random.RandomState(3)
    c, hid, heads = 8, 16, 2
    d = torch.float64

    def r(*shape, scale=1.0):
        return torch.from_numpy(rs.normal(size=shape) * scale).to(
            d).requires_grad_()

    x = r(1, 3, J, c)
    ln = (r(c, scale=0.1) + 1.0, r(c, scale=0.1))
    ln = tuple(t.detach().requires_grad_() for t in ln)
    if half == "attention":
        args = (x, *ln, r(3 * c, c, scale=0.3), r(3 * c, scale=0.1),
                r(c, c, scale=0.3), r(c, scale=0.1))

        def fn(*a):
            return tpt.TpAttentionHalf.apply(*a, heads, (c // heads) ** -0.5,
                                             "temporal", None, "plain")
    else:
        args = (x, *ln, r(hid, c, scale=0.3), r(hid, scale=0.1),
                r(c, hid, scale=0.3), r(c, scale=0.1))

        def fn(*a):
            return tpt.TpMlpHalf.apply(*a, None, "plain")
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the chains in csrc/block_kernels.cu
# ---------------------------------------------------------------------------

def _code() -> str:
    text = (CSRC / "block_kernels.cu").read_text()
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def _body(code: str, signature: str) -> str:
    start = code.index("{", code.index(signature))
    depth = 0
    for i in range(start, len(code)):
        depth += {"{": 1, "}": -1}.get(code[i], 0)
        if depth == 0:
            return code[start:i + 1]
    raise AssertionError(signature)


def _launches(body: str) -> list:
    found = re.findall(
        r"(hg_gemm<\w+, \w+>|hg_gemm_pair<\w+, \w+, \w+, \w+>|"
        r"hg_weight_grad2|hg_weight_grad|reduce_partials|column_sum<\w+>|"
        r"launch_ln_fwd_rows|launch_ln_bwd|launch_attention_tc_bwd_attn|"
        r"launch_attention_tc_sliced|ln_product|hg_ln_gemm)\(|"
        r"(launch_attention_tc)\(core, (true|false)", body)
    return [a or f"{b}/{'bwd' if c == 'true' else 'fwd'}"
            for a, b, c in found]


TP_CHAINS = {
    # the LayerNorm inside the qkv product, the core split on 243-frame
    # groups, proj
    "int mbt_attention_block_tp(": [
        "ln_product", "launch_attention_tc_sliced",
        "hg_gemm<NT, EPI_F32>"],
    # attn from the core's backward (no forward core), dWqkv and dWproj in
    # one round and one in-order pass
    "int mbt_attention_block_tp_bwd(": [
        "launch_ln_fwd_rows", "hg_gemm<NT, EPI_BIAS>", "hg_gemm<NN, EPI_BF16>",
        "launch_attention_tc_bwd_attn", "column_sum<COL_F32>",
        "hg_weight_grad2", "hg_gemm<NN, EPI_F32>"],
    "int mbt_mlp_block_tp(": [
        "launch_ln_fwd_rows", "hg_gemm<NT, EPI_BIAS_GELU>",
        "hg_gemm<NT, EPI_F32>"],
    # each TN round beside the NN product that reads its operand, one
    # in-order pass over both weight gradients' partials
    "int mbt_mlp_block_tp_bwd(": [
        "launch_ln_fwd_rows", "hg_gemm<NT, EPI_BIAS_GELU_Z>",
        "hg_gemm_pair<TN, EPI_PARTIAL, NN, EPI_DGELU>", "column_sum<COL_BF16>",
        "hg_gemm_pair<TN, EPI_PARTIAL, NN, EPI_F32>", "reduce_partials"],
    "int mbt_ln_bwd(": ["launch_ln_bwd"],
}
# the wrapper each TP chain is launched by
TP_WRAPPERS = {"int mbt_attention_block_tp(": "fused_attention_block_tp",
               "int mbt_attention_block_tp_bwd(":
                   "fused_attention_block_tp_bwd",
               "int mbt_mlp_block_tp(": "fused_mlp_block_tp",
               "int mbt_mlp_block_tp_bwd(": "fused_mlp_block_tp_bwd",
               "int mbt_ln_bwd(": "fused_ln_bwd"}
# device records of each launcher: a weight gradient (or a pair of them),
# a column sum and the LayerNorm backward are fixed-chunk partials and an
# in-order pass; the core's backward with attn is the split's two launches
# on 243-frame groups (chip_smoke's FRAMES) and one on a frame's joints; the
# first product on shards (ln_product) one launch where the LayerNorm rides
# it, else the row pass and the engine (ROUTES)
LAUNCH_RECORDS = {"hg_weight_grad": 2, "hg_weight_grad2": 2, "column_sum": 2,
                  "launch_ln_bwd": 2,
                  "launch_attention_tc_bwd_attn": {"temporal": 2,
                                                   "spatial": 1}}
# the helpers that pick a route by the shape, and what each route launches
ROUTES = {
    "cudaError_t ln_product(": {
        "one": ["hg_ln_gemm"],
        "rows": ["launch_ln_fwd_rows", "hg_gemm<NT, EPI_BIAS>"]}}


def _records(launch: str, mode: str, C: int, hidden: int) -> int:
    """Device records of one launcher in a TP chain at rows of C and a
    hidden slice of ``hidden`` (the routes' rules mirrored in Python)."""
    name = launch.split("<")[0].split("/")[0]
    if name == "ln_product":
        return 1 if mlp.ln_product_takes(C) else 2
    n = LAUNCH_RECORDS.get(name, 1)
    return n[mode] if isinstance(n, dict) else n
TP_RECORD_CASES = [(signature, mode) for signature in sorted(TP_CHAINS)
                   for mode in chip_smoke.TP_RECORDS[TP_WRAPPERS[signature]]]


@pytest.mark.parametrize("signature", sorted(TP_CHAINS))
def test_tp_chains_launch_what_their_mirrors_mirror(signature):
    """The TP entry points launch, in order, what the mirrors below take
    the plain twin of: the engine, the tensor-core core, the row passes and
    the column sums, nothing else."""
    assert _launches(_body(_code(), signature)) == TP_CHAINS[signature]


@pytest.mark.parametrize("signature,mode", TP_RECORD_CASES)
def test_tp_records_count_the_chain_launches(signature, mode):
    """chip_smoke's device-record counts of one TP call in each mode
    (TP_RECORDS, which phase 30 holds each call's profile to) are its
    chain's launches in the source; phase 30's FRAMES are 243, where the
    core's backward splits."""
    hidden = chip_smoke.HIDDEN // chip_smoke.TP_T
    want = sum(_records(launch, mode, chip_smoke.C, hidden)
               for launch in _launches(_body(_code(), signature)))
    assert chip_smoke.FRAMES == at.MAX_FRAMES
    assert chip_smoke.TP_RECORDS[TP_WRAPPERS[signature]][mode] == want


def _tp_args(T: int, dtype=torch.bfloat16) -> dict:
    p = _params()
    s = _shard(p, 0, T)
    return {k: (_t(v) if k.startswith("ln") else _t(v, dtype))
            for k, v in {**p, **s}.items()}


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_tp_attention_chains_mirror_the_twins(mode, T):
    """mbt_attention_block_tp and _tp_bwd launch by launch, each launch's
    plain twin on the chain's buffers, bf16: the forward's fp32 partial and
    the backward's dh, bias gradient and row statistics bit for bit, the
    weight gradients (fixed-chunk sums) to one bf16 step."""
    t, H = _tp_args(T), 4
    heads, scale = H // T, (C // H) ** -0.5
    ci = C // T
    x2, g2 = t["x"].reshape(-1, C), t["g"].reshape(-1, C)
    h = at.layer_norm(x2, t["ln_w"], t["ln_b"])
    qkv = mlp.ln_engine_gemm_plain(x2, t["ln_w"], t["ln_b"], t["wqkv"],
                                   t["bqkv"])
    q, k, v = (qkv.reshape(B, F, J, 3 * ci)[..., i * ci:(i + 1) * ci]
               for i in range(3))
    attn = at.st_attention_sliced_plain(q, k, v, mode, heads,
                                        scale).reshape(-1, ci)
    out = engine_gemm_plain("NT", "f32", attn, t["wproj"])
    args = (t["x"], t["ln_w"], t["ln_b"], t["wqkv"], t["bqkv"], t["wproj"],
            heads, scale, mode)
    assert torch.equal(out.reshape(t["x"].shape),
                       at.attention_block_tp_plain(*args))
    # backward: the same recompute up to qkv, dattn, the core's backward
    # halves with attn (the forward core's output, bit for bit), the weight
    # gradients' partials, dh
    stats = at.ln_row_stats(x2)
    dattn = engine_gemm_plain("NN", "bf16", g2, t["wproj"]).reshape(
        B, F, J, ci)
    dq, attn_b, core_st = at.st_attention_bwd_query_plain(q, k, v, dattn, mode,
                                                          heads, scale)
    dk, dv = at.st_attention_bwd_key_plain(q, k, v, dattn, core_st, mode,
                                           heads, scale)
    assert torch.equal(attn_b.reshape(-1, ci), attn)
    dqkvb = torch.cat([dq, dk, dv], -1).reshape(-1, 3 * ci)
    dwqkv = engine_gemm_plain("TN", "partial", dqkvb, h).sum(0)
    dwproj = engine_gemm_plain("TN", "partial", g2, attn).sum(0)
    dh = engine_gemm_plain("NN", "f32", dqkvb, t["wqkv"])
    got = at.attention_block_tp_bwd_plain(args[0], t["g"], *args[1:])
    assert torch.equal(got[3], dh.reshape(t["x"].shape))
    assert torch.equal(got[4], stats.reshape(B, F, J, 2))
    _rel_close(dwqkv.to(torch.bfloat16).float(), got[0].float(), 2 ** -7,
               "dwqkv")
    _rel_close(dwproj.to(torch.bfloat16).float(), got[2].float(), 2 ** -7,
               "dwproj")


@pytest.mark.parametrize("T", [1, 2])
def test_tp_mlp_chains_mirror_the_twins(T):
    """mbt_mlp_block_tp and _tp_bwd, and mbt_ln_bwd, launch by launch, as
    above."""
    t = _tp_args(T)
    x2, g2 = t["x"].reshape(-1, C), t["g"].reshape(-1, C)
    h = at.layer_norm(x2, t["ln_w"], t["ln_b"])
    args = (t["x"], t["ln_w"], t["ln_b"], t["w1"], t["b1"], t["w2"])
    a = engine_gemm_plain("NT", "bias_gelu", h, t["w1"], t["b1"])
    out = engine_gemm_plain("NT", "f32", a, t["w2"])
    assert torch.equal(out.reshape(t["x"].shape),
                       mlp.mlp_block_tp_plain(*args))
    a, z = engine_gemm_plain("NT", "bias_gelu_z", h, t["w1"], t["b1"])
    dw2 = engine_gemm_plain("TN", "partial", g2, a).sum(0)
    dz = engine_gemm_plain("NN", "dgelu", g2, t["w2"], z=z)
    dw1 = engine_gemm_plain("TN", "partial", dz, h).sum(0)
    db1 = at.wide(dz).sum(0)
    dh = engine_gemm_plain("NN", "f32", dz, t["w1"])
    got = mlp.mlp_block_tp_bwd_plain(args[0], t["g"], *args[1:])
    assert torch.equal(got[3], dh.reshape(t["x"].shape))
    assert torch.equal(got[1], db1.to(torch.bfloat16))
    for name, mine, want in (("dw1", dw1, got[0]), ("dw2", dw2, got[2])):
        _rel_close(mine.to(torch.bfloat16).float(), want.float(), 2 ** -7,
                   name)
    # mbt_ln_bwd: the one pass with its parameter sums, g added
    stats = got[4]
    xhat = (at.wide(t["x"]) - stats[..., :1]) * stats[..., 1:]
    dx, dln_w, dln_b = at.ln_bwd_plain(got[3], t["x"], stats, t["ln_w"],
                                       t["g"])
    _rel_close(dln_b.numpy(), got[3].sum((0, 1, 2)).numpy(), 1e-6, "dln_b")
    _rel_close(dln_w.numpy(), (got[3] * xhat).sum((0, 1, 2)).numpy(), 1e-6,
               "dln_w")
    assert dx.dtype == torch.bfloat16


@pytest.mark.parametrize("signature", sorted(ROUTES))
def test_routes_launch_what_their_mirrors_take(signature):
    """The helpers that pick a route by the shape launch, route by route,
    what _records counts, and pick it by the rule Python mirrors: the
    LayerNorm inside the product where hopper_gemm.cuh's lng_takes(C)
    holds."""
    body = _body(_code(), signature)
    routes = ROUTES[signature]
    assert _launches(body) == [launch for launches in routes.values()
                               for launch in launches]
    assert body.index("lng_takes(C)") < body.index(routes["one"][0] + "(")


def _header_constants(name: str, prefix: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(
        rf"constexpr int ({prefix}\w+) = (\d+);", text)}


def test_ln_product_constants_and_rules_match_the_source():
    """LN_PRODUCT is hopper_gemm.cuh's LNG_ constants; the Python rule
    takes C where the source's does: whole 64-column k-blocks up to 512
    (phase 30's shards and T = 1's C take the one-launch product)."""
    k = _header_constants("hopper_gemm.cuh", "LNG_")
    assert mlp.LN_PRODUCT == {"max_c": k["LNG_MAX_C"], "bm": k["LNG_BM"],
                              "stages": k["LNG_STAGES"]}
    assert [c for c in range(1, 1100) if mlp.ln_product_takes(c)] == \
        list(range(64, 513, 64))


@pytest.mark.parametrize("M", [1, 17, 300])
def test_ln_product_twin_is_layer_norm_then_the_engine_bitwise(M):
    """hg_ln_gemm's twin (each block's 128 rows normalised, then the NT
    product with its bias) is layer_norm then engine_gemm_plain over
    all rows, bit for bit, at a partial tile and fewer rows than one; the
    CPU wrapper is the twin."""
    rs = np.random.RandomState(M)
    x = _t(rs.normal(size=(M, C)).astype(np.float32) * 2 + 0.5,
           torch.bfloat16)
    ln_w, ln_b = _t(_mk((C,), 1, 0.1, 1.0)), _t(_mk((C,), 2, 0.1))
    w = _t(_mk((3 * C, C), 3, C ** -0.5), torch.bfloat16)
    b = _t(_mk((3 * C,), 4, 0.1), torch.bfloat16)
    want = engine_gemm_plain("NT", "bias", at.layer_norm(x, ln_w, ln_b), w,
                             b)
    got = mlp.ln_engine_gemm_plain(x, ln_w, ln_b, w, b)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(mlp.ln_engine_gemm(x, ln_w, ln_b, w, b), want)


@pytest.mark.parametrize("mode,frames", [("temporal", 81), ("temporal", 243),
                                         ("spatial", 81)])
def test_sliced_forward_core_twin_is_the_plain_core_bitwise(mode, frames):
    """bf16: the split forward's twin (64-row query slices of a group
    against its keys whole) is st_attention_plain bit for bit, and so is
    attention_core_fwd on CPU tensors, split or not."""
    q, k, v, _ = _core(frames, mode, torch.bfloat16)
    heads, scale = 2, 64 ** -0.5
    want = at.st_attention_plain(q, k, v, mode, heads, scale)
    got = at.st_attention_sliced_plain(q, k, v, mode, heads, scale)
    assert got.dtype == want.dtype and torch.equal(got, want)
    for split in (True, False):
        assert torch.equal(at.attention_core_fwd(q, k, v, mode, heads, scale,
                                                 split), want)


@pytest.mark.parametrize("mode", MODES)
def test_sliced_forward_core_twin_matches_the_jax_core(mode):
    """fp32, a narrow 243-frame input (C 64, 2 heads of 32): the split
    forward's twin against the JAX package's st_attention (its XLA path
    below a 128-lane channel dim), FWD_TOL of max|reference| (the same
    math, sums in another order)."""
    rs = np.random.RandomState(243)
    q, k, v = (rs.normal(size=(1, 243, J, 64)).astype(np.float32)
               for _ in range(3))
    want = jat.st_attention(*(jnp.asarray(a) for a in (q, k, v)), mode, 2,
                            32 ** -0.5)
    got = at.st_attention_sliced_plain(_t(q), _t(k), _t(v), mode, 2,
                                       32 ** -0.5)
    _rel_close(got.numpy(), want, FWD_TOL, mode)


def test_split_forward_grid_plan_at_phase_30():
    """The split forward's blocks at phase 30's shape (batch 4, 243 frames,
    4 local heads of 64): 272 items x 4 query slices = 1088 blocks, 4.12
    waves at two blocks an SM on 132 SMs, where the one-launch kernel's 272
    blocks at one an SM take 2.06; the spatial core keeps its 4 items a
    block; the slice is TC_SLICE_WARPS warps of TC_KEY_TILE rows."""
    k = _header_constants("attention_tc.cuh", "TC_")
    assert at.CORE_SLICE_ROWS == k["TC_SLICE_WARPS"] * k["TC_KEY_TILE"]
    assert at.CORE_KEY_TILE == k["TC_KEY_TILE"]
    shape = (chip_smoke.B, chip_smoke.FRAMES, J, chip_smoke.C)
    heads = chip_smoke.HEADS // chip_smoke.TP_T
    (split,) = at.attn_tp_fwd_core_plan(shape, heads, "temporal", 2,
                                        132)["launches"]
    assert split["blocks"] == 1088 and round(split["waves"], 2) == 4.12
    assert at.core_splits_forward(243) and at.core_splits_forward(81)
    assert not at.core_splits_forward(17) and not at.core_splits_forward(64)
    (spatial,) = at.attn_tp_fwd_core_plan(shape, heads, "spatial", 2,
                                          132)["launches"]
    assert spatial["blocks"] == chip_smoke.B * chip_smoke.FRAMES * heads // 4


# ---------------------------------------------------------------------------
# B5_tp's core backward with attn, split into its query-major and key-major
# halves (csrc/attention_tc.cuh), and the engine's grouped launch
# (csrc/hopper_gemm.cuh hg_gemm_pair)
# ---------------------------------------------------------------------------

def _core(frames: int, mode: str, dtype, heads: int = 2, width: int = 128):
    """q, k, v and the output gradient (1, frames, J, width), seeded."""
    rs = np.random.RandomState(frames)
    return [_t(rs.normal(size=(1, frames, J, width)).astype(np.float32),
               dtype) for _ in range(4)]


@pytest.mark.parametrize("mode,frames", [("temporal", 81), ("temporal", 243),
                                         ("spatial", 81)])
def test_split_core_halves_are_the_plain_core_bitwise(mode, frames):
    """bf16: the query-major half's dq and the key-major half's dk and dv,
    from the query-major half's row statistics, are st_attention_bwd_plain's
    bit for bit, and the query-major half's attn is st_attention_plain's;
    the statistics are (B, groups, heads, 3, N), D = rowsum(dP * P) last;
    attention_core_bwd_attn on a CPU tensor is the two halves."""
    q, k, v, g = _core(frames, mode, torch.bfloat16)
    heads, scale = 2, 64 ** -0.5
    dq, attn, stats = at.st_attention_bwd_query_plain(q, k, v, g, mode, heads,
                                                      scale)
    dk, dv = at.st_attention_bwd_key_plain(q, k, v, g, stats, mode, heads,
                                           scale)
    for got, want in zip((dq, dk, dv), at.st_attention_bwd_plain(
            q, k, v, g, mode, heads, scale)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(attn, at.st_attention_plain(q, k, v, mode, heads,
                                                   scale))
    groups, n = (J, frames) if mode == "temporal" else (frames, J)
    assert stats.shape == (1, groups, heads, 3, n)
    assert stats.dtype == torch.float32
    got = at.attention_core_bwd_attn(q, k, v, g, mode, heads, scale, True)
    for a, b in zip(got, (dq, dk, dv, attn, None, None, None, stats)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("mode,frames", [("temporal", 81), ("temporal", 243),
                                         ("spatial", 81)])
def test_split_core_halves_match_jax_vjp(mode, frames):
    """fp32: the halves' dq, dk, dv against jax.vjp of the JAX package's
    XLA core (``_attention_xla``) for the same output gradient, BWD_TOL of
    max|reference|, and attn against that core's output, FWD_TOL (the same
    math, sums in another order); the statistics' D against the analytic
    rowsum(dP * P) from the JAX core's softmax."""
    q, k, v, g = _core(frames, mode, torch.float32)
    heads, scale = 2, 64 ** -0.5
    dq, attn, stats = at.st_attention_bwd_query_plain(q, k, v, g, mode, heads,
                                                      scale)
    dk, dv = at.st_attention_bwd_key_plain(q, k, v, g, stats, mode, heads,
                                           scale)
    jq, jk, jv, jg = (jnp.asarray(t.numpy()) for t in (q, k, v, g))
    out, vjp = jax.vjp(lambda a, b, c: jat._attention_xla(a, b, c, heads,
                                                          scale, mode),
                       jq, jk, jv)
    _rel_close(attn.numpy(), out, FWD_TOL, "attn")
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), vjp(jg)):
        _rel_close(a.numpy(), w, BWD_TOL, name)
    qh, kh, vh, gh = (at.to_groups(t, mode, heads) for t in (q, k, v, g))
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, -1)
    d = (torch.matmul(gh, vh.transpose(-1, -2)) * p).sum(-1)
    _rel_close(stats[..., 2, :].numpy(), d.numpy(), 1e-6, "D")


def _engine_case(rs, layout, epi, M, N, K):
    """engine_gemm's arguments of one product, seeded, bf16 (fp32 z)."""
    def bf(*shape):
        return _t(rs.normal(size=shape).astype(np.float32), torch.bfloat16)
    a = bf(M, N) if layout == "TN" else bf(M, K)
    w = bf(M, K) if layout == "TN" else bf(K, N)
    z = _t(rs.normal(size=(M, N)).astype(np.float32)) \
        if epi == "dgelu" else None
    return (layout, epi, a, w, None, None, z)


@pytest.mark.parametrize("pair", mlp.ENGINE_PAIRS)
def test_engine_pair_on_the_cpu_is_its_two_plain_products(pair):
    """engine_gemm_pair on CPU tensors returns each product's
    engine_gemm_plain, bit for bit, at 300 rows (not a multiple of a
    tile or of the TN chunks' k-step)."""
    rs = np.random.RandomState(5)
    cases = [_engine_case(rs, *case, 300, 128, 192) for case in pair]
    got = mlp.engine_gemm_pair(*cases)
    for a, case in zip(got, cases):
        assert torch.equal(a, engine_gemm_plain(*case))


# (product 0's tiles, k-steps a tile and epilogue, product 1's, the grid,
# the lead hg_gemm_pair picks): B5_tp's dWqkv + dWproj, B7_tp's dW2 + dz
# and dW1 + dh at phase 30's shards (16524 rows, Ci 256, hidden slice 512,
# 264 resident blocks), B3's dW2 + dz and dW1 + dh (C 512, hidden 1024), a
# product 0 longer than the grid, and a grid smaller than the products
PAIR_SHAPES = [((192, 33, "partial"), (64, 33, "partial"), 256, 1),
               ((128, 33, "partial"), (520, 8, "dgelu"), 264, 2),
               ((128, 33, "partial"), (520, 8, "f32"), 264, 4),
               ((256, 33, "partial"), (1040, 8, "dgelu"), 264, 2),
               ((256, 33, "partial"), (520, 16, "f32"), 264, 2),
               ((600, 5, "partial"), (100, 9, "f32"), 264, 1),
               ((1, 33, "partial"), (3, 8, "f32"), 4, 4)]


@pytest.mark.parametrize("first,second,grid,lead", PAIR_SHAPES)
def test_engine_pair_schedule_takes_every_tile_once(first, second, grid,
                                                    lead):
    """hg_gemm_pair_kernel's walk (engine_pair_schedule) at the lead
    hg_gemm_pair's rule picks (engine_pair_lead: the tiles' k-steps, GELU'
    counted 8 more): every tile of both products exactly once, each block's
    product-0 tiles before its product-1 tiles, and a makespan, in k-steps
    with the epilogues', no longer than the two products launched one
    after the other."""
    (n0, k0, e0), (n1, k1, e1) = first, second
    assert mlp.engine_pair_lead(k0, k1, e0, e1) == lead
    blocks = mlp.engine_pair_schedule(n0, n1, grid, lead)
    tiles = [t for b in blocks for t in b]
    assert sorted(tiles) == [(0, t) for t in range(n0)] + \
        [(1, j) for j in range(n1)]
    assert all(b == sorted(b) for b in blocks)
    cost = {p: k + mlp.ENGINE_EPILOGUE_STEPS.get(e, 0)
            for p, (k, e) in enumerate(((k0, e0), (k1, e1)))}
    grouped = max(sum(cost[p] for p, _ in b) for b in blocks)
    rounds = lambda n, k: -(-n // grid) * k
    assert grouped <= rounds(n0, cost[0]) + rounds(n1, cost[1])


# ---------------------------------------------------------------------------
# what the CUDA wrappers refuse (checked before any launch)
# ---------------------------------------------------------------------------

def _misaligned(t: torch.Tensor) -> torch.Tensor:
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


def test_tp_attention_args_refuse_what_the_chains_do_not_take():
    """A head group of 2 heads of 32 at C 128 (T 2) passes; a misaligned
    shard, a head count that does not divide the group's width (or gives a
    head dim outside 32 / 64), a group narrower than 64 and more token rows
    than ``core_max_rows`` of the local heads raise."""
    t = _tp_args(2)
    args = [t[k] for k in ("x", "ln_w", "ln_b", "wqkv", "bqkv", "wproj")]
    at.check_attention_args(*args, None, 2, "temporal", True, tp=True)
    for i in (0, 3, 4, 5):
        bad = list(args)
        bad[i] = _misaligned(args[i])
        with pytest.raises(ValueError, match="16-byte-aligned"):
            at.check_attention_args(*bad, None, 2, "temporal", True, tp=True)
    for heads in (3, 8):
        with pytest.raises(ValueError, match="head dim"):
            at.check_attention_args(*args, None, heads, "temporal", True,
                                    tp=True)
    narrow = _tp_args(4)
    with pytest.raises(ValueError, match="Ci % 64"):
        at.check_attention_args(
            *[narrow[k] for k in ("x", "ln_w", "ln_b", "wqkv", "bqkv",
                                  "wproj")], None, 1, "temporal", True,
            tp=True)
    # the whole block's shapes are refused as a shard, and the reverse
    whole = _tp_args(1)
    with pytest.raises(ValueError, match="wproj"):
        at.check_attention_args(*args[:3], args[3], args[4], whole["wproj"],
                                None, 2, "temporal", True, tp=True)
    assert at.core_max_rows(2) == (2 ** 31 - 1) // 2
    big = torch.empty((1, 243, 17, C), dtype=torch.bfloat16).expand(
        at.core_max_rows(2) // (243 * 17) + 1, -1, -1, -1)
    with pytest.raises(ValueError, match="token rows"):
        at.check_attention_args(big, *args[1:], None, 2, "temporal", True,
                                tp=True)
    # rows within the limit get past it (to the expanded view's stride)
    with pytest.raises(ValueError, match="contiguous"):
        at.check_attention_args(big[:at.core_max_rows(2) // (243 * 17)],
                                *args[1:], None, 2, "temporal", True,
                                tp=True)


def test_tp_mlp_and_ln_bwd_args_refuse_what_the_chains_do_not_take():
    t = _tp_args(2)
    args = [t[k] for k in ("x", "ln_w", "ln_b", "w1", "b1", "w2")]
    mlp.check_mlp_args(*args, None, True)
    for i in (0, 3, 5):
        bad = list(args)
        bad[i] = _misaligned(args[i])
        with pytest.raises(ValueError, match="16-byte-aligned"):
            mlp.check_mlp_args(*bad, None, True)
    narrow = _tp_args(8)
    with pytest.raises(ValueError, match="hidden % 64"):
        mlp.check_mlp_args(*[narrow[k] for k in ("x", "ln_w", "ln_b", "w1",
                                                  "b1", "w2")], None, True)
    x, g = t["x"], t["g"]
    dh = torch.zeros(x.shape)
    stats = torch.zeros(*x.shape[:-1], 2)
    at.check_ln_bwd_args(dh, x, stats, t["ln_w"], g)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        at.check_ln_bwd_args(_misaligned(dh), x, stats, t["ln_w"], g)
    with pytest.raises(ValueError, match="dh"):
        at.check_ln_bwd_args(dh.to(torch.bfloat16), x, stats, t["ln_w"], g)
    with pytest.raises(ValueError, match="stats"):
        at.check_ln_bwd_args(dh, x, stats[..., :1].contiguous(), t["ln_w"], g)
