"""The port's CUDA pair kernels (forward, backward and the int8 W8A8 forward)
on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. This file imports
neither jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from motionbert_tpu_torch.core.config import ConfigDict
from motionbert_tpu_torch.models.factory import load_backbone
from motionbert_tpu_torch.ops import attention as at
from motionbert_tpu_torch.ops import fused_mlp as mlp
from motionbert_tpu_torch.ops import fused_pair as fp
from motionbert_tpu_torch.ops import pair_q8 as q8

# bf16 kernel vs bf16 plain: rounding flips of intermediates only
TOL = 2e-2
# int8 kernel vs its plain version: the integer products are exact on both
# sides, so they differ by bf16 rounding flips of qkv, attn and y as above,
# and by single int8 steps where LN or GELU (this card's rsqrtf and erff, a
# warp's summation order) land a value across a quantiser boundary
Q8_TOL = 2e-2
# the same as a relative L2 (measured 1.0e-3 to 1.5e-3 at the flagship
# shape): a rounding point moved in the chain shows as 6e-3 or more
Q8_L2_TOL = 4e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(device, gated, C=512, H=8, F=81, B=1, hidden=None):
    rs = np.random.RandomState(0)
    hidden = hidden or 2 * C

    def t(*shape, scale=1.0, shift=0.0, dt=torch.bfloat16):
        a = rs.normal(size=shape).astype(np.float32) * scale + shift
        return torch.from_numpy(a).to(device=device, dtype=dt)

    f32 = torch.float32
    args = [t(B, F, 17, C)] + ([t(B, F, 17, C)] if gated else [])
    args += [t(C, scale=0.1, shift=1.0, dt=f32), t(C, scale=0.1, dt=f32),
             t(3 * C, C, scale=C ** -0.5), t(3 * C, scale=0.1),
             t(C, C, scale=C ** -0.5), t(C, scale=0.1),
             t(C, scale=0.1, shift=1.0, dt=f32), t(C, scale=0.1, dt=f32),
             t(hidden, C, scale=C ** -0.5), t(hidden, scale=0.1),
             t(C, hidden, scale=hidden ** -0.5), t(C, scale=0.1)]
    if gated:
        args += [t(2, 2 * C, scale=(2 * C) ** -0.5), t(2, scale=0.1, shift=0.5)]
    return args, H


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def _rel_l2(out, ref):
    return (torch.linalg.norm(out.float() - ref.float())
            / torch.linalg.norm(ref.float())).item()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("C,H", [(512, 8), (256, 8)])  # head dim 64 and 32
def test_kernel_matches_plain(cuda, mode, gated, C, H):
    args, H = _inputs(cuda, gated, C=C, H=H)
    wrapper = fp.fused_gated_pair_block if gated else fp.fused_pair_block
    plain = fp.gated_pair_block_plain if gated else fp.pair_block_plain
    before = wrapper.launches
    out = wrapper(*args, H, (C // H) ** -0.5, mode)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    assert _rel(out, plain(*args, H, (C // H) ** -0.5, mode)) <= TOL


@pytest.mark.cuda
def test_kernel_ragged_rows_and_single_frame(cuda):
    """M = B*F*J not a multiple of the engine's 128-row tile, and F = 1."""
    for F in (1, 5, 243):
        args, H = _inputs(cuda, False, F=F, B=2)
        out = fp.fused_pair_block(*args, H, 0.125, "temporal")
        assert _rel(out, fp.pair_block_plain(*args, H, 0.125,
                                             "temporal")) <= TOL


@pytest.mark.cuda
def test_cuda_tensor_never_falls_back(cuda):
    args, H = _inputs(cuda, False)
    args[0] = args[0].float()
    with pytest.raises(ValueError, match="bfloat16"):
        fp.fused_pair_block(*args, H, 0.125, "spatial")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("gated", [False, True])
def test_kernel_is_bitwise_repeatable(cuda, gated, mode):
    """Each output of the forward chain is written once by one block: two
    runs give the same bits."""
    args, H = _inputs(cuda, gated)
    wrapper = fp.fused_gated_pair_block if gated else fp.fused_pair_block
    assert torch.equal(wrapper(*args, H, 0.125, mode),
                       wrapper(*args, H, 0.125, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
def test_kernel_runs_only_the_engine_and_the_tensor_core_core(cuda, gated):
    """A call's profile holds the GEMM engine, the tensor-core core, the
    LayerNorm rows (and the gate) and nothing else: no WMMA GEMM, no
    CUDA-core attention kernel."""
    import chip_smoke

    args, H = _inputs(cuda, gated)
    wrapper = fp.fused_gated_pair_block if gated else fp.fused_pair_block
    ms, rows = chip_smoke.device_profile(
        lambda: wrapper(*args, H, 0.125, "temporal"),
        chip_smoke.pair_records(gated), calls=2)
    assert ms is not None, rows
    names = {key for key, _, _ in rows}
    wanted = chip_smoke.PAIR_KERNELS + (("gate_kernel",) if gated else ())
    for fragment in wanted:
        assert any(fragment in key for key in names), (fragment, names)
    assert not chip_smoke.retired_kernels(rows), names


@pytest.mark.cuda
def test_kernel_raises_on_a_misaligned_input(cuda):
    """The forward chain reads x and the weights through the engine's TMA
    loads, which take 16-byte-aligned addresses only, and the W8A8 chain
    reads x with vector loads: both raise, never fall back (a misaligned
    load would end the process's CUDA context)."""
    args, H = _inputs(cuda, False, F=3)
    x = args[0]
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:]
    shifted.copy_(x.reshape(-1))
    args[0] = shifted.view(x.shape)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fp.fused_pair_block(*args, H, 0.125, "temporal")
    with pytest.raises(ValueError, match="16-byte-aligned"):
        q8.fused_pair_block_q8(*args, H, 0.125, "temporal")


@pytest.mark.cuda
def test_model_kernels_match_fp32_plain(cuda):
    cfg = ConfigDict(dim_feat=512, dim_rep=512, depth=2, num_heads=8,
                     mlp_ratio=2, num_joints=17, maxlen=81)
    model = load_backbone(cfg, device=cuda)
    model.init_weights(torch.Generator().manual_seed(0))
    ref = load_backbone(cfg, dtype=torch.float32, device=cuda,
                        attn_impl="plain")
    ref.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (2, 81, 17, 3)).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        assert _rel(model(x, return_rep=True),
                    ref(x, return_rep=True)) <= TOL


def _bwd(gated):
    return (fp.fused_gated_pair_block_bwd, fp.gated_pair_block_bwd_plain) \
        if gated else (fp.fused_pair_block_bwd, fp.pair_block_bwd_plain)


def _bwd_args(args, g, gated):
    """Forward arguments -> the backward wrappers' (x, [other,] g, ...)."""
    return [args[0]] + ([args[1]] if gated else []) + [g] \
        + args[(2 if gated else 1):]


def _grad_out(device, shape, seed=7):
    a = np.random.RandomState(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("C,H", [(512, 8), (256, 8)])  # head dim 64 and 32
def test_bwd_kernel_matches_plain(cuda, mode, gated, C, H):
    args, H = _inputs(cuda, gated, C=C, H=H)
    bargs = _bwd_args(args, _grad_out(cuda, args[0].shape), gated)
    kernel, plain = _bwd(gated)
    before = kernel.launches
    got = kernel(*bargs, H, (C // H) ** -0.5, mode)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(*bargs, H, (C // H) ** -0.5, mode)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.isfinite(a.float()).all(), i
        assert _rel(a, b) <= TOL, (i, _rel(a, b))


@pytest.mark.cuda
def test_bwd_kernel_ragged_rows_and_single_frame(cuda):
    for F, gated, mode in ((1, False, "temporal"), (5, True, "spatial"),
                           (243, False, "temporal")):
        args, H = _inputs(cuda, gated, F=F, B=2)
        bargs = _bwd_args(args, _grad_out(cuda, args[0].shape), gated)
        kernel, plain = _bwd(gated)
        got = kernel(*bargs, H, 0.125, mode)
        want = plain(*bargs, H, 0.125, mode)
        for i, (a, b) in enumerate(zip(got, want)):
            assert _rel(a, b) <= TOL, (F, i, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
def test_bwd_kernel_is_bitwise_repeatable(cuda, gated):
    args, H = _inputs(cuda, gated)
    bargs = _bwd_args(args, _grad_out(cuda, args[0].shape), gated)
    kernel, _ = _bwd(gated)
    first = kernel(*bargs, H, 0.125, "temporal")
    second = kernel(*bargs, H, 0.125, "temporal")
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bwd_cuda_tensor_never_falls_back(cuda):
    args, H = _inputs(cuda, False)
    bargs = _bwd_args(args, _grad_out(cuda, args[0].shape), False)
    bargs[1] = bargs[1].float()   # an fp32 output gradient
    with pytest.raises(ValueError, match="bfloat16"):
        fp.fused_pair_block_bwd(*bargs, H, 0.125, "spatial")


@pytest.mark.cuda
def test_autograd_through_the_kernels(cuda):
    """loss.backward() through the wrappers reaches x, other and every
    parameter through the backward kernel."""
    args, H = _inputs(cuda, True, F=27)
    args = [a.requires_grad_() for a in args]
    before = fp.fused_gated_pair_block_bwd.launches
    out = fp.fused_gated_pair_block(*args, H, 0.125, "temporal")
    out.float().square().mean().backward()
    assert fp.fused_gated_pair_block_bwd.launches == before + 1
    assert all(a.grad is not None and torch.isfinite(a.grad.float()).all()
               for a in args)


@pytest.mark.cuda
def test_train_steps_depth2_flagship_width(cuda):
    """Three AdamW steps of a depth-2 model at the flagship width through the
    kernels: finite, falling loss; the first step's gradients against the
    fp32 plain path with autograd (cosine of all gradients as one vector)."""
    from motionbert_tpu_torch.losses.pose import pose3d_total_loss
    from motionbert_tpu_torch.train.pose3d import (
        make_train_step, preprocess_batch)
    from motionbert_tpu_torch.train.state import make_adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    lambdas = dict(lambda_scale=0.5, lambda_3d_velocity=20.0)
    cfg = ConfigDict(dim_feat=512, dim_rep=512, depth=2, num_heads=8,
                     mlp_ratio=2, num_joints=17, maxlen=81)
    model = load_backbone(cfg, device=cuda)
    model.init_weights(torch.Generator().manual_seed(0))
    ref = load_backbone(cfg, dtype=torch.float32, device=cuda,
                        attn_impl="plain")
    ref.load_state_dict(model.state_dict())
    rs = np.random.RandomState(2)
    y = torch.from_numpy(rs.uniform(-1, 1, (2, 81, 17, 3)).astype(
        np.float32)).to(cuda)
    x = torch.cat([y[..., :2], torch.ones_like(y[..., :1])], -1)

    grads = []
    for m in (model, ref):
        m.train()
        xb, yb, _ = preprocess_batch(x, y, rootrel=True, no_conf=False)
        pose3d_total_loss(m(xb).float(), yb, {**dict.fromkeys(
            ("lambda_lv", "lambda_lg", "lambda_a", "lambda_av"), 0.0),
            **lambdas})[0].backward()
        grads.append(torch.cat([p.grad.float().flatten()
                                for p in m.parameters()]))
        m.zero_grad(set_to_none=True)
    cos = torch.nn.functional.cosine_similarity(grads[0], grads[1], dim=0)
    assert cos.item() >= 0.999, cos.item()

    opt = make_adamw(model.parameters(), 1e-3, 0.01)
    step = make_train_step(model, opt, lambdas, rootrel=True, no_conf=False)
    before = fp.fused_pair_block_bwd.launches
    losses = [step(x, y)["total"].item() for _ in range(3)]
    assert fp.fused_pair_block_bwd.launches == before + 3 * 6
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# the W8A8 pair (ops/pair_q8.py, csrc/pair_q8_kernels.cu)
# ---------------------------------------------------------------------------

def _q8(gated):
    return (q8.fused_gated_pair_block_q8, q8.gated_pair_block_q8_plain) \
        if gated else (q8.fused_pair_block_q8, q8.pair_block_q8_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("C,H", [(512, 8), (256, 8)])  # head dim 64 and 32
def test_q8_kernel_matches_plain(cuda, mode, gated, C, H):
    args, H = _inputs(cuda, gated, C=C, H=H)
    wrapper, plain = _q8(gated)
    before = wrapper.launches, fp.fused_pair_block.launches
    out = wrapper(*args, H, (C // H) ** -0.5, mode)
    torch.cuda.synchronize()
    assert wrapper.launches == before[0] + 1
    assert fp.fused_pair_block.launches == before[1]
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    assert torch.isfinite(out.float()).all()
    ref = plain(*args, H, (C // H) ** -0.5, mode)
    assert _rel(out, ref) <= Q8_TOL
    assert _rel_l2(out, ref) <= Q8_L2_TOL, _rel_l2(out, ref)
    # the same launch again gives the same bits: no atomics in the chain
    assert torch.equal(out, wrapper(*args, H, (C // H) ** -0.5, mode))


@pytest.mark.cuda
def test_q8_kernel_ragged_rows_and_single_frame(cuda):
    """M = B*F*J not a multiple of the 64-row tile, and F = 1."""
    for F in (1, 5, 243):
        args, H = _inputs(cuda, False, F=F, B=2)
        out = q8.fused_pair_block_q8(*args, H, 0.125, "temporal")
        assert _rel(out, q8.pair_block_q8_plain(*args, H, 0.125,
                                                "temporal")) <= Q8_TOL


@pytest.mark.cuda
def test_q8_kernel_rows_with_extreme_values(cuda):
    """Rows with extreme values, where a wrong row scale or a missing clip
    would show: a constant row (LN output is ln_b) and a row with one
    dominant value."""
    args, H = _inputs(cuda, False, F=9)
    x = args[0].clone()
    x[0, 0, 0, :] = 0.0                 # a constant row: LN output is ln_b
    x[0, 1, 0, 0] = 300.0               # one dominant value in a row
    args[0] = x
    out = q8.fused_pair_block_q8(*args, H, 0.125, "spatial")
    assert torch.isfinite(out.float()).all()
    assert _rel(out, q8.pair_block_q8_plain(*args, H, 0.125,
                                            "spatial")) <= Q8_TOL


@pytest.mark.cuda
def test_q8_wrapper_raises_on_misaligned_width_and_never_falls_back(cuda):
    """C = 96 has no whole 64-deep int8 tile; fp32 input has no kernel. On a
    CUDA tensor both raise: neither the plain version nor the bf16 kernels
    step in."""
    args, H = _inputs(cuda, False, C=96, H=3, hidden=192)
    before = q8.fused_pair_block_q8.launches, fp.fused_pair_block.launches
    with pytest.raises(ValueError, match="C % 64"):
        q8.fused_pair_block_q8(*args, H, 32 ** -0.5, "spatial")
    args, H = _inputs(cuda, True)
    args[0] = args[0].float()
    with pytest.raises(ValueError, match="bfloat16"):
        q8.fused_gated_pair_block_q8(*args, H, 0.125, "temporal")
    assert (q8.fused_pair_block_q8.launches,
            fp.fused_pair_block.launches) == before


@pytest.mark.cuda
def test_autograd_through_the_q8_function_is_straight_through(cuda):
    """loss.backward() through FusedGatedPairQ8 launches the bf16 pair's
    backward kernel once and gives every input the gradient the bf16
    Function gives for the same cotangent, bit for bit."""
    args, H = _inputs(cuda, True, F=27)
    g = _grad_out(cuda, args[0].shape)
    before = fp.fused_gated_pair_block_bwd.launches
    grads = []
    for fn in (q8.fused_gated_pair_block_q8, fp.fused_gated_pair_block):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        out = fn(*leaves, H, 0.125, "temporal")
        grads.append(torch.autograd.grad(out, leaves, g))
    assert fp.fused_gated_pair_block_bwd.launches == before + 2
    for a, b in zip(*grads):
        assert torch.isfinite(a.float()).all() and torch.equal(a, b)


def _core_fp64(q, k, v, mode, num_heads, scale):
    """The plain attention core's rounding points with everything between
    them in float64: scores and softmax in fp64, P rounded to q's dtype,
    P.V in fp64, the output rounded to q's dtype. A core at least as exact
    as the plain one, in no kernel's summation order."""
    qh, kh, vh = (at.to_groups(t, mode, num_heads).double()
                  for t in (q, k, v))
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale,
                      dim=-1).to(q.dtype)
    return at.from_groups(torch.matmul(p.double(), vh).to(q.dtype), mode)


@pytest.mark.cuda
def test_model_q8_kernels_match_plain_q8(cuda, monkeypatch):
    """A depth-2 model at the flagship width: the int8 kernels against the
    plain q8 path in the same dtype, and against the fp32 full-precision
    plain path within the serving tier's gate (5 % relative L2).

    Through eight pairs the int8 row quantisers turn one-ulp bf16
    differences of the attention output into different int8 bins, so the
    representation's distance from plain q8 measures how the core sums, not
    whether it is right: the plain q8 path itself, with only its core
    evaluated in float64 at the same rounding points, lands ~1.2 % from
    plain q8 (relative L2 0.0113-0.0125 over seeds 1-3 on the card). So the
    relative-L2 bar is that spread of the reference, measured here on the
    same model and input, by 1.25 (the tensor-core core measured 0.99-1.03
    of it), and never below the old 1e-2; the max bar stays 5e-2 of
    max|ref|. And the kernels must be no further from the fp32 model than
    their plain twin, up to 2 %: a moved rounding point or a wrong scale
    fails that, however the core sums (one pair alone stays within Q8_TOL,
    test_q8_kernel_matches_plain)."""
    cfg = ConfigDict(dim_feat=512, dim_rep=512, depth=2, num_heads=8,
                     mlp_ratio=2, num_joints=17, maxlen=81)
    model = load_backbone(cfg, device=cuda, attn_impl="kernel_q8")
    model.init_weights(torch.Generator().manual_seed(0))
    plain = load_backbone(cfg, device=cuda, attn_impl="plain_q8")
    plain.load_state_dict(model.state_dict())
    ref = load_backbone(cfg, dtype=torch.float32, device=cuda,
                        attn_impl="plain")
    ref.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (2, 81, 17, 3)).astype(np.float32)).to(cuda)
    counters = (q8.fused_pair_block_q8, q8.fused_gated_pair_block_q8,
                fp.fused_pair_block, fp.fused_gated_pair_block)
    before = [c.launches for c in counters]
    with torch.inference_mode():
        out = model(x, return_rep=True)
        assert [c.launches - b for c, b in zip(counters, before)] \
            == [6, 2, 0, 0]
        want = plain(x, return_rep=True)
        full = ref(x, return_rep=True)
        monkeypatch.setattr(q8, "st_attention_plain", _core_fp64)
        plain_fp64_core = plain(x, return_rep=True)
    spread = _rel_l2(plain_fp64_core, want)
    assert _rel_l2(out, want) <= max(1e-2, 1.25 * spread) \
        and _rel(out, want) <= 5e-2, \
        (_rel_l2(out, want), spread, _rel(out, want))
    assert 0 < _rel_l2(out, full) <= 0.05, _rel_l2(out, full)
    assert _rel_l2(out, full) <= 1.02 * _rel_l2(want, full), \
        (_rel_l2(out, full), _rel_l2(want, full))


# the s8 engine's fp32 GELU epilogue against the plain twin's: the same
# fp32 sum, then this card's erff in the kernel and PyTorch's erf kernel in
# the plain version, a few ulps apart at most
Q8_ENGINE_GELU_TOL = 1e-6


def _q8_engine_operands(device, epi, M, N, K, seed=0):
    """a8, ascale, w8, wscale, bias (and r for bias_res) on the card, with
    scales of the sizes the quantisers give (row 0 of a8 and w8 all 127:
    the largest sum a K-long row can take)."""
    rs = np.random.RandomState(seed)
    a8 = rs.randint(-127, 128, size=(M, K)).astype(np.int8)
    w8 = rs.randint(-127, 128, size=(N, K)).astype(np.int8)
    a8[0], w8[0] = 127, 127
    arrays = [a8, rs.uniform(1e-3, 1e-1, M).astype(np.float32), w8,
              rs.uniform(1e-4, 1e-2, N).astype(np.float32)]
    out = [torch.from_numpy(a).to(device) for a in arrays]
    out.append(torch.from_numpy(rs.normal(size=N).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16))
    out.append(torch.from_numpy(rs.normal(size=(M, N)).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16)
        if epi == "bias_res" else None)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("epi", ["bias", "bias_res", "bias_gelu_f32"])
@pytest.mark.parametrize("M,N,K", [(37, 64, 64), (300, 192, 128),
                                   (1, 64, 1024), (16524, 1536, 512),
                                   (16523, 512, 1024)])
def test_q8_engine_matches_the_integer_product(cuda, epi, M, N, K):
    """The s8 engine (csrc/hopper_gemm_s8.cuh) against its plain
    twin on the same card: int32 sums are exact, and the epilogue takes the
    plain version's order without fused multiply-adds, so bias and bias_res are
    equal bit for bit (ragged M, partial column tiles and the W8A8 pair's
    widths included); GELU within Q8_ENGINE_GELU_TOL; twice the same bits."""
    args = _q8_engine_operands(cuda, epi, M, N, K, seed=M + N + K)
    before = q8.engine_gemm_q8.launches
    got = q8.engine_gemm_q8(epi, *args)
    torch.cuda.synchronize()
    assert q8.engine_gemm_q8.launches == before + 1
    assert torch.equal(got, q8.engine_gemm_q8(epi, *args))
    want = q8.engine_gemm_q8_plain(epi, *args)
    assert got.dtype == want.dtype and got.shape == (M, N)
    if epi == "bias_gelu_f32":
        assert _rel(got, want) <= Q8_ENGINE_GELU_TOL, _rel(got, want)
    else:
        assert torch.equal(got, want), _rel(got, want)


@pytest.mark.cuda
def test_q8_engine_raises_and_never_falls_back(cuda):
    """What the s8 engine's TMA and epilogue do not take raises
    ValueError on a CUDA tensor: nothing is launched and the card works
    on."""
    args = _q8_engine_operands(cuda, "bias", 64, 128, 128)
    before = q8.engine_gemm_q8.launches
    w8 = args[2]
    with pytest.raises(ValueError, match="N % 64"):
        q8.engine_gemm_q8("bias", args[0], args[1], w8[:96].contiguous(),
                          args[3][:96], args[4][:96])
    shifted = torch.empty(w8.numel() + 8, dtype=torch.int8, device=cuda)[8:]
    shifted.copy_(w8.reshape(-1))
    with pytest.raises(ValueError, match="16-byte-aligned"):
        q8.engine_gemm_q8("bias", args[0], args[1], shifted.view(w8.shape),
                          *args[3:5])
    with pytest.raises(ValueError, match="torch.int8"):
        q8.engine_gemm_q8("bias", args[0].float(), *args[1:5])
    with pytest.raises(ValueError, match="reads r"):
        q8.engine_gemm_q8("bias_res", *args[:5])
    assert q8.engine_gemm_q8.launches == before
    out = q8.engine_gemm_q8("bias", *args[:5])
    torch.cuda.synchronize()
    assert torch.equal(out, q8.engine_gemm_q8_plain("bias", *args[:5]))


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
def test_q8_kernel_runs_only_the_s8_engine_and_the_tensor_core_core(cuda,
                                                                   gated):
    """A W8A8 pair call's profile holds the quantisers, the s8 engine,
    the tensor-core core (and the gate) once a launch of the chain, beside
    quant_cols's PyTorch operators, and no kernel of the first design."""
    import chip_smoke

    args, H = _inputs(cuda, gated, F=27)
    wrapper, _ = _q8(gated)
    ms, rows = chip_smoke.device_profile(
        lambda: wrapper(*args, H, 0.125, "temporal"), None, calls=2)
    assert ms is not None, rows
    assert not chip_smoke.q8_profile_faults(
        rows, 2, chip_smoke.pair_q8_records(gated), gated), rows


# ---------------------------------------------------------------------------
# the standalone attention and MLP blocks (csrc/block_kernels.cu)
# ---------------------------------------------------------------------------

FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _block_inputs(device, C=512, H=8, F=81, B=1, hidden=None):
    """(x, attention block parameters, MLP block parameters, H)."""
    args, H = _inputs(device, False, C=C, H=H, F=F, B=B, hidden=hidden)
    return args[0], args[1:7], args[7:13], H


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("use_ln,residual", FLAGS)
@pytest.mark.parametrize("C,H", [(512, 8), (256, 8)])  # head dim 64 and 32
def test_attention_block_kernel_matches_plain(cuda, mode, use_ln, residual,
                                              C, H):
    x, ap, _, H = _block_inputs(cuda, C=C, H=H, B=2)
    scale = (C // H) ** -0.5
    before = at.fused_attention_block.launches
    out = at.fused_attention_block(x, *ap, H, scale, mode, use_ln, residual)
    torch.cuda.synchronize()
    assert at.fused_attention_block.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert torch.equal(out, at.fused_attention_block(
        x, *ap, H, scale, mode, use_ln, residual))
    ref = at.attention_block_plain(x, *ap, H, scale, mode, use_ln, residual)
    assert _rel(out, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("use_ln,residual", FLAGS)
@pytest.mark.parametrize("C,H,F", [(512, 8, 81), (256, 8, 243), (512, 8, 5)])
def test_attention_block_bwd_kernel_matches_plain(cuda, mode, use_ln,
                                                  residual, C, H, F):
    x, ap, _, H = _block_inputs(cuda, C=C, H=H, F=F, B=2)
    g = _grad_out(cuda, x.shape)
    scale = (C // H) ** -0.5
    args = (x, g, *ap[:5], H, scale, mode, use_ln, residual)
    before = at.fused_attention_block_bwd.launches
    got = at.fused_attention_block_bwd(*args)
    torch.cuda.synchronize()
    assert at.fused_attention_block_bwd.launches == before + 1
    again = at.fused_attention_block_bwd(*args)
    want = at.attention_block_bwd_plain(*args)
    names = ("dx", "dln_w", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj")
    for name, a, b, w in zip(names, got, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, b), f"{name}: two runs differ"
        if name.startswith("dln") and not use_ln:
            assert not a.any(), name
        else:
            assert _rel(a, w) <= TOL, name


def _misaligned(t):
    """t's values at an address 2 bytes past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out.copy_(t.reshape(-1))
    return out.view(t.shape)


@pytest.mark.cuda
def test_attention_block_raises_on_a_misaligned_input(cuda):
    """Both attention block chains read x (and g) and the weights through
    the engine's TMA loads, which take 16-byte-aligned addresses only: the
    wrappers raise, never fall back and never reach a kernel (a misaligned
    load would end the process's CUDA context), and the card works on."""
    x, ap, _, H = _block_inputs(cuda, F=3)
    g = _grad_out(cuda, x.shape)
    fl = (H, 0.125, "temporal", True, False)
    wqkv = list(ap)
    wqkv[2] = _misaligned(ap[2])
    for call in (lambda: at.fused_attention_block(_misaligned(x), *ap, *fl),
                 lambda: at.fused_attention_block(x, *wqkv, *fl),
                 lambda: at.fused_attention_block_bwd(_misaligned(x), g,
                                                      *ap[:5], *fl),
                 lambda: at.fused_attention_block_bwd(x, _misaligned(g),
                                                      *ap[:5], *fl)):
        with pytest.raises(ValueError, match="16-byte-aligned"):
            call()
    out = at.fused_attention_block(x, *ap, *fl)
    grads = at.fused_attention_block_bwd(x, g, *ap[:5], *fl)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert all(torch.isfinite(t.float()).all() for t in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("use_ln", [False, True])
def test_attention_block_runs_only_the_engine_and_the_tensor_core_core(
        cuda, backward, use_ln):
    """A call's profile holds the GEMM engine and the tensor-core core,
    beside them only the LayerNorm rows, the column sums and the zero
    LayerNorm gradients, with as many records as the chain launches: no
    WMMA GEMM, no CUDA-core attention kernel."""
    import chip_smoke

    x, ap, _, H = _block_inputs(cuda, B=2)
    g = _grad_out(cuda, x.shape)
    fl = (H, 0.125, "temporal", use_ln, False)
    if backward:
        call = lambda: at.fused_attention_block_bwd(x, g, *ap[:5], *fl)
    else:
        call = lambda: at.fused_attention_block(x, *ap, *fl)
    ms, rows = chip_smoke.device_profile(
        call, chip_smoke.block_records("attention", backward, use_ln),
        calls=2)
    assert ms is not None, rows
    assert not chip_smoke.block_profile_faults("attention", backward,
                                               rows), rows


@pytest.mark.cuda
@pytest.mark.parametrize("use_ln,residual", FLAGS)
@pytest.mark.parametrize("C,hidden,shape", [(512, 1024, (2, 81, 17)),
                                            (256, 1024, (1000,)),
                                            (64, 64, (3, 7))])
def test_mlp_block_kernels_match_plain(cuda, use_ln, residual, C, hidden,
                                       shape):
    """Forward and backward, any leading shape (the block is token-wise)."""
    _, _, mp, _ = _block_inputs(cuda, C=C, hidden=hidden, F=1)
    x = _grad_out(cuda, (*shape, C), seed=3)
    g = _grad_out(cuda, x.shape)
    before = (mlp.fused_mlp_block.launches, mlp.fused_mlp_block_bwd.launches)
    out = mlp.fused_mlp_block(x, *mp, use_ln, residual)
    got = mlp.fused_mlp_block_bwd(x, g, *mp[:5], use_ln, residual)
    torch.cuda.synchronize()
    assert (mlp.fused_mlp_block.launches,
            mlp.fused_mlp_block_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert torch.equal(out, mlp.fused_mlp_block(x, *mp, use_ln, residual))
    assert _rel(out, mlp.mlp_block_plain(x, *mp, use_ln, residual)) <= TOL
    again = mlp.fused_mlp_block_bwd(x, g, *mp[:5], use_ln, residual)
    want = mlp.mlp_block_bwd_plain(x, g, *mp[:5], use_ln, residual)
    names = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")
    for name, a, b, w in zip(names, got, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, b), f"{name}: two runs differ"
        if name.startswith("dln") and not use_ln:
            assert not a.any(), name
        else:
            assert _rel(a, w) <= TOL, name


# the GEMM engine alone (csrc/hopper_gemm.cuh) against the fp32 product
# rounded at the same point: fp32 results differ by summation order only;
# a bf16 result by one rounding step either side of a boundary (2**-8 of the
# value), so twice that of max|reference| bounds both
ENGINE_F32_TOL = 1e-4
ENGINE_BF16_TOL = 2 ** -7


def _engine_operands(device, layout, M, N, K, seed=0):
    rs = np.random.RandomState(seed)

    def t(*shape, scale=1.0, dt=torch.bfloat16):
        a = rs.normal(size=shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(device=device, dtype=dt)

    a = t(M, N) if layout == "TN" else t(M, K)
    w = {"NT": lambda: t(N, K, scale=K ** -0.5),
         "NN": lambda: t(K, N, scale=K ** -0.5),
         "TN": lambda: t(M, K, scale=M ** -0.5)}[layout]()
    shape = (N, K) if layout == "TN" else (M, N)
    return a, w, t(shape[1], scale=0.1), t(*shape), t(*shape, dt=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,epi", mlp.ENGINE_CASES)
@pytest.mark.parametrize("M,N,K", [(37, 64, 64), (300, 192, 128),
                                   (1000, 256, 512)])
def test_engine_gemm_matches_the_fp32_product(cuda, layout, epi, M, N, K):
    """Every (layout, epilogue) pair the MLP chains launch, at ragged and
    partial-tile shapes, twice for bitwise repeatability."""
    args = _engine_operands(cuda, layout, M, N, K)
    before = mlp.engine_gemm.launches
    got = mlp.engine_gemm(layout, epi, *args)
    torch.cuda.synchronize()
    assert mlp.engine_gemm.launches == before + 1
    again = mlp.engine_gemm(layout, epi, *args)
    want = mlp.engine_gemm_plain(layout, epi, *args)
    pairs = zip(got, again, want) if epi == "bias_gelu_z" else \
        [(got, again, want)]
    for a, b, w in pairs:
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.equal(a, b), "two runs differ"
        tol = ENGINE_BF16_TOL if a.dtype == torch.bfloat16 else ENGINE_F32_TOL
        assert _rel(a, w) <= tol, (_rel(a, w), tol)


@pytest.mark.cuda
def test_engine_raises_and_never_falls_back(cuda):
    a, w, *_ = _engine_operands(cuda, "NN", 64, 64, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        mlp.engine_gemm("NN", "bf16", a.float(), w)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        mlp.engine_gemm("NN", "bf16", a.reshape(-1)[1:65].reshape(1, 64), w)
    with pytest.raises(ValueError, match="N % 64"):
        mlp.engine_gemm("NN", "bf16", a, w[:, :32].contiguous())
    with pytest.raises(ValueError, match="no NT/dgelu"):
        mlp.engine_gemm("NT", "dgelu", a, w)
    x = torch.zeros(2 * 64 + 1, dtype=torch.bfloat16, device=cuda)[1:]
    _, _, mp, _ = _block_inputs(cuda, C=64, hidden=64, F=1)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        mlp.fused_mlp_block(x.view(2, 64), *mp)


@pytest.mark.cuda
def test_block_functions_backward_through_the_kernels(cuda):
    """autograd through the two Functions launches the backward kernels and
    agrees with the plain backward."""
    x, ap, mp, H = _block_inputs(cuda, B=2)
    g = _grad_out(cuda, x.shape)
    leaves = [t.detach().clone().requires_grad_() for t in (x, *ap)]
    before = at.fused_attention_block_bwd.launches
    out = at.fused_attention_block(*leaves, H, 0.125, "temporal", True, False)
    grads = torch.autograd.grad(out, leaves, g)
    assert at.fused_attention_block_bwd.launches == before + 1
    want = at.attention_block_bwd_plain(x, g, *ap[:5], H, 0.125, "temporal",
                                        True, False)
    for a, w in zip(grads, want):
        assert _rel(a, w) <= TOL
    leaves = [t.detach().clone().requires_grad_() for t in (x, *mp)]
    before = mlp.fused_mlp_block_bwd.launches
    grads = torch.autograd.grad(mlp.fused_mlp_block(*leaves), leaves, g)
    assert mlp.fused_mlp_block_bwd.launches == before + 1
    want = mlp.mlp_block_bwd_plain(x, g, *mp[:5])
    for name, a, w in zip("x ln_w ln_b w1 b1 w2 b2".split(), grads, want):
        if name.startswith("ln"):
            assert not a.any()
        else:
            assert _rel(a, w) <= TOL


@pytest.mark.cuda
def test_blocks_never_fall_back_on_cuda(cuda):
    x, ap, mp, H = _block_inputs(cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        at.fused_attention_block(x.float(), *ap, H, 0.125, "spatial")
    with pytest.raises(ValueError, match="bfloat16"):
        mlp.fused_mlp_block(x.float(), *mp)
    with pytest.raises(ValueError, match="joints"):
        at.fused_attention_block(x[:, :, :16].contiguous(), *ap, H, 0.125,
                                 "spatial")


@pytest.mark.cuda
def test_drop_path_train_steps_depth2_flagship_width(cuda):
    """A depth-2 model at the flagship width built with drop_path_rate=0.2:
    layer 0 stays on the pair path, layer 1 runs the block kernels; the first
    step's gradients against the fp32 plain path drawing the same masks; three
    AdamW steps with the launch counts; evaluation runs pairs only."""
    from motionbert_tpu_torch.losses.pose import pose3d_total_loss
    from motionbert_tpu_torch.train.pose3d import (
        make_train_step, preprocess_batch)
    from motionbert_tpu_torch.train.state import make_adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    lambdas = dict.fromkeys(("lambda_lv", "lambda_lg", "lambda_a",
                             "lambda_av"), 0.0)
    lambdas.update(lambda_scale=0.5, lambda_3d_velocity=20.0)
    cfg = ConfigDict(dim_feat=512, dim_rep=512, depth=2, num_heads=8,
                     mlp_ratio=2, num_joints=17, maxlen=81)
    model = load_backbone(cfg, device=cuda, drop_path_rate=0.2)
    model.init_weights(torch.Generator().manual_seed(0))
    ref = load_backbone(cfg, dtype=torch.float32, device=cuda,
                        attn_impl="plain", drop_path_rate=0.2)
    ref.load_state_dict(model.state_dict())
    rs = np.random.RandomState(2)
    y = torch.from_numpy(rs.uniform(-1, 1, (2, 81, 17, 3)).astype(
        np.float32)).to(cuda)
    x = torch.cat([y[..., :2], torch.ones_like(y[..., :1])], -1)

    counters = (fp.fused_pair_block, fp.fused_gated_pair_block,
                fp.fused_pair_block_bwd, fp.fused_gated_pair_block_bwd,
                at.fused_attention_block, at.fused_attention_block_bwd,
                mlp.fused_mlp_block, mlp.fused_mlp_block_bwd)

    def count(fn):
        before = [c.launches for c in counters]
        out = fn()
        return out, [c.launches - b for c, b in zip(counters, before)]

    grads = []
    for m in (model, ref):
        m.train()
        gen = torch.Generator(device=cuda).manual_seed(5)
        xb, yb, _ = preprocess_batch(x, y, rootrel=True, no_conf=False)
        pose3d_total_loss(m(xb, generator=gen).float(), yb,
                          lambdas)[0].backward()
        grads.append(torch.cat([p.grad.float().flatten()
                                for p in m.parameters()]))
        m.zero_grad(set_to_none=True)
    cos = torch.nn.functional.cosine_similarity(grads[0], grads[1], dim=0)
    assert cos.item() >= 0.999, cos.item()

    opt = make_adamw(model.parameters(), 1e-3, 0.01)
    step = make_train_step(model, opt, lambdas, rootrel=True, no_conf=False,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    losses, launched = count(lambda: [step(x, y)["total"].item()
                                      for _ in range(3)])
    assert launched == [9, 3, 9, 3, 12, 12, 12, 12], launched
    assert np.isfinite(losses).all(), losses

    model.eval()
    with torch.no_grad():
        _, launched = count(lambda: model(x))
    assert launched == [6, 2, 0, 0, 0, 0, 0, 0], launched


# ---------------------------------------------------------------------------
# the attention core alone (B8), the legacy attention modes, ActionNet
# ---------------------------------------------------------------------------

# B8 kernel vs plain as a relative L2: summation order and single bf16 flips
# of P and of the output only (6e-5 when emulated on the CPU at the flagship
# shape); P left in fp32, or the scores rounded to bf16, measure 2.6e-3 to
# 4.8e-3 there, so this bar fails a moved rounding point
ST_L2_TOL = 1e-3


def _qkv(device, C, F, B=2, seed=0):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.normal(size=(B, F, 17, C)).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("C,H", [(512, 8), (256, 8)])  # head dim 64 and 32
@pytest.mark.parametrize("F", [1, 27, 243])
def test_st_attention_kernel_matches_plain(cuda, mode, C, H, F):
    q, k, v = _qkv(cuda, C, F)
    scale = (C // H) ** -0.5
    before = at.st_attention.launches
    out = at.st_attention(q, k, v, mode, H, scale)
    torch.cuda.synchronize()
    assert at.st_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.equal(out, at.st_attention(q, k, v, mode, H, scale))
    ref = at.st_attention_plain(q, k, v, mode, H, scale)
    assert _rel(out, ref) <= TOL
    assert _rel_l2(out, ref) <= ST_L2_TOL
    # the same tokens as slices of one packed projection (row stride 3C)
    packed = torch.cat([q, k, v], -1)
    sliced = at.st_attention(packed[..., :C], packed[..., C:2 * C],
                             packed[..., 2 * C:], mode, H, scale)
    assert torch.equal(sliced, out)


@pytest.mark.cuda
def test_st_attention_raises_and_never_falls_back(cuda):
    q, k, v = _qkv(cuda, 512, 9)
    with pytest.raises(ValueError, match="bfloat16"):
        at.st_attention(q.float(), k, v, "spatial", 8, 0.125)
    with pytest.raises(ValueError, match="row stride"):
        at.st_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                        "temporal", 8, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        at.st_attention(q, k, v, "spatial", 4, 0.125)
    with pytest.raises(ValueError, match="joints"):
        at.st_attention(*(t[:, :, :16] for t in (q, k, v)), "spatial", 8,
                        0.125)


@pytest.mark.cuda
def test_st_attention_raises_on_a_misaligned_input_or_row_stride(cuda):
    """The tensor-core core copies rows with 16-byte cp.async: a q, k or v
    off the 16-byte boundary, or a row stride that is not a multiple of 8,
    raises ValueError on the card and launches nothing (a misaligned copy
    would end the process's CUDA context); the card works on."""
    q, k, v = _qkv(cuda, 512, 9)
    packed = torch.zeros(2, 9, 17, 3 * 512 + 4, dtype=torch.bfloat16,
                         device=cuda)
    before = at.st_attention.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        at.st_attention(packed[..., :512], packed[..., 512:1024],
                        packed[..., 1024:1536], "temporal", 8, 0.125)
    for args in ((_misaligned(q), k, v), (q, k, _misaligned(v))):
        with pytest.raises(ValueError, match="16-byte-aligned"):
            at.st_attention(*args, "spatial", 8, 0.125)
    assert at.st_attention.launches == before
    out = at.st_attention(q, k, v, "spatial", 8, 0.125)
    torch.cuda.synchronize()
    assert _rel(out, at.st_attention_plain(q, k, v, "spatial", 8,
                                           0.125)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_autograd_through_st_attention(cuda, mode):
    """The Function's backward is the plain backward (bf16), and that is
    within the bf16 bar of autograd through the fp32 plain core."""
    q, k, v = _qkv(cuda, 512, 81)
    g = _grad_out(cuda, q.shape)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(at.st_attention(*leaves, mode, 8, 0.125),
                                leaves, g)
    want = at.st_attention_bwd_plain(q, k, v, g, mode, 8, 0.125)
    f32 = [t.float().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(at.st_attention_plain(*f32, mode, 8, 0.125),
                               f32, g.float())
    for a, w, r in zip(grads, want, auto):
        assert a.dtype == torch.bfloat16 and torch.equal(a, w)
        assert _rel(a, r) <= TOL


@pytest.mark.cuda
def test_legacy_modes_launch_counts(cuda):
    """Each legacy mode at C 256 (head dim 32) through the kernels: the
    launches of B8 and of the attention block, forward and backward; the
    output against the fp32 plain module."""
    from motionbert_tpu_torch.models import dstformer as dst

    counters = (at.st_attention, at.fused_attention_block,
                at.fused_attention_block_bwd, mlp.fused_mlp_block,
                mlp.fused_mlp_block_bwd)
    expect = {"vanilla": [1, 0, 0, 0, 0], "series": [2, 0, 0, 0, 0],
              "parallel": [2, 0, 0, 0, 0], "coupling": [0, 0, 0, 0, 0],
              "spatial": [0, 1, 1, 0, 0], "temporal": [0, 1, 1, 0, 0],
              "stage_para": [0, 2, 2, 2, 2]}
    x = _grad_out(cuda, (1, 27, 17, 256), seed=4)
    for mode, want in expect.items():
        torch.manual_seed(0)
        if mode == "stage_para":
            make = lambda impl: dst.Block(256, 8, 2, "stage_para",
                                          attn_impl=impl, att_fuse=True)
        else:
            make = lambda impl: dst.Attention(256, 8, mode, impl)
        model = make("kernel").to(cuda)
        ref = make("plain").to(cuda)
        ref.load_state_dict(model.state_dict())
        before = [c.launches for c in counters]
        leaf = x.detach().clone().requires_grad_()
        out = model(leaf)
        out.float().sum().backward()
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == want, mode
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
        with torch.no_grad():
            assert _rel(out, ref(x.float())) <= TOL, mode


@pytest.mark.cuda
def test_action_step_batchnorm_matches_cpu(cuda):
    """One classification step of a small ActionNet on the fp32 plain path,
    on the card and on the CPU from the same weights and batch: the loss,
    every gradient (fc1's bias: within rounding of 0 on both) and the head's
    BatchNorm statistics agree; the weights
    after the first AdamW step, lr * g / (|g| + eps) + decay, within 1e-6
    wherever |g| >= 1e-5 on both with one sign, and within lr where a
    gradient within rounding of 0 may take either sign."""
    from motionbert_tpu_torch.train.action import (
        build_action_model, make_action_train_step)
    from motionbert_tpu_torch.train.state import make_two_group_adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ConfigDict(dim_feat=64, dim_rep=64, depth=1, num_heads=2,
                     mlp_ratio=2, num_joints=17, maxlen=16, hidden_dim=128,
                     action_classes=6, dropout_ratio=0.0)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.normal(size=(8, 2, 16, 17, 3)).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 6, 8))
    results = []
    for dev in ("cpu", cuda):
        model = build_action_model(cfg, device=dev, attn_impl="plain",
                                   dtype=torch.float32)
        model.init_weights(torch.Generator().manual_seed(0))
        opt = make_two_group_adamw(model, 1e-4, 1e-3, 0.01)
        m = make_action_train_step(model, opt)(x.to(dev), y.to(dev))
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        results.append((m["loss"].item(), grads,
                        {k: v.detach().cpu() for k, v in
                         model.state_dict().items()}))
    (l0, g0, s0), (l1, g1, s1) = results
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    assert sorted(g0) == sorted(g1) and len(g0) > 0
    # the BatchNorm subtracts the batch mean of fc1's output, so fc1's bias
    # gets no gradient but rounding: held against the BatchNorm bias's
    vanishing = "head.fc1.bias"
    for g in (g0, g1):
        assert (torch.linalg.norm(g[vanishing])
                <= 1e-3 * torch.linalg.norm(g0["head.bn.bias"]))
    for k in g0:
        if k == vanishing:
            continue
        scale = g0[k].abs().max().item()
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-3,
                                   atol=1e-3 * scale + 1e-12, err_msg=k)
    assert s0["head.bn.num_batches_tracked"].item() == 1
    assert s1["head.bn.num_batches_tracked"].item() == 1
    for k in ("head.bn.running_mean", "head.bn.running_var"):
        np.testing.assert_allclose(s1[k].numpy(), s0[k].numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=k)
    for k in g0:
        lr = 1e-4 if k.startswith("backbone.") else 1e-3
        d = (s1[k].float() - s0[k].float()).abs()
        sure = (g0[k].abs() >= 1e-5) & (g0[k].sign() == g1[k].sign())
        if sure.any():
            assert d[sure].max().item() <= 1e-6, k
        assert d.max().item() <= 2.1 * lr, k


# ---------------------------------------------------------------------------
# the stream kernel (B10)
# ---------------------------------------------------------------------------

def _stream_args(device, gated, F=81, B=1):
    """x, [other,] pass 1's 12 parameters, pass 2's 12, [wg, bg]: two pairs
    of _inputs with different seeds."""
    a1, H = _inputs(device, gated, F=F, B=B)
    rs = np.random.RandomState(1)
    p2 = [(t + torch.from_numpy(rs.normal(size=t.shape).astype(np.float32))
           .to(device=device, dtype=t.dtype) * 0.05) for t in
          a1[1 + gated:13 + gated]]
    args = a1[:13 + gated] + p2 + (a1[13 + gated:] if gated else [])
    return args, H


def _stream_fns(gated, q8_tier):
    from motionbert_tpu_torch.ops import fused_stream as fs

    if q8_tier:
        return ((fs.fused_gated_stream_block_q8 if gated
                 else fs.fused_stream_block_q8),
                (fs.gated_stream_block_q8_plain if gated
                 else fs.stream_block_q8_plain),
                q8.fused_pair_block_q8, q8.fused_gated_pair_block_q8)
    return ((fs.fused_gated_stream_block if gated else fs.fused_stream_block),
            (fs.gated_stream_block_plain if gated else fs.stream_block_plain),
            fp.fused_pair_block, fp.fused_gated_pair_block)


def _pair_chain(pair_fn, gated_fn, args, gated, H, scale, order):
    modes = ["spatial" if a == "s" else "temporal" for a in order]
    x = args[0]
    p1 = args[1 + gated:13 + gated]
    p2 = args[13 + gated:25 + gated]
    mid = pair_fn(x, *p1, H, scale, modes[0])
    if not gated:
        return pair_fn(mid, *p2, H, scale, modes[1])
    return gated_fn(mid, args[1], *p2, *args[25 + gated:], H, scale, modes[1])


@pytest.mark.cuda
@pytest.mark.parametrize("q8_tier", [False, True])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("order", [("s", "t"), ("t", "s")])
def test_stream_kernel_matches_plain_and_the_pair_chain(cuda, order, gated,
                                                        q8_tier):
    """Against the plain stream at the pair kernels' bars, and bit for bit
    against the ported pair chain B1 -> B1 / B2 (B9 -> B9): the same
    launches on the same operands."""
    args, H = _stream_args(cuda, gated)
    scale = 0.125
    wrapper, plain, pair_fn, gated_fn = _stream_fns(gated, q8_tier)
    before = wrapper.launches
    out = wrapper(*args, H, scale, order)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    ref = plain(*args, H, scale, order)
    # two chained pairs: pass 1's rounding flips travel through pass 2, so
    # the bars are twice a pair's (measured up to 2.1e-2 and 5.6e-3 here);
    # the equality with the pair chain below holds the rounding points
    assert _rel(out, ref) <= 2 * (Q8_TOL if q8_tier else TOL)
    assert _rel_l2(out, ref) <= 2 * Q8_L2_TOL
    assert torch.equal(out, _pair_chain(pair_fn, gated_fn, args, gated, H,
                                        scale, order))
    assert torch.equal(out, wrapper(*args, H, scale, order))


@pytest.mark.cuda
def test_stream_kernel_ragged_rows_single_frame_and_full_clip(cuda):
    from motionbert_tpu_torch.ops import fused_stream as fs

    for F in (1, 5, 243):
        args, H = _stream_args(cuda, True, F=F, B=2)
        out = fs.fused_gated_stream_block(*args, H, 0.125, ("t", "s"))
        assert _rel(out, fs.gated_stream_block_plain(
            *args, H, 0.125, ("t", "s"))) <= TOL


@pytest.mark.cuda
def test_stream_never_falls_back_on_cuda(cuda):
    from motionbert_tpu_torch.ops import fused_stream as fs

    args, H = _stream_args(cuda, False)
    args[0] = args[0].float()
    with pytest.raises(ValueError, match="bfloat16"):
        fs.fused_stream_block(*args, H, 0.125, ("s", "t"))
    args, H = _stream_args(cuda, False, F=244)
    with pytest.raises(ValueError, match="frames"):
        fs.fused_stream_block_q8(*args, H, 0.125, ("s", "t"))


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
def test_stream_backward_is_the_pair_path_bitwise(cuda, gated):
    """The stream's gradients (pass 1 recomputed with B1, then B3 twice)
    equal the pair path's through the pair Functions, bit for bit; the W8A8
    stream's equal the bf16 stream's (straight-through)."""
    from motionbert_tpu_torch.ops import fused_stream as fs

    base, H = _stream_args(cuda, gated)
    g = torch.from_numpy(np.random.RandomState(9).normal(
        size=base[0].shape).astype(np.float32)).to(cuda, torch.bfloat16)
    order = ("t", "s") if gated else ("s", "t")
    counter = (fs.fused_gated_stream_block_bwd if gated
               else fs.fused_stream_block_bwd)
    before = counter.launches
    grads = []
    for fn in ("stream", "pairs", "stream_q8"):
        args = [a.clone().requires_grad_() for a in base]
        if fn == "pairs":
            out = _pair_chain(fp.fused_pair_block, fp.fused_gated_pair_block,
                              args, gated, H, 0.125, order)
        else:
            out = _stream_fns(gated, fn == "stream_q8")[0](*args, H, 0.125,
                                                           order)
        grads.append(torch.autograd.grad(out, args, g))
    for a, b, c in zip(*grads):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert counter.launches == before + 2


@pytest.mark.cuda
def test_model_stream_launches_and_equals_the_pair_path(cuda):
    """Under kernel_stream a depth-2 forward launches 2 + 2 stream kernels
    and no pair kernel, and its output is the pair path's, bit for bit."""
    from motionbert_tpu_torch.ops import fused_stream as fs

    cfg = ConfigDict(dim_feat=512, dim_rep=512, depth=2, num_heads=8,
                     mlp_ratio=2, num_joints=17, maxlen=81)
    model = load_backbone(cfg, device=cuda, attn_impl="kernel_stream")
    model.init_weights(torch.Generator().manual_seed(0))
    pairs = load_backbone(cfg, device=cuda)
    pairs.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (2, 81, 17, 3)).astype(np.float32)).to(cuda)
    counters = (fs.fused_stream_block, fs.fused_gated_stream_block,
                fp.fused_pair_block, fp.fused_gated_pair_block)
    for c in counters:
        c.launches = 0
    with torch.inference_mode():
        out = model(x, return_rep=True)
        launches = [c.launches for c in counters]
        assert torch.equal(out, pairs(x, return_rep=True))
    assert launches == [2, 2, 0, 0]


# ---------------------------------------------------------------------------
# the mesh task
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_smpl_and_rotations_on_the_card_match_the_cpu(cuda):
    """SMPL at the real vertex count (a seeded 6890-vertex model) and the
    rotation conversions, fp32 on both: summation order only, 1e-5 of the
    largest value; axis-angle from matrices within 1e-4 (the goldens' bar)
    with angles near pi, where fp32 may take the other Shepperd branch."""
    from motionbert_tpu_torch.geometry import rotations as rot
    from motionbert_tpu_torch.models.smpl import SMPLModel, smpl_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    model = SMPLModel.synthetic(num_verts=6890, seed=0)
    rs = np.random.RandomState(0)
    betas = torch.from_numpy(rs.normal(size=(64, 10)).astype(np.float32))
    pose = torch.from_numpy(rs.normal(0, 0.5, (64, 72)).astype(np.float32))
    cpu = smpl_forward(model, betas, pose)
    card = smpl_forward(model.to(cuda), betas.to(cuda), pose.to(cuda))
    for k in ("vertices", "joints", "rotmats"):
        assert _rel(card[k].cpu(), cpu[k]) <= 1e-5, k
    aa = rs.normal(size=(256, 3))
    aa /= np.linalg.norm(aa, axis=-1, keepdims=True)
    aa *= np.concatenate([rs.uniform(0, np.pi, 248),
                          np.pi - np.logspace(-7, -1, 8)])[:, None]
    aa = torch.from_numpy(aa.astype(np.float32))
    R = rot.batch_rodrigues(aa)
    assert _rel(rot.batch_rodrigues(aa.to(cuda)).cpu(), R) <= 1e-5
    six = torch.from_numpy(rs.normal(size=(64, 6)).astype(np.float32))
    assert _rel(rot.rot6d_to_rotmat(six.to(cuda)).cpu(),
                rot.rot6d_to_rotmat(six)) <= 1e-5
    back = rot.rotmat_to_angle_axis(R.to(cuda)).cpu()
    want = rot.rotmat_to_angle_axis(R)
    # an axis-angle of pi and its negation are one rotation
    same = torch.minimum((back - want).abs().amax(-1),
                         (back + want).abs().amax(-1))
    assert same.max().item() <= 1e-4


@pytest.mark.cuda
def test_mesh_step_matches_cpu(cuda):
    """One mesh training step of a small MeshRegressor on the fp32 plain
    path, on the card and on the CPU from the same weights and batch: the
    loss terms, every gradient (fc1's and fc2's biases: within rounding of
    0, held against their BatchNorm's) and the BatchNorm statistics."""
    from motionbert_tpu_torch.models.smpl import SMPLModel
    from motionbert_tpu_torch.train.mesh import (
        build_mesh_model, make_mesh_train_step)
    from motionbert_tpu_torch.train.state import make_two_group_adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ConfigDict(dim_feat=64, dim_rep=64, depth=1, num_heads=2,
                     mlp_ratio=2, num_joints=17, maxlen=16, hidden_dim=128,
                     dropout=0.0)
    lambdas = dict(lambda_3d=0.5, lambda_scale=0, lambda_3dv=10, lambda_lv=0,
                   lambda_lg=0, lambda_a=0, lambda_av=0, lambda_pose=1000,
                   lambda_shape=1, lambda_norm=20)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.uniform(-1, 1, (8, 16, 17, 3)).astype(np.float32))
    gt = {"theta": torch.from_numpy(rs.normal(0, 0.3, (8, 16, 82)).astype(
              np.float32)),
          "kp_3d": torch.from_numpy(rs.normal(0, 100, (8, 16, 17, 3)).astype(
              np.float32)),
          "verts": torch.from_numpy(rs.normal(0, 100, (8, 16, 256, 3)).astype(
              np.float32))}
    results = []
    for dev in ("cpu", cuda):
        model = build_mesh_model(cfg, SMPLModel.synthetic(num_verts=256),
                                 device=dev, attn_impl="plain",
                                 dtype=torch.float32)
        model.init_weights(torch.Generator().manual_seed(0))
        opt = make_two_group_adamw(model, 1e-4, 1e-3, 0.01)
        terms = make_mesh_train_step(model, opt, lambdas)(
            x.to(dev), {k: v.to(dev) for k, v in gt.items()})
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        results.append(({k: v.item() for k, v in terms.items()}, grads,
                        {k: v.detach().cpu() for k, v in
                         model.state_dict().items()}))
    (t0, g0, s0), (t1, g1, s1) = results
    for k in t0:
        assert abs(t0[k] - t1[k]) <= 1e-4 * abs(t0[k]) + 1e-6, k
    assert sorted(g0) == sorted(g1) and len(g0) > 0
    vanishing = {"head.fc1.bias": "head.bn1.bias",
                 "head.fc2.bias": "head.bn2.bias"}
    for k in g0:
        if k in vanishing:
            ref = torch.linalg.norm(g0[vanishing[k]])
            assert torch.linalg.norm(g1[k] - g0[k]) <= 1e-3 * ref, k
            continue
        scale = g0[k].abs().max().item()
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-3,
                                   atol=1e-3 * scale + 1e-12, err_msg=k)
    for bn in ("bn1", "bn2"):
        for buf in ("running_mean", "running_var"):
            k = f"head.{bn}.{buf}"
            np.testing.assert_allclose(s1[k].numpy(), s0[k].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the pair backward (B3) on tensor cores: its attention core alone, and its
# products on the GEMM engine at the flagship shapes
# ---------------------------------------------------------------------------

# the tensor-core core vs the plain core as a relative L2: the forward is
# B8's function and takes B8's bar (a moved rounding point measures 2.6e-3
# or more); the backward rounds dS and its three gradients to bf16, and
# takes the block kernels' bar (BLOCK_L2_TOL in chip_smoke.py)
CORE_L2_TOL = 1e-3
CORE_BWD_L2_TOL = 4e-3


def _core_inputs(device, mode, n, C, seed=0):
    """q, k, v and the output gradient with groups of n rows: n frames of 5
    joints (temporal), or 7 frames of n joints (spatial)."""
    shape = (2, n, 5, C) if mode == "temporal" else (2, 7, n, C)
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.normal(size=shape).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("H", [8, 16])          # head dim 64 and 32 at C 512
@pytest.mark.parametrize("n", [1, 5, 16, 17, 100, 243])
def test_attention_core_matches_the_plain_core(cuda, mode, H, n):
    """The tensor-core core, forward and backward, against the plain core at
    every key-tile count (1, 2, 8 and 16 tiles; ragged and exact), twice for
    bitwise repeatability, one launch each."""
    q, k, v, g = _core_inputs(cuda, mode, n, 512)
    scale = (512 // H) ** -0.5
    before = (fp.attention_core.launches, fp.attention_core_bwd.launches)
    out = fp.attention_core(q, k, v, mode, H, scale)
    grads = fp.attention_core_bwd(q, k, v, g, mode, H, scale)
    torch.cuda.synchronize()
    assert (fp.attention_core.launches,
            fp.attention_core_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out, fp.attention_core(q, k, v, mode, H, scale))
    for a, b in zip(grads, fp.attention_core_bwd(q, k, v, g, mode, H, scale)):
        assert torch.equal(a, b), "two runs differ"
    ref = at.st_attention_plain(q, k, v, mode, H, scale)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _rel(out, ref) <= TOL and _rel_l2(out, ref) <= CORE_L2_TOL
    want = at.st_attention_bwd_plain(q, k, v, g, mode, H, scale)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a.float()).all(), name
        if not b.float().abs().max():       # one key: dS, dq and dk are 0
            assert not a.float().abs().max(), name
            continue
        assert _rel(a, b) <= TOL, (name, _rel(a, b))
        assert _rel_l2(a, b) <= CORE_BWD_L2_TOL, (name, _rel_l2(a, b))


@pytest.mark.cuda
def test_attention_core_raises_and_never_falls_back(cuda):
    q, k, v, g = _core_inputs(cuda, "temporal", 9, 512)
    with pytest.raises(ValueError, match="bfloat16"):
        fp.attention_core(q.float(), k, v, "temporal", 8, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        fp.attention_core_bwd(q, k, v, g, "temporal", 4, 0.125)
    big = torch.zeros((1, 257, 1, 512), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="groups of 1..256"):
        fp.attention_core(big, big, big, "temporal", 8, 0.125)


# (layout, epilogue, M, N, K) of every product the pair backward launches at
# the flagship shape (4, 243, 17) token rows, C 512, hidden 1024
B3_PRODUCTS = [("NT", "bias", 16524, 1536, 512),      # qkv
               ("NT", "bias_res", 16524, 512, 512),   # proj + x
               ("NT", "bias_gelu_z", 16524, 1024, 512),  # fc1 with fp32 z
               ("NT", "bias_res", 16524, 512, 1024),  # gated: fc2 + yb
               ("NN", "dgelu", 16524, 1024, 512),     # dz
               ("NN", "f32", 16524, 512, 1024),       # dh2
               ("NN", "bf16", 16524, 512, 512),       # dattn
               ("NN", "f32", 16524, 512, 1536),       # dh1
               ("TN", "partial", 16524, 512, 1024),   # dW2
               ("TN", "partial", 16524, 1024, 512),   # dW1
               ("TN", "partial", 16524, 512, 512),    # dWproj
               ("TN", "partial", 16524, 1536, 512)]   # dWqkv


@pytest.mark.cuda
@pytest.mark.parametrize("layout,epi,M,N,K", B3_PRODUCTS)
def test_pair_bwd_products_match_the_fp32_product(cuda, layout, epi, M, N,
                                                  K):
    """The engine launches of the pair backward, at their flagship shapes,
    against the fp32 product rounded at the same point, bitwise twice."""
    args = _engine_operands(cuda, layout, M, N, K, seed=M + N + K)
    got = mlp.engine_gemm(layout, epi, *args)
    again = mlp.engine_gemm(layout, epi, *args)
    want = mlp.engine_gemm_plain(layout, epi, *args)
    pairs = zip(got, again, want) if epi == "bias_gelu_z" else \
        [(got, again, want)]
    for a, b, w in pairs:
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.equal(a, b), "two runs differ"
        tol = ENGINE_BF16_TOL if a.dtype == torch.bfloat16 else ENGINE_F32_TOL
        assert _rel(a, w) <= tol, (_rel(a, w), tol)


@pytest.mark.cuda
def test_bwd_raises_on_a_misaligned_input(cuda):
    """The pair backward's products read x, g and the weights through TMA,
    which takes 16-byte-aligned addresses only: it raises, never falls
    back."""
    args, H = _inputs(cuda, False, F=3)
    g = _grad_out(cuda, args[0].shape)
    shifted = torch.empty(g.numel() + 1, dtype=g.dtype, device=cuda)[1:]
    shifted.copy_(g.reshape(-1))
    bargs = _bwd_args(args, shifted.view(g.shape), False)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fp.fused_pair_block_bwd(*bargs, H, 0.125, "temporal")


@pytest.mark.cuda
def test_device_prefetch_moves_batches_to_the_card(cuda):
    """Pinned host memory, a side stream, the consumer waiting: the batches
    arrive on the card equal and in order, while the consumer writes to the
    ones it already holds."""
    from motionbert_tpu_torch.data.datasets import device_prefetch

    rs = np.random.RandomState(3)
    batches = [(rs.normal(size=(64, 243, 17, 3)).astype(np.float32),
                {"y": rs.normal(size=(64, 17)).astype(np.float32)})
               for _ in range(6)]
    got = []
    for x, y in device_prefetch(iter(batches), cuda, size=2):
        assert x.device.type == "cuda" and y["y"].device.type == "cuda"
        got.append((x.clone(), y["y"].clone()))
        x.mul_(0)   # the consumer's own work on the batch it was given
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for (x, y), (gx, gy) in zip(batches, got):
        np.testing.assert_array_equal(gx.cpu().numpy(), x)
        np.testing.assert_array_equal(gy.cpu().numpy(), y["y"])
