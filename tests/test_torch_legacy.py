"""The port's attention core alone (B8), the legacy attention modes and the
stage_para block, against the JAX package on the CPU.

Inputs come from numpy seeds and go to both packages. The JAX ops run their
Pallas kernels interpreted (they do so themselves off the TPU; C = 128, the
smallest width at which the JAX package takes them). Tolerances:
- the reference goldens: 2e-5, the JAX package's own bar for them;
- fp32 forward 3e-5, backward 1e-4 (absolute and relative): summation order
  only;
- bf16: 2e-2 of max|reference| per tensor: single bf16 rounding flips of P,
  dS and the outputs (the JAX backward also rounds the scores and dP to
  bf16 where the port keeps them in fp32);
- whole modules in fp32: 1e-4 for the output and 2e-4 for the gradients, as
  the model tests allow for two stacked sub-blocks; the stage_para block's
  MLP gets its erf from a polynomial in the interpreted TPU kernel
  (|error| <= 1.5e-7), which these bars cover.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionbert_tpu.models.dstformer import Attention as JAttention
from motionbert_tpu.models.dstformer import Block as JBlock
from motionbert_tpu.ops.attention import _attention_fused
from motionbert_tpu_torch.models import dstformer as dst
from motionbert_tpu_torch.models.convert import (
    jax_from_state_dict, state_dict_from_jax)
from motionbert_tpu_torch.ops import attention as at

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
MODES = ["spatial", "temporal", "vanilla", "coupling", "series", "parallel"]
B, F, J, C, H = 1, 10, 17, 128, 4
SCALE = (C // H) ** -0.5


def _np(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDENS, "legacy_attention.npz"))


def _golden_case(g, name):
    x = g["x"]                          # (B*F, J, C), the reference layout
    frames = int(g["F"])
    bf, j, c = x.shape
    sd = {k.split(":sd:")[1]: torch.from_numpy(g[k]) for k in g.files
          if k.startswith(f"{name}:sd:")}
    return torch.from_numpy(x.reshape(bf // frames, frames, j, c)), sd, c


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
@pytest.mark.parametrize("mode", MODES)
def test_legacy_mode_matches_golden(golden, mode, attn_impl):
    x, sd, c = _golden_case(golden, mode)
    attn = dst.Attention(c, num_heads=4, mode=mode, attn_impl=attn_impl)
    attn.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = attn(x)
    np.testing.assert_allclose(out.numpy().reshape(golden[f"{mode}:out"].shape),
                               golden[f"{mode}:out"], atol=2e-5)


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_stage_para_block_matches_golden(golden, attn_impl):
    x, sd, c = _golden_case(golden, "stage_para")
    blk = dst.Block(c, num_heads=4, mlp_ratio=2, st_mode="stage_para",
                    attn_impl=attn_impl, att_fuse=True)
    blk.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = blk(x)
    np.testing.assert_allclose(
        out.numpy().reshape(golden["stage_para:out"].shape),
        golden["stage_para:out"], atol=2e-5)


def test_parallel_gate_interleaves_the_channels():
    """ts_attn's 2C outputs read as (C, 2): output 2c weighs x_s and 2c + 1
    weighs x_t, not two halves."""
    rs = np.random.RandomState(0)
    x_s, x_t = (torch.from_numpy(rs.normal(size=(1, 2, 3, 4)).astype(
        np.float32)) for _ in range(2))
    logits = torch.zeros(1, 2, 3, 8)
    logits[..., 0::2] = 30.0            # even outputs: all weight on x_s
    np.testing.assert_allclose(dst._gate_mix(x_s, x_t, logits).numpy(),
                               x_s.numpy(), atol=1e-6)
    logits[..., 0::2], logits[..., 1::2] = 0.0, 30.0
    np.testing.assert_allclose(dst._gate_mix(x_s, x_t, logits).numpy(),
                               x_t.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# B8 against the interpreted Pallas kernel and its VJP
# ---------------------------------------------------------------------------

def _core_arrays():
    return [_np((B, F, J, C), s) for s in (0, 1, 2)], _np((B, F, J, C), 3)


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_st_attention_matches_pallas(mode, dtype):
    (q, k, v), g = _core_arrays()
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else \
        (jnp.float32, torch.float32)
    jout, vjp = jax.vjp(lambda *a: _attention_fused(*a, H, SCALE, mode),
                        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(g, jdt))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = at.st_attention(*leaves, mode, H, SCALE)
    assert out.dtype == tdt and out.shape == (B, F, J, C)
    assert torch.equal(out, at.st_attention_plain(*leaves, mode, H, SCALE))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(tdt))
    pairs = [(out, jout)] + list(zip(grads, jgrads))
    for i, (a, b) in enumerate(pairs):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        if dtype == "bf16":
            assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), i
        else:
            tol = 3e-5 if i == 0 else 1e-4
            np.testing.assert_allclose(a, b, atol=tol, rtol=tol,
                                       err_msg=str(i))


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_st_attention_backward_is_autograd_of_the_plain_core(mode):
    """In fp64 the hand-written backward is the derivative of the plain
    core (gradcheck, tiny on purpose), and in fp32 it equals autograd
    through the plain core."""
    rs = np.random.RandomState(4)
    args = [torch.from_numpy(rs.normal(size=(1, 3, 4, 4))).requires_grad_()
            for _ in range(3)]
    assert torch.autograd.gradcheck(
        lambda *a: at.st_attention(*a, mode, 2, 0.5), args, eps=1e-6,
        atol=1e-6)
    (q, k, v), g = _core_arrays()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(at.st_attention(*leaves, mode, H, SCALE),
                              leaves, torch.from_numpy(g))
    auto = torch.autograd.grad(at.st_attention_plain(*leaves, mode, H, SCALE),
                               leaves, torch.from_numpy(g))
    for a, b in zip(got, auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def test_st_attention_checks_what_the_kernel_takes():
    """What the CUDA core does not take raises ValueError (checked on CPU
    tensors through the checker the launch path calls first); slices of a
    packed projection pass with their row stride."""
    q, k, v = (torch.zeros(2, 5, 17, 128, dtype=torch.bfloat16)
               for _ in range(3))
    assert at.check_st_attention_args(q, k, v, 4, "spatial") == 128
    packed = torch.zeros(2, 5, 17, 384, dtype=torch.bfloat16)
    assert at.check_st_attention_args(packed[..., :128], packed[..., 128:256],
                                      packed[..., 256:], 4, "temporal") == 384
    with pytest.raises(ValueError, match="row stride"):
        at.check_st_attention_args(q, packed[..., :128], v, 4, "spatial")
    with pytest.raises(ValueError, match="bfloat16"):
        at.check_st_attention_args(q, k.float(), v, 4, "spatial")
    with pytest.raises(ValueError, match="joints"):
        at.check_st_attention_args(*(t[:, :, :16] for t in (q, k, v)), 4,
                                   "spatial")
    with pytest.raises(ValueError, match="head dim"):
        at.check_st_attention_args(q, k, v, 8, "spatial")
    with pytest.raises(ValueError, match="mode"):
        at.check_st_attention_args(q, k, v, 4, "vanilla")
    with pytest.raises(ValueError, match="no attention core kernel"):
        at.st_attention(*(t.to("meta") for t in (q, k, v)), "spatial", 4,
                        0.25)


@pytest.mark.parametrize("case", ["ld", "base", "rows"])
def test_st_attention_checks_what_the_tensor_core_core_reads(case):
    """The kernel is the tensor-core core, which copies rows with 16-byte
    cp.async and numbers its (group, head) items with 32-bit ints: a row
    stride that is not a multiple of 8, a base off the 16-byte boundary, or
    more token rows than ``core_max_rows`` raise ValueError before any
    launch; an aligned packed slice passes."""
    if case == "ld":        # row stride 396: 792 bytes, not whole chunks
        packed = torch.zeros(2, 5, 17, 396, dtype=torch.bfloat16)
        q, k, v = (packed[..., i * 132:i * 132 + 128] for i in range(3))
        match = "multiple of 8"
    elif case == "base":    # the slices start 8 bytes past a boundary
        packed = torch.zeros(2, 5, 17, 392, dtype=torch.bfloat16)
        q, k, v = (packed[..., 4 + i * 128:4 + (i + 1) * 128]
                   for i in range(3))
        assert at.check_st_attention_args(
            *(packed[..., 8 + i * 128:8 + (i + 1) * 128] for i in range(3)),
            4, "spatial") == 392
        match = "16-byte-aligned"
    else:                   # one clip past the core's item count at 4 heads
        limit = at.core_max_rows(4)
        assert limit == (2 ** 31 - 1) // 4
        q = k = v = torch.zeros(1, 1, 17, 128, dtype=torch.bfloat16).expand(
            limit // 17 + 1, 1, 17, 128)
        match = "token rows"
    with pytest.raises(ValueError, match=match):
        at.check_st_attention_args(q, k, v, 4, "spatial")


def test_coupled_attention_is_attention_over_every_token():
    """coupling == spatial attention over one frame holding all F*J tokens."""
    (q, k, v), _ = _core_arrays()
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    want = at.st_attention_plain(*(t.reshape(B, 1, F * J, C)
                                   for t in (q, k, v)), "spatial", H, SCALE)
    np.testing.assert_allclose(
        at.coupled_attention(q, k, v, H, SCALE).numpy(),
        want.reshape(B, F, J, C).numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the modules against the JAX modules on their Pallas paths
# ---------------------------------------------------------------------------

def _jax_module(kind):
    if kind == "stage_para":
        return JBlock(dim=C, num_heads=H, mlp_ratio=2, st_mode="stage_para",
                      att_fuse=True, attn_impl="pallas")
    return JAttention(dim=C, num_heads=H, mode=kind, attn_impl="pallas")


def _port_module(kind, attn_impl):
    if kind == "stage_para":
        return dst.Block(C, H, 2, "stage_para", attn_impl=attn_impl,
                         att_fuse=True)
    return dst.Attention(C, num_heads=H, mode=kind, attn_impl=attn_impl)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(val)
    return out


@pytest.mark.parametrize("kind", ["vanilla", "series", "parallel",
                                  "stage_para"])
def test_module_matches_the_jax_pallas_path(kind):
    x, g = _np((B, F, J, C), 5), _np((B, F, J, C), 6)
    jmod = _jax_module(kind)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    # random biases and gate weights, so that every parameter counts
    rs = np.random.RandomState(7)
    params = jax.tree_util.tree_map(
        lambda a: (a + rs.normal(size=a.shape) * 0.05).astype(np.float32),
        params)
    out, vjp = jax.vjp(lambda p, xx: jmod.apply({"params": p}, xx), params,
                       jnp.asarray(x))
    jgrad_p, jgrad_x = vjp(jnp.asarray(g))
    jgrads = _flat(jgrad_p)
    model = _port_module(kind, "kernel")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = model(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-4, rtol=1e-4)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad_x),
                               atol=2e-4, rtol=2e-4)
    grads = _flat(jax_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()}))
    assert grads.keys() == jgrads.keys()
    for key in jgrads:
        np.testing.assert_allclose(grads[key], jgrads[key], atol=2e-4,
                                   rtol=2e-4, err_msg=key)


@pytest.mark.parametrize("kind", ["vanilla", "series", "parallel",
                                  "stage_para"])
def test_module_bf16_kernel_path_matches_fp32(kind):
    """The bf16 path (what the card runs, plain versions here) within the
    bf16 bar of the fp32 plain module."""
    torch.manual_seed(0)
    model = _port_module(kind, "kernel")
    ref = _port_module(kind, "plain")
    ref.load_state_dict(model.state_dict())
    x = torch.from_numpy(_np((B, F, J, C), 8))
    with torch.no_grad():
        got, want = model(x.bfloat16()), ref(x)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max() <= 2e-2 * want.abs().max()


def test_attention_modes_and_parameters():
    """ts_attn exists in parallel mode only; an unknown mode raises; the
    stage_para block without att_fuse averages its two branches."""
    for mode in MODES:
        names = set(dst.Attention(32, 4, mode).state_dict())
        assert ("ts_attn.weight" in names) == (mode == "parallel"), mode
    with pytest.raises(NotImplementedError):
        dst.Attention(32, 4, "diagonal")
    blk = dst.Block(32, 4, 2, "stage_para")
    assert not any(k.startswith("ts_attn") for k in blk.state_dict())
    x = torch.from_numpy(_np((1, 4, 17, 32), 9))
    with torch.no_grad():
        out = blk(x)
        fused = dst.Block(32, 4, 2, "stage_para", att_fuse=True)
        fused.load_state_dict(blk.state_dict(), strict=False)
        torch.nn.init.zeros_(fused.ts_attn.weight)
        torch.nn.init.zeros_(fused.ts_attn.bias)
        # equal gate logits: the gate is the average too
        np.testing.assert_allclose(fused(x).numpy(), out.numpy(), atol=1e-6)
