"""The port's standalone attention and MLP blocks, DropPath and dropout, and
the model's dropout / drop-path path, against the JAX package on the CPU.

Inputs come from numpy seeds and go to both packages. The JAX ops run their
Pallas kernels interpreted (they do so themselves off the TPU) and are also
held against their XLA references. Tolerances:
- fp32 forward 3e-5, backward 1e-4 (absolute and relative): summation order
  only. For the MLP the interpreted TPU kernel takes erf from a polynomial
  (|error| <= 1.5e-7) where the port uses the exact erf: 1e-5, as the JAX
  package's own test of that kernel against XLA allows.
- bf16: 2e-2 of max|reference| per tensor: single bf16 rounding flips of
  qkv, attn, the hidden activation and the rounded gradients.
- the model in fp32 against the JAX model: 1e-4 for the output, 2e-4 for the
  gradients (two layers of the above).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionbert_tpu.models.dstformer import DSTformer as JDSTformer
from motionbert_tpu.ops.attention import (
    _fused_block_xla, fused_attention_block as j_attention_block)
from motionbert_tpu.ops.fused_mlp import (
    _fused_mlp_xla, fused_mlp_block as j_mlp_block)
from motionbert_tpu_torch.models import dstformer as dst
from motionbert_tpu_torch.models.convert import (
    jax_from_state_dict, state_dict_from_jax)
from motionbert_tpu_torch.models.factory import load_backbone
from motionbert_tpu_torch.core.config import ConfigDict
from motionbert_tpu_torch.ops import attention as at
from motionbert_tpu_torch.ops import fused_mlp as mlp

B, F, J, C, H, HID = 2, 10, 17, 64, 4, 128
SCALE = (C // H) ** -0.5
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
ATTN_GRADS = ("dx", "dln_w", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj")
MLP_GRADS = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")


def _np(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def _attn_arrays():
    """(x, ln_w, ln_b, wqkv (C, 3C), bqkv, wproj (C, C), bproj), the JAX
    op's layout."""
    return (_np((B, F, J, C), 0), _np((C,), 1, 0.1, 1.0), _np((C,), 2, 0.1),
            _np((C, 3 * C), 3, C ** -0.5), _np((3 * C,), 4, 0.1),
            _np((C, C), 5, C ** -0.5), _np((C,), 6, 0.1))


def _mlp_arrays():
    return (_np((B, F, J, C), 0), _np((C,), 1, 0.1, 1.0), _np((C,), 2, 0.1),
            _np((C, HID), 7, C ** -0.5), _np((HID,), 8, 0.1),
            _np((HID, C), 9, HID ** -0.5), _np((C,), 10, 0.1))


def _to_jax(arrays, dtype):
    """Activations, weights and biases in ``dtype``; LayerNorm stays fp32."""
    return tuple(jnp.asarray(a, jnp.float32 if i in (1, 2) else dtype)
                 for i, a in enumerate(arrays))


def _to_torch(arrays, dtype):
    """The same arrays for the port: weights transposed to nn.Linear's
    (out, in) layout."""
    out = []
    for i, a in enumerate(arrays):
        t = torch.from_numpy(a.T.copy() if i in (3, 5) else a)
        out.append(t if i in (1, 2) else t.to(dtype))
    return tuple(out)


def _as_jax_layout(grads):
    """The port's gradients as float32 arrays in the JAX op's layout."""
    return [g.float().numpy().T if i in (3, 5) else g.float().numpy()
            for i, g in enumerate(grads)]


def _close(got, want, tol, rel_to_max, err_msg):
    want = np.asarray(want, np.float32)
    if rel_to_max:
        assert np.abs(got - want).max() <= tol * max(np.abs(want).max(),
                                                     1e-30), err_msg
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                                   err_msg=err_msg)


def _check_block(arrays, j_op, j_xla, plain, plain_bwd, names, static, flags,
                 dtype, fwd_tol, bwd_tol):
    use_ln, residual = flags
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else \
        (jnp.float32, torch.float32)
    jargs, targs = _to_jax(arrays, jdt), _to_torch(arrays, tdt)
    g = _np(arrays[0].shape, 11)
    out, vjp = jax.vjp(lambda *a: j_op(*a, *static, use_ln, residual), *jargs)
    jgrads = vjp(jnp.asarray(g, jdt))
    got = plain(*targs, *static, use_ln, residual)
    assert got.dtype == tdt and got.shape == targs[0].shape
    rel = dtype == "bf16"
    _close(got.float().numpy(), out, fwd_tol, rel, "forward vs Pallas")
    if not rel:
        ref = j_xla(*jargs, *static, use_ln, residual)
        _close(got.numpy(), ref, fwd_tol, rel, "forward vs XLA")
    grads = plain_bwd(targs[0], torch.from_numpy(g).to(tdt), *targs[1:6],
                      *static, use_ln, residual)
    for name, a, b, ref in zip(names, _as_jax_layout(grads), jgrads, targs):
        assert a.shape == tuple(b.shape), name
        if name.startswith("dln") and not use_ln:
            assert not a.any() and not np.asarray(b).any(), name
        else:
            _close(a, b, bwd_tol, rel, f"{name} vs jax.vjp")


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("flags", FLAGS)
def test_attention_block_plain_matches_jax_fp32(mode, flags):
    _check_block(_attn_arrays(), j_attention_block, _fused_block_xla,
                 at.attention_block_plain, at.attention_block_bwd_plain,
                 ATTN_GRADS, (H, SCALE, mode), flags, "fp32", 3e-5, 1e-4)


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("flags", [(True, False), (True, True)])
def test_attention_block_plain_matches_jax_bf16(mode, flags):
    _check_block(_attn_arrays(), j_attention_block, _fused_block_xla,
                 at.attention_block_plain, at.attention_block_bwd_plain,
                 ATTN_GRADS, (H, SCALE, mode), flags, "bf16", 2e-2, 2e-2)


@pytest.mark.parametrize("flags", FLAGS)
def test_mlp_block_plain_matches_jax_fp32(flags):
    _check_block(_mlp_arrays(), j_mlp_block, _fused_mlp_xla,
                 mlp.mlp_block_plain, mlp.mlp_block_bwd_plain, MLP_GRADS, (),
                 flags, "fp32", 1e-5, 1e-4)


@pytest.mark.parametrize("flags", [(False, False), (True, True)])
def test_mlp_block_plain_matches_jax_bf16(flags):
    _check_block(_mlp_arrays(), j_mlp_block, _fused_mlp_xla,
                 mlp.mlp_block_plain, mlp.mlp_block_bwd_plain, MLP_GRADS, (),
                 flags, "bf16", 2e-2, 2e-2)


def _leaves(arrays, dtype):
    return [t.clone().requires_grad_() for t in _to_torch(arrays, dtype)]


@pytest.mark.parametrize("kind", ["attention-spatial", "attention-temporal",
                                  "mlp"])
@pytest.mark.parametrize("flags", FLAGS)
def test_function_backward_is_the_plain_backward(kind, flags):
    """autograd through the Function (the wrapper takes its plain versions
    for a CPU tensor) gives the hand-written plain backward, bit for bit,
    and that equals autograd through the plain forward in fp32."""
    if kind == "mlp":
        arrays, static = _mlp_arrays(), ()
        fn, plain, bwd = mlp.fused_mlp_block, mlp.mlp_block_plain, \
            mlp.mlp_block_bwd_plain
    else:
        arrays, static = _attn_arrays(), (H, SCALE, kind.split("-")[1])
        fn, plain, bwd = at.fused_attention_block, at.attention_block_plain, \
            at.attention_block_bwd_plain
    g = torch.from_numpy(_np(arrays[0].shape, 11))
    leaves = _leaves(arrays, torch.float32)
    out = fn(*leaves, *static, *flags)
    assert torch.equal(out, plain(*leaves, *static, *flags))
    grads = torch.autograd.grad(out, leaves, g)
    want = bwd(leaves[0], g, *leaves[1:6], *static, *flags)
    auto = torch.autograd.grad(plain(*leaves, *static, *flags), leaves, g,
                               allow_unused=True)
    for a, w, r in zip(grads, want, auto):
        assert torch.equal(a, w)
        if r is not None:
            np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("kind", ["attention-spatial", "attention-temporal",
                                  "mlp"])
@pytest.mark.parametrize("flags", [(True, False), (False, True)])
def test_function_gradcheck_fp64(kind, flags):
    """Tiny on purpose (gradcheck runs the function twice per input
    element); the plain versions take any joint count."""
    rs = np.random.RandomState(3)
    c, hid, heads = 4, 6, 2

    def t(*shape, scale=0.3, shift=0.0):
        return torch.from_numpy(rs.normal(size=shape) * scale
                                + shift).requires_grad_()

    x, ln = t(1, 3, 4, c, scale=1.0), (t(c, shift=1.0), t(c))
    if kind == "mlp":
        args = (x, *ln, t(hid, c), t(hid), t(c, hid), t(c))
        fn = lambda *a: mlp.fused_mlp_block(*a, *flags)
    else:
        args = (x, *ln, t(3 * c, c), t(3 * c), t(c, c), t(c))
        fn = lambda *a: at.fused_attention_block(
            *a, heads, 0.5, kind.split("-")[1], *flags)
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6)


def test_wrappers_validate_like_the_pair():
    """What the CUDA kernels do not take raises ValueError (checked on CPU
    tensors through the checkers the launch path calls first)."""
    x, *p = _to_torch(_attn_arrays(), torch.bfloat16)
    heads = C // 32
    at.check_attention_args(x, *p, heads, "spatial")
    with pytest.raises(ValueError, match="bfloat16"):
        at.check_attention_args(x.float(), *p, heads, "spatial")
    with pytest.raises(ValueError, match="joints"):
        at.check_attention_args(x[:, :, :16].contiguous(), *p, heads, "spatial")
    with pytest.raises(ValueError, match="frames"):
        at.check_attention_args(x.repeat(1, 25, 1, 1), *p, heads, "temporal")
    with pytest.raises(ValueError, match="head dim"):
        at.check_attention_args(x, *p, H, "spatial")
    with pytest.raises(ValueError, match="mode"):
        at.check_attention_args(x, *p, heads, "vanilla")
    with pytest.raises(ValueError, match="contiguous"):
        at.check_attention_args(x, p[0], p[1], p[2].t().contiguous().t(),
                                *p[3:], heads, "spatial")
    at.check_attention_args(x, None, None, *p[2:], heads, "spatial", False)
    with pytest.raises(ValueError, match="ln_w is None"):
        at.check_attention_args(x, None, None, *p[2:], heads, "spatial", True)
    xm, *pm = _to_torch(_mlp_arrays(), torch.bfloat16)
    mlp.check_mlp_args(xm, *pm)
    mlp.check_mlp_args(xm.reshape(-1, C), *pm)      # any leading shape
    mlp.check_mlp_args(xm, None, None, *pm[2:], False)
    with pytest.raises(ValueError, match="ln_b is None"):
        mlp.check_mlp_args(xm, pm[0], None, *pm[2:], True)
    with pytest.raises(ValueError, match="hidden"):
        mlp.check_mlp_args(xm, pm[0], pm[1], pm[2][:100].contiguous(),
                           pm[3][:100].contiguous(),
                           pm[4][:, :100].contiguous(), pm[5])
    with pytest.raises(ValueError, match="bfloat16"):
        mlp.check_mlp_args(xm, *pm[:2], pm[2].float(), *pm[3:])
    with pytest.raises(ValueError, match="no attention block kernel"):
        at.fused_attention_block(*(a.to("meta") for a in (x, *p)), heads,
                                 SCALE, "spatial")
    with pytest.raises(ValueError, match="no MLP block kernel"):
        mlp.fused_mlp_block(*(a.to("meta") for a in (xm, *pm)))


# ---------------------------------------------------------------------------
# DropPath and dropout
# ---------------------------------------------------------------------------

def test_droppath_masks_whole_frames():
    x = torch.from_numpy(_np((8, 50, 17, 4), 0)) + 3.0   # no zero in x
    dp = dst.DropPath(0.25)
    gen = torch.Generator().manual_seed(0)
    y = dp(x, gen)
    kept = (y != 0).all(-1).all(-1)                 # (B, F)
    dropped = (y == 0).all(-1).all(-1)
    assert torch.all(kept | dropped)                # a frame goes as a whole
    assert torch.equal(y[kept], x[kept] / 0.75)
    # 400 Bernoulli(0.75) draws: mean 0.75, std 0.0217; band of 4 std
    assert 0.66 <= kept.float().mean().item() <= 0.84
    assert torch.equal(y, dp(x, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, dp(x, torch.Generator().manual_seed(1)))
    assert dp(x, None) is x and dst.DropPath(0.0)(x, gen) is x
    # the mask does not depend on the dtype of what it masks
    yb = dp(x.bfloat16(), torch.Generator().manual_seed(0))
    assert torch.equal((yb != 0).all(-1).all(-1), kept)


def test_dropout_masks_elements():
    x = torch.from_numpy(_np((4, 10, 17, 8), 0)) + 3.0
    gen = torch.Generator().manual_seed(0)
    y = dst.dropout(x, 0.1, gen)
    kept = y != 0
    assert torch.equal(y[kept], x[kept] / 0.9)
    # 5440 Bernoulli(0.9) draws: std 0.0041; band of 4 std
    assert 0.883 <= kept.float().mean().item() <= 0.917
    assert torch.equal(y, dst.dropout(x, 0.1, torch.Generator().manual_seed(0)))
    assert dst.dropout(x, 0.1, None) is x and dst.dropout(x, 0.0, gen) is x


# ---------------------------------------------------------------------------
# the model's dropout / drop-path path
# ---------------------------------------------------------------------------

# the JAX package takes its Pallas sub-block kernels from C % 128 == 0 on
CFG = dict(dim_in=3, dim_out=3, dim_feat=128, dim_rep=64, depth=2,
           num_heads=4, mlp_ratio=2, num_joints=17, maxlen=8)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_drop_path_model():
    """A JAX DSTformer(drop_path_rate=1e-9) applied with deterministic=False:
    layer 1 takes the unfused branch through the interpreted Pallas
    sub-block kernels, with an all-keep mask and a divisor that is exactly
    1.0 in fp32. Returns (params, x, cotangent, output, gradients)."""
    jmodel = JDSTformer(**CFG, drop_path_rate=1e-9, attn_impl="pallas")
    x = _np((2, 8, 17, 3), 0)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # the gate initialises to equal shares; move it so that its gradient
    # and both streams count
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(np.asarray, params)
    for i in range(CFG["depth"]):
        gate = params[f"ts_attn_{i}"]
        gate["kernel"] = rs.normal(size=gate["kernel"].shape).astype(
            np.float32) * 0.1
    g = _np((2, 8, 17, 3), 2)

    def fwd(p):
        return jmodel.apply({"params": p}, jnp.asarray(x), deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(5)})

    out, vjp = jax.vjp(fwd, params)
    return params, x, g, np.asarray(out), _flat(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_drop_path_model_matches_jax_under_an_all_keep_mask(
        jax_drop_path_model, attn_impl, monkeypatch):
    params, x, g, jout, jgrads = jax_drop_path_model
    model = load_backbone(ConfigDict(CFG), device="cpu", attn_impl=attn_impl,
                          drop_path_rate=1e-9)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    assert [b.droppath.rate for b in model.blocks_ts] == [0.0, 1e-9]
    calls = _spy(monkeypatch, attn_impl)
    model.train()
    out = model(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    # layer 0 (rate 0) ran two pairs and the gated pair, layer 1 four
    # attention blocks and four MLP blocks
    assert calls == dict(pair=3, gated=1, attention=4, mlp=4)
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-4, rtol=1e-4)
    out.backward(torch.from_numpy(g))
    grads = _flat(jax_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()}))
    assert grads.keys() == jgrads.keys() and len(grads) > 100
    for k in jgrads:
        np.testing.assert_allclose(grads[k], jgrads[k], atol=2e-4, rtol=2e-4,
                                   err_msg=k)


def _spy(monkeypatch, attn_impl):
    """Count the calls of the pair and block functions of ``attn_impl``."""
    calls = dict(pair=0, gated=0, attention=0, mlp=0)

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    pair, gated = dst.PAIR_IMPLS[attn_impl]
    attention, mlp_fn = dst.BLOCK_IMPLS[attn_impl]
    monkeypatch.setitem(dst.PAIR_IMPLS, attn_impl,
                        (counting("pair", pair), counting("gated", gated)))
    monkeypatch.setitem(dst.BLOCK_IMPLS, attn_impl,
                        (counting("attention", attention),
                         counting("mlp", mlp_fn)))
    return calls


def _model(**rates):
    model = load_backbone(ConfigDict(CFG), device="cpu", **rates)
    return model.init_weights(torch.Generator().manual_seed(0))


def test_drop_path_training_draws_from_the_generator(monkeypatch):
    model = _model(drop_path_rate=0.5)
    x = torch.from_numpy(_np((2, 8, 17, 3), 0))
    model.train()
    run = lambda seed: model(x, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        model(x)
    # evaluation, by mode or by no_grad, runs pairs only and ignores the rates
    calls = _spy(monkeypatch, "kernel")
    with torch.no_grad():
        quiet = model(x, generator=torch.Generator().manual_seed(0))
    model.eval()
    assert torch.equal(quiet, model(x))
    assert calls == dict(pair=12, gated=4, attention=0, mlp=0)
    assert torch.equal(quiet, _model()(x))


def test_dropout_training_leaves_the_mlp_kernel(monkeypatch):
    """drop_rate > 0: every layer takes the unfused path, attention through
    its block and the MLP in plain PyTorch (the dropout between GELU and fc2
    keeps it out of the kernel)."""
    model = _model(drop_rate=0.2)
    x = torch.from_numpy(_np((2, 8, 17, 3), 0))
    calls = _spy(monkeypatch, "kernel")
    model.train()
    gen = torch.Generator().manual_seed(0)
    out = model(x, generator=gen)
    assert calls == dict(pair=0, gated=0, attention=8, mlp=0)
    out.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    model.eval()
    assert not torch.equal(out, model(x))


def test_q8_impl_runs_the_bf16_blocks():
    """The W8A8 tier and the stream kernels run the bf16 standalone blocks;
    every attn_impl the model takes has its blocks."""
    assert dst.BLOCK_IMPLS["kernel_q8"] == dst.BLOCK_IMPLS["kernel"]
    assert dst.BLOCK_IMPLS["plain_q8"] == dst.BLOCK_IMPLS["plain"]
    assert dst.BLOCK_IMPLS["kernel_stream"] == dst.BLOCK_IMPLS["kernel"]
    assert dst.BLOCK_IMPLS["kernel_stream_q8"] == dst.BLOCK_IMPLS["kernel"]
    assert set(dst.BLOCK_IMPLS) == set(dst.ATTN_IMPLS) == set(dst.CORE_IMPLS)


def test_training_with_attention_dropout_raises():
    model = _model(attn_drop_rate=0.1)
    x = torch.zeros(1, 8, 17, 3)
    with torch.no_grad():
        model(x)  # evaluation is unaffected
    model.train()
    with pytest.raises(NotImplementedError, match="attn_drop_rate"):
        model(x, generator=torch.Generator().manual_seed(0))


def test_depth_one_never_leaves_the_pair_path(monkeypatch):
    """linspace(0, rate, 1) is [0]: a depth-1 model has no live drop-path."""
    model = load_backbone(ConfigDict(dict(CFG, depth=1)), device="cpu",
                          drop_path_rate=0.3)
    model.init_weights(torch.Generator().manual_seed(0))
    calls = _spy(monkeypatch, "kernel")
    model.train()
    model(torch.zeros(1, 8, 17, 3))     # needs no generator
    assert calls == dict(pair=3, gated=1, attention=0, mlp=0)


def test_jax_tree_with_drop_path_loads_strict():
    """DropPath and Dropout hold no state: a JAX tree initialised with
    drop_path_rate > 0 converts and loads strict=True."""
    jmodel = JDSTformer(**CFG, drop_path_rate=0.1, drop_rate=0.1)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8, 17, 3)))["params"]
    model = load_backbone(ConfigDict(CFG), device="cpu", drop_path_rate=0.1,
                          drop_rate=0.1)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    model.load_state_dict(sd, strict=True)
    assert sd.keys() == _model().state_dict().keys()
