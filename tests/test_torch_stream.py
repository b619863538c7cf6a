"""The port's stream functions (motionbert_tpu_torch.ops.fused_stream)
against the JAX package's (motionbert_tpu.ops.fused_stream: the XLA
composition, and the Pallas kernel interpreted on the CPU as its own tests
run it), their backward, the W8A8 twins, and the model and entry points under
``attn_impl`` "kernel_stream" / "pallas_stream"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionbert_tpu.models.dstformer import DSTformer as JDSTformer
from motionbert_tpu.ops import fused_stream as jfs
from motionbert_tpu.ops import pair_q8 as jq8
from motionbert_tpu_torch.core.config import ConfigDict
from motionbert_tpu_torch.models import dstformer as tmodel
from motionbert_tpu_torch.models import factory
from motionbert_tpu_torch.models.convert import jax_from_state_dict
from motionbert_tpu_torch.ops import attention as tattn
from motionbert_tpu_torch.ops import fused_pair as tpair
from motionbert_tpu_torch.ops import fused_stream as tfs

# the sizes of tests/test_fused_stream.py
B, J, C, H = 2, 17, 32, 4
SCALE = (C // H) ** -0.5
ORDERS = [("s", "t"), ("t", "s")]
# indices of the Dense kernels in a pair's 12 parameters (transposed to
# nn.Linear's layout for the port)
_KERNELS = (2, 4, 8, 10)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The port's side is tiny: one intra-op thread runs it faster than a
    pool that contends for the cores with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mk(shape, seed, s=1.0, shift=0.0):
    return (np.random.RandomState(seed).normal(size=shape) * s
            + shift).astype(np.float32)


def _pair_np(seed0, C=C):
    """A pair's parameters in the JAX layout (tests/test_fused_stream.py)."""
    return [_mk((C,), seed0, 0.1, 1.0), _mk((C,), seed0 + 1, 0.1),
            _mk((C, 3 * C), seed0 + 2, 0.1), _mk((3 * C,), seed0 + 3, 0.1),
            _mk((C, C), seed0 + 4, 0.1), _mk((C,), seed0 + 5, 0.1),
            _mk((C,), seed0 + 6, 0.1, 1.0), _mk((C,), seed0 + 7, 0.1),
            _mk((C, 2 * C), seed0 + 8, 0.1), _mk((2 * C,), seed0 + 9, 0.1),
            _mk((2 * C, C), seed0 + 10, 0.1), _mk((C,), seed0 + 11, 0.1)]


def _inputs(F, gated, C=C):
    """(x, other, p1, p2, wg, bg) in the JAX layout, numpy."""
    other = _mk((B, F, J, C), 1) if gated else None
    wg = _mk((2 * C, 2), 300, 0.1) if gated else None
    bg = _mk((2,), 301, 0.1, 0.5) if gated else None
    return (_mk((B, F, J, C), 0), other, _pair_np(100, C), _pair_np(200, C),
            wg, bg)


def _jax(a):
    return None if a is None else jnp.asarray(a)


def _torch_pair(p):
    return [torch.from_numpy(np.ascontiguousarray(a.T if i in _KERNELS
                                                  else a))
            for i, a in enumerate(p)]


def _torch_args(x, other, p1, p2, wg, bg):
    """The port's arguments: x, [other,] pass 1's 12, pass 2's 12, [wg, bg]
    in nn.Linear's layout."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = [t(x)] + ([t(other)] if other is not None else [])
    args += _torch_pair(p1) + _torch_pair(p2)
    if other is not None:
        args += [t(wg.T), t(bg)]
    return args


# The XLA references run jitted (one compile per shape). The interpreted
# Pallas kernels run eagerly: each call costs seconds either way, and jitting
# one costs more.
_STREAM = {False: jfs.fused_stream_block, True: jfs.fused_gated_stream_block}
_STREAM_Q8 = {False: jfs.fused_stream_block_q8,
              True: jfs.fused_gated_stream_block_q8}
_STREAM_XLA = jax.jit(jfs._stream_xla, static_argnums=(6, 7, 8))


def _jax_stream(fns, x, other, p1, p2, wg, bg, order):
    p1, p2 = [jnp.asarray(a) for a in p1], [jnp.asarray(a) for a in p2]
    if other is None:
        return np.asarray(fns[False](jnp.asarray(x), *p1, *p2, H, SCALE,
                                     order))
    return np.asarray(fns[True](jnp.asarray(x), jnp.asarray(other), *p1, *p2,
                                jnp.asarray(wg), jnp.asarray(bg), H, SCALE,
                                order))


def _port(gated, q8=False):
    if q8:
        return tfs.fused_gated_stream_block_q8 if gated \
            else tfs.fused_stream_block_q8
    return tfs.fused_gated_stream_block if gated else tfs.fused_stream_block


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("F", [9, 19])
def test_plain_stream_matches_jax(F, gated, order):
    """fp32 on both sides: the port's stream on a CPU tensor (its plain
    version) against the JAX package's XLA composition and, at F 19, its
    stream kernel interpreted (the spatial tail tile included; below 16
    frames the JAX package takes its pair fallback), at the JAX tests'
    bar."""
    inp = _inputs(F, gated)
    out = _port(gated)(*_torch_args(*inp), H, SCALE, order)
    assert out.dtype == torch.float32 and out.shape == (B, F, J, C)
    x, other, p1, p2, wg, bg = inp
    refs = [np.asarray(_STREAM_XLA(
        jnp.asarray(x), _jax(other), [jnp.asarray(a) for a in p1],
        [jnp.asarray(a) for a in p2], _jax(wg), _jax(bg), H, SCALE, order))]
    if F >= jfs.STREAM_TF:
        refs.append(_jax_stream(_STREAM, *inp, order))
    for ref in refs:
        np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=3e-5)


def _q8_pairs(x, other, p1, p2, wg, bg, m1, m2):
    """The JAX package's two q8 pairs, the second gated when other is
    given."""
    y = jq8.fused_pair_block_q8(x, *p1, H, SCALE, m1)
    if other is None:
        return jq8.fused_pair_block_q8(y, *p2, H, SCALE, m2)
    return jq8.fused_gated_pair_block_q8(y, other, *p2, wg, bg, H, SCALE, m2)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("gated", [False, True])
def test_q8_plain_stream_matches_jax(gated, order):
    """The W8A8 stream's plain version against the JAX q8 pair composition
    and against the JAX q8 stream kernel interpreted, fp32. The integer
    products are exact on both sides; LayerNorm, attention and GELU sum in
    another order (the JAX erf is a 1.5e-7 approximation, the port's exact),
    and where that moves an activation across a quantiser boundary the term
    moves one int8 step, ~1/127/sqrt(C) of a product. At these inputs 0.15 %
    of one pair's outputs cross (5e-4 of max|ref| at C 32); through two
    pairs: test_torch_q8.py's model bars, 1e-2 of max|ref| and 3e-3
    relative L2; and the JAX tests' own 1e-2 against their ungated kernel."""
    inp = _inputs(19, gated)
    x, other, p1, p2, wg, bg = inp
    out = _port(gated, q8=True)(*_torch_args(*inp), H, SCALE, order)
    m1, m2 = ("spatial", "temporal") if order == ("s", "t") \
        else ("temporal", "spatial")
    ref = np.asarray(_q8_pairs(jnp.asarray(x), _jax(other),
                               [jnp.asarray(a) for a in p1],
                               [jnp.asarray(a) for a in p2], _jax(wg),
                               _jax(bg), m1, m2))
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    l2 = np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref)
    assert err <= 1e-2 and l2 <= 3e-3, (err, l2)
    if not gated:
        ref_kernel = _jax_stream(_STREAM_Q8, *inp, order)
        np.testing.assert_allclose(out.numpy(), ref_kernel, atol=1e-2,
                                   rtol=1e-2)


@pytest.mark.parametrize("gated,order,F", [(False, ("s", "t"), 19),
                                           (True, ("t", "s"), 9)])
def test_stream_grads_match_jax(gated, order, F):
    """Gradients of FusedStream / FusedGatedStream (the plain pair backward
    twice, pass 1 recomputed) against jax.grad of the XLA composition, for
    x, [other,] every parameter [and the gate], at the JAX tests' bar."""
    inp = _inputs(F, gated)
    x, other, p1, p2, wg, bg = inp
    args = [a.requires_grad_() for a in _torch_args(*inp)]
    out = _port(gated)(*args, H, SCALE, order)
    (out ** 2).sum().backward()

    def loss(x, other, p1, p2, wg, bg):
        return jnp.sum(jfs._stream_xla(x, other, p1, p2, wg, bg, H, SCALE,
                                       order) ** 2)

    jargs = (jnp.asarray(x), _jax(other), [jnp.asarray(a) for a in p1],
             [jnp.asarray(a) for a in p2], _jax(wg), _jax(bg))
    argnums = (0, 1, 2, 3, 4, 5) if gated else (0, 2, 3)
    grads = jax.jit(jax.grad(loss, argnums=argnums))(*jargs)
    want = [grads[0]] + ([grads[1]] if gated else []) \
        + list(grads[-4 if gated else -2]) + list(grads[-3 if gated else -1])
    if gated:
        want += [grads[-2].T, grads[-1]]
    assert len(want) == len(args)
    for i, (a, w) in enumerate(zip(args, want)):
        w = np.asarray(w)
        k = (i - 1 - gated) % 12
        if 1 + gated <= i < 25 + gated and k in _KERNELS:
            w = w.T
        np.testing.assert_allclose(a.grad.numpy(), w, atol=2e-4, rtol=2e-4,
                                   err_msg=f"argument {i}")


@pytest.mark.parametrize("gated", [False, True])
def test_q8_backward_is_the_bf16_stream_backward(gated):
    """Straight-through: the same cotangent through the q8 Function and the
    bf16 stream's Function gives the same bits for every input."""
    inp = _inputs(9, gated)
    g = torch.from_numpy(_mk((B, 9, J, C), 7))
    grads = []
    for fn in (_port(gated, q8=True), _port(gated)):
        args = [a.requires_grad_() for a in _torch_args(*inp)]
        out = fn(*args, H, SCALE, ("t", "s"))
        grads.append(torch.autograd.grad(out, args, g))
    assert len(grads[0]) == (28 if gated else 25)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_stream_is_the_pair_composition_in_bf16():
    """In bf16 the stream's plain version is the port's two pair calls, bit
    for bit (the CUDA kernel is held to the same on the card)."""
    t = _torch_args(*_inputs(19, True))
    cast = lambda p: [a if i in (0, 1, 6, 7) else a.bfloat16()
                      for i, a in enumerate(p)]    # LayerNorms stay fp32
    x, other, wg, bg = (a.bfloat16() for a in (t[0], t[1], t[26], t[27]))
    p1, p2 = cast(t[2:14]), cast(t[14:26])
    out = tfs.fused_gated_stream_block(x, other, *p1, *p2, wg, bg, H, SCALE,
                                       ("s", "t"))
    y = tpair.fused_pair_block(x, *p1, H, SCALE, "spatial")
    ref = tpair.fused_gated_pair_block(y, other, *p2, wg, bg, H, SCALE,
                                       "temporal")
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


def test_wrappers_validate_and_count_no_cpu_launch():
    args = _torch_args(*_inputs(9, False))
    before = (tfs.fused_stream_block.launches,
              tfs.fused_stream_block_bwd.launches)
    tfs.fused_stream_block(*args, H, SCALE, ("s", "t"))
    assert (tfs.fused_stream_block.launches,
            tfs.fused_stream_block_bwd.launches) == before
    with pytest.raises(ValueError, match="order"):
        tfs.fused_stream_block(*args, H, SCALE, ("s", "s"))
    with pytest.raises(TypeError, match="arguments"):
        tfs.fused_stream_block(*args[:-1], H, SCALE, ("s", "t"))
    with pytest.raises(ValueError, match="no stream kernel"):
        tfs.fused_stream_block(*(a.to("meta") for a in args), H, SCALE,
                               ("s", "t"))


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("case,match", [("rows", "token rows"),
                                        ("misaligned", "16-byte-aligned")])
def test_launcher_checks_rows_and_alignment_in_both_tiers(q8, case, match):
    """The stream's launcher holds each pass to the pair kernels' conditions
    before it quantises or loads its library, in both tiers alike: the W8A8
    passes' s8 engine walks its tiles with persistent blocks, so the
    tensor-core core's 32-bit item count bounds their rows too
    (core_max_rows), and x must sit at a 16-byte-aligned address for the
    engines' TMA loads."""
    heads = 2                                    # head dim 32 at C 64
    args = _torch_args(*_inputs(3, False, C=64))
    pairs = [[t if i in (0, 1, 6, 7) else t.bfloat16()
              for i, t in enumerate(args[k:k + 12])] for k in (1, 13)]
    x = args[0].bfloat16()
    if case == "rows":
        x = torch.zeros(1, 1, J, 64, dtype=torch.bfloat16).expand(
            tattn.core_max_rows(heads) // J + 1, 1, J, 64)
    else:
        flat = torch.empty(x.numel() + 1, dtype=x.dtype)[1:]
        flat.copy_(x.reshape(-1))
        x = flat.view(x.shape)
    with pytest.raises(ValueError, match=match):
        tfs._launch(x, None, *pairs, None, None, heads, 0.125, ("s", "t"), q8)


# ---------------------------------------------------------------------------
# the model and the entry points
# ---------------------------------------------------------------------------

# C 128: the JAX package takes its Pallas paths only for lane-aligned widths
CFG = dict(dim_feat=128, dim_rep=128, depth=1, num_heads=8, mlp_ratio=2,
           maxlen=16, num_joints=17)


def test_model_kernel_stream_matches_jax_pallas_stream():
    """A depth-1 DSTformer under "kernel_stream" against the JAX package's
    ``attn_impl="pallas_stream"`` (its stream kernel interpreted) on the
    port's weights converted, fp32, at the model tests' bar, and against
    the port's pair path on the same weights, bit for bit."""
    model = factory.load_backbone(ConfigDict(CFG), device="cpu",
                                  attn_impl="pallas_stream")
    assert {b.attn_impl for b in model.blocks_st} == {"kernel_stream"}
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():   # a gate that weighs both streams
        for lin in model.ts_attn:
            lin.weight.normal_(0.0, 0.05, generator=torch.Generator()
                               .manual_seed(1))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    jax_from_state_dict(model.state_dict()))
    jmodel = JDSTformer(dim_in=3, dim_out=3, attn_impl="pallas_stream", **CFG)
    x = np.random.RandomState(0).randn(1, 16, 17, 3).astype(np.float32)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    pairs = factory.load_backbone(ConfigDict(CFG), device="cpu")
    pairs.load_state_dict(model.state_dict())
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(out, pairs(torch.from_numpy(x)).numpy())
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def _spy(monkeypatch):
    """Count the calls of every pair and stream function the model reaches."""
    calls = {}

    def wrap(name, fn):
        def spy(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return spy

    for table in ("PAIR_IMPLS", "STREAM_IMPLS"):
        monkeypatch.setattr(tmodel, table, {
            k: tuple(wrap(f.__name__, f) for f in fns)
            for k, fns in getattr(tmodel, table).items()})
    return calls


@pytest.mark.parametrize("impl,want", [
    ("kernel_stream", {"fused_stream_block": 2,
                       "fused_gated_stream_block": 2}),
    ("kernel_stream_q8", {"fused_stream_block_q8": 2,
                          "fused_gated_stream_block_q8": 2}),
    ("kernel", {"fused_pair_block": 6, "fused_gated_pair_block": 2})])
def test_stream_calls_per_forward(monkeypatch, impl, want):
    """One stream call per block and stream: depth 2 makes 2 + 2, and no
    pair function; the pair path's own count for comparison."""
    calls = _spy(monkeypatch)
    model = factory.load_backbone(ConfigDict(dict(CFG, depth=2)),
                                  device="cpu", attn_impl=impl)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        model(torch.zeros(1, 5, 17, 3))
    assert calls == want


def test_stochastic_and_stage_para_paths_take_no_stream(monkeypatch):
    """Under the stream impls, training with drop-path runs layer 0 as one
    stream (its rate is 0) and the other layers through the standalone
    blocks, as the pair path does; Block(stage_para) takes no stream."""
    calls = _spy(monkeypatch)
    model = factory.load_backbone(ConfigDict(dict(CFG, depth=2)),
                                  device="cpu", attn_impl="kernel_stream",
                                  drop_path_rate=0.1)
    model.init_weights(torch.Generator().manual_seed(0)).train()
    gen = torch.Generator().manual_seed(1)
    model(torch.zeros(1, 5, 17, 3), generator=gen).sum().backward()
    assert calls == {"fused_stream_block": 1, "fused_gated_stream_block": 1}
    calls.clear()
    blk = tmodel.Block(128, 8, 2, "stage_para", attn_impl="kernel_stream",
                       att_fuse=True)
    with torch.inference_mode():
        blk(torch.zeros(1, 5, 17, 128))
    assert calls == {}


@pytest.mark.parametrize("key,want", [
    ("pallas_stream", "kernel_stream"), ("pallas_stream_q8", "kernel_stream_q8"),
    ("kernel_stream", "kernel_stream")])
def test_attn_impl_maps_the_stream_names(key, want):
    model = factory.load_backbone(ConfigDict(dict(CFG, attn_impl=key)),
                                  device="cpu")
    assert {b.attn_impl for b in model.blocks_ts} == {want}
    assert tmodel.STREAM_IMPLS[want][0].__name__.startswith(
        "fused_stream_block")
