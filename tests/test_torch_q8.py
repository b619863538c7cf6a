"""The port's W8A8 pair (motionbert_tpu_torch.ops.pair_q8) against the JAX
package's (motionbert_tpu.ops.pair_q8, Pallas interpreted on the CPU as its
own tests run it), the quantisers, the straight-through backward, the model
in the q8 tier, and the ``attn_impl`` plumbing from a config down to the
pair functions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionbert_tpu.models.dstformer import DSTformer as JDSTformer
from motionbert_tpu.ops import pair_q8 as jq8
from motionbert_tpu_torch.core.config import ConfigDict
from motionbert_tpu_torch.models import dstformer as tmodel
from motionbert_tpu_torch.models import factory
from motionbert_tpu_torch.models.convert import state_dict_from_jax
from motionbert_tpu_torch.ops import fused_pair as tpair
from motionbert_tpu_torch.ops import pair_q8 as tq8

# the sizes of tests/test_pair_q8.py
B, F, J, C, H, HID = 2, 8, 17, 128, 8, 256
SCALE = (C // H) ** -0.5

_ORDER = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_s",
          "ln2_b", "w1", "b1", "w2", "b2")
_WEIGHTS = ("wqkv", "wproj", "w1", "w2", "wg")


def _mk(shape, seed, s=0.1, shift=0.0):
    return (np.random.RandomState(seed).normal(size=shape) * s
            + shift).astype(np.float32)


def _pair_np(gated):
    """Inputs in the JAX package's layout (Dense kernels (in, out))."""
    p = dict(x=_mk((B, F, J, C), 0, 0.5),
             ln1_s=_mk((C,), 1, 0.1, 1.0), ln1_b=_mk((C,), 2),
             wqkv=_mk((C, 3 * C), 3), bqkv=_mk((3 * C,), 4),
             wproj=_mk((C, C), 5), bproj=_mk((C,), 6),
             ln2_s=_mk((C,), 7, 0.1, 1.0), ln2_b=_mk((C,), 8),
             w1=_mk((C, HID), 9), b1=_mk((HID,), 10),
             w2=_mk((HID, C), 11), b2=_mk((C,), 12))
    if gated:
        p.update(other=_mk((B, F, J, C), 50, 0.5), wg=_mk((2 * C, 2), 13),
                 bg=_mk((2,), 14))
    return p


def _names(gated):
    return (["x"] + (["other"] if gated else []) + list(_ORDER)
            + (["wg", "bg"] if gated else []))


def _jax_args(p, gated):
    return [jnp.asarray(p[k]) for k in _names(gated)]


def _torch_args(p, gated):
    """The same inputs in the port's layout: nn.Linear weights (out, in)."""
    return [torch.from_numpy(np.ascontiguousarray(
        p[k].T if k in _WEIGHTS else p[k])) for k in _names(gated)]


def test_q8_rows_equals_jax():
    a = _mk((37, C), 0, 1.0)
    a[3] = 0.0          # a row under the amax floor
    a[5, :4] = (0.5, 1.5, 2.5, -0.5)   # exact ties once scale is 1
    a[5, 4] = 127.0
    qj, sj = jq8._q8_rows(jnp.asarray(a))
    qt, st = tq8.q8_rows(torch.from_numpy(a))
    assert qt.dtype == torch.int8 and st.shape == (37, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-7)


def test_quant_cols_equals_jax():
    w = _mk((C, 3 * C), 1, 1.0)          # JAX layout (in, out)
    w[:, 7] = 0.0                        # an output channel under the floor
    qj, sj = jq8.quant_cols(jnp.asarray(w))
    qt, st = tq8.quant_cols(torch.from_numpy(np.ascontiguousarray(w.T)))
    assert qt.dtype == torch.int8 and qt.shape == (3 * C, C)
    assert st.shape == (3 * C,)
    np.testing.assert_array_equal(qt.numpy().T, np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj)[0], rtol=0,
                               atol=1e-7)


def test_quant_cols_takes_bf16_weights():
    w = torch.from_numpy(_mk((HID, C), 2, 1.0)).bfloat16()
    q, s = tq8.quant_cols(w)
    back = q.float() * s[:, None]
    step = w.float().abs().amax(1, keepdim=True) / 127.0
    assert torch.all((back - w.float()).abs() <= step * 0.5 + 1e-7)


def test_int_matmul_is_exact():
    rs = np.random.RandomState(3)
    for K in (1024, 2048):   # fp32 route and float64 route
        a = rs.randint(-127, 128, size=(5, K)).astype(np.int8)
        w = rs.randint(-127, 128, size=(7, K)).astype(np.int8)
        a[0], w[0] = 127, 127            # the largest possible sum
        want = a.astype(np.int64) @ w.astype(np.int64).T
        got = tq8._int_matmul(torch.from_numpy(a), torch.from_numpy(w))
        np.testing.assert_array_equal(got.numpy(),
                                      want.astype(np.float32))


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("gated", [False, True])
def test_q8_pair_matches_jax_pallas(mode, gated):
    """fp32 on both sides. The integer products are exact on both, so the
    two differ by summation order in LN and attention (1e-6 relative) and,
    where that moves an activation across a rounding boundary of the
    quantiser, by one int8 step of one term of a 128- or 256-term sum:
    about 1/127/sqrt(128) ~ 7e-4 of a row's scale. Measured 4e-7 here (no
    value crossed a boundary at these seeds); the bar is 5e-4 of max|ref|,
    room for a crossing and far below a wrong rounding point."""
    p = _pair_np(gated)
    jfn = jq8.fused_gated_pair_block_q8 if gated else jq8.fused_pair_block_q8
    tfn = tq8.fused_gated_pair_block_q8 if gated else tq8.fused_pair_block_q8
    ref = np.asarray(jfn(*_jax_args(p, gated), H, SCALE, mode))
    out = tfn(*_torch_args(p, gated), H, SCALE, mode)
    assert out.dtype == torch.float32 and out.shape == (B, F, J, C)
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 5e-4, err


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("gated", [False, True])
def test_q8_pair_close_to_full_precision(mode, gated):
    """The bars of tests/test_pair_q8.py: relative L2 2 % (3 % gated)."""
    args = _torch_args(_pair_np(gated), gated)
    q8 = (tq8.fused_gated_pair_block_q8 if gated
          else tq8.fused_pair_block_q8)(*args, H, SCALE, mode)
    ref = (tpair.fused_gated_pair_block if gated
           else tpair.fused_pair_block)(*args, H, SCALE, mode)
    rel = (torch.linalg.norm(q8 - ref) / torch.linalg.norm(ref)).item()
    assert 0 < rel < (0.03 if gated else 0.02), rel


def test_bf16_q8_plain_tracks_jax_bf16():
    """In bf16 the plain version rounds where the TPU kernel does (q, k, v,
    P, the attention output and y in bf16; LN output and GELU(z) fp32 into
    the quantiser), so the two agree almost bit for bit: measured 0.3 % of
    the outputs differ (spatial; 0.003 % temporal), relative L2 8e-4 / 9e-6.
    A rounding point moved (LN output or GELU(z) rounded to bf16, or y left
    in fp32) makes more than 60 % of the outputs differ and the relative L2
    6e-3 to 1.8e-2, so the bars are 2 % of the outputs and 2e-3, beside the
    2e-2 of max|ref| that the CUDA kernel is held to on the card."""
    p = _pair_np(True)
    cast_j = lambda k, a: a if k.startswith("ln") else a.astype(jnp.bfloat16)
    cast_t = lambda k, a: a if k.startswith("ln") else a.bfloat16()
    names = _names(True)
    jargs = [cast_j(k, a) for k, a in zip(names, _jax_args(p, True))]
    targs = [cast_t(k, a) for k, a in zip(names, _torch_args(p, True))]
    for mode in ("spatial", "temporal"):
        ref = np.asarray(jq8.fused_gated_pair_block_q8(
            *jargs, H, SCALE, mode).astype(jnp.float32))
        out = tq8.fused_gated_pair_block_q8(*targs, H, SCALE, mode)
        assert out.dtype == torch.bfloat16
        out = out.float().numpy()
        err = np.abs(out - ref).max() / np.abs(ref).max()
        l2 = np.linalg.norm(out - ref) / np.linalg.norm(ref)
        differ = (out != ref).mean()
        assert err <= 2e-2 and l2 <= 2e-3 and differ <= 0.02, \
            (mode, err, l2, differ)


@pytest.mark.parametrize("gated", [False, True])
def test_q8_backward_is_the_full_precision_backward(gated):
    """Straight-through: the same cotangent through the q8 Function and the
    bf16 pair's Function gives the same bits for every input."""
    g = torch.from_numpy(_mk((B, F, J, C), 99, 1.0))
    grads = []
    for fn in ((tq8.fused_gated_pair_block_q8, tpair.fused_gated_pair_block)
               if gated else
               (tq8.fused_pair_block_q8, tpair.fused_pair_block)):
        args = [a.requires_grad_() for a in
                _torch_args(_pair_np(gated), gated)]
        out = fn(*args, H, SCALE, "temporal")
        grads.append(torch.autograd.grad(out, args, g))
    assert len(grads[0]) == (16 if gated else 13)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_cpu_wrapper_counts_no_launch_and_refuses_other_devices():
    args = _torch_args(_pair_np(False), False)
    before = tq8.fused_pair_block_q8.launches
    tq8.fused_pair_block_q8(*args, H, SCALE, "spatial")
    assert tq8.fused_pair_block_q8.launches == before
    with pytest.raises(ValueError, match="no pair kernel"):
        tq8.fused_pair_block_q8(*(a.to("meta") for a in args), H, SCALE,
                                "spatial")


# ---------------------------------------------------------------------------
# the model and the attn_impl plumbing
# ---------------------------------------------------------------------------

CFG = dict(dim_feat=128, dim_rep=128, depth=1, num_heads=8, mlp_ratio=2,
           maxlen=27, num_joints=17)


def test_model_q8_matches_jax_pallas_q8():
    """A depth-1 DSTformer in the q8 tier against the JAX package's
    ``attn_impl="pallas_q8"`` on converted weights, fp32. Through four
    pairs on real activations some values do cross a quantiser boundary
    (the JAX kernel's erf is a 1.5e-7 approximation, the port's is exact),
    and each crossing moves one int8 step. Measured over three seeds:
    2.4e-3..3.7e-3 of max|ref| and 7e-4..1.0e-3 relative L2, against the
    tier's own 1.1e-2..1.2e-2 relative L2 from the full-precision model.
    Bars: 1e-2 of max|ref| and 3e-3 relative L2, a quarter of that."""
    import jax

    jmodel = JDSTformer(dim_in=3, dim_out=3, attn_impl="pallas_q8", **CFG)
    x = np.random.RandomState(0).randn(2, 16, 17, 3).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 16, 17, 3)))["params"]
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = factory.load_backbone(ConfigDict(CFG), device="cpu",
                                  attn_impl="kernel_q8")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
        full = factory.load_backbone(ConfigDict(CFG), device="cpu")
        full.load_state_dict(model.state_dict())
        rel = np.linalg.norm(out - full(torch.from_numpy(x)).numpy()) \
            / np.linalg.norm(out)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    l2 = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert err <= 1e-2 and l2 <= 3e-3, (err, l2)
    assert 3e-3 < rel < 0.03, rel   # the q8 tier is in use, and close


def _pair_fns(model):
    return {tmodel.PAIR_IMPLS[b.attn_impl]
            for b in list(model.blocks_st) + list(model.blocks_ts)}


@pytest.mark.parametrize("key,want", [
    ("pallas_q8", "kernel_q8"), ("xla", "plain"), ("pallas", "kernel"),
    ("kernel_q8", "kernel_q8"), ("plain_q8", "plain_q8"), (None, "kernel")])
def test_config_attn_impl_key_picks_the_pair_functions(key, want):
    """A config's ``attn_impl`` key used to be ignored: every config ran
    the bf16 kernels."""
    cfg = dict(CFG, **({"attn_impl": key} if key else {}))
    model = factory.load_backbone(ConfigDict(cfg), device="cpu")
    assert _pair_fns(model) == {tmodel.PAIR_IMPLS[want]}
    if want == "kernel_q8":
        assert tmodel.PAIR_IMPLS[want] == (tq8.fused_pair_block_q8,
                                           tq8.fused_gated_pair_block_q8)
    # the argument wins over the key
    model = factory.load_backbone(ConfigDict(cfg), device="cpu",
                                  attn_impl="plain")
    assert _pair_fns(model) == {tmodel.PAIR_IMPLS["plain"]}


@pytest.mark.parametrize("key", ["pallas_stream", "pallas_stream_q8"])
def test_stream_attn_impl_raises_naming_the_kernel(key):
    """The stream kernel (B10) used to be unported, and these names raised:
    now the config key and the argument both reach the stream functions."""
    want = tmodel.STREAM_IMPLS[factory.JAX_ATTN_IMPLS[key]]
    assert want[0].__name__ == ("fused_stream_block_q8" if key.endswith("q8")
                                else "fused_stream_block")
    for model in (factory.load_backbone(ConfigDict(dict(CFG, attn_impl=key)),
                                        device="cpu"),
                  factory.load_backbone(ConfigDict(CFG), device="cpu",
                                        attn_impl=key)):
        assert {tmodel.STREAM_IMPLS[b.attn_impl] for b in
                list(model.blocks_st) + list(model.blocks_ts)} == {want}


def test_unknown_attn_impl_lists_the_known_ones():
    with pytest.raises(ValueError, match="kernel_q8"):
        factory.load_backbone(ConfigDict(dict(CFG, attn_impl="int4")),
                              device="cpu")


def _write_config(tmp_path, attn_impl):
    path = tmp_path / f"cfg_{attn_impl}.yaml"
    lines = [f"{k}: {v}" for k, v in CFG.items()] + [
        f"attn_impl: {attn_impl}", "flip: true", "rootrel: true"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_entry_points_resolve_the_config_key(tmp_path):
    """MotionBERT.from_config and MotionBERTServer.from_config reach the q8
    pair functions from ``attn_impl: pallas_q8`` in the YAML, and take an
    ``attn_impl=`` argument that wins; ``pallas_stream`` reaches the stream
    functions, which compute the pair path's values."""
    from motionbert_tpu_torch.api import MotionBERT
    from motionbert_tpu_torch.serve import MotionBERTServer

    cfg = _write_config(tmp_path, "pallas_q8")
    q8 = {tmodel.PAIR_IMPLS["kernel_q8"]}
    mb = MotionBERT.from_config(cfg, device="cpu")
    assert _pair_fns(mb.model) == q8
    assert _pair_fns(MotionBERT.from_config(
        cfg, device="cpu", attn_impl="xla").model) \
        == {tmodel.PAIR_IMPLS["plain"]}
    with MotionBERTServer.from_config(cfg, device="cpu") as srv:
        assert _pair_fns(srv.mb.model) == q8
        x = np.random.RandomState(1).uniform(-1, 1, (9, 17, 3)).astype(
            np.float32)
        np.testing.assert_array_equal(srv.lift(x).result(timeout=60),
                                      mb.lift(x[None])[0])
    with MotionBERTServer.from_config(
            _write_config(tmp_path, "xla"), device="cpu",
            attn_impl="kernel_q8") as srv:
        assert _pair_fns(srv.mb.model) == q8
    cfg = _write_config(tmp_path, "pallas_stream")
    stream = MotionBERT.from_config(cfg, device="cpu")
    assert {b.attn_impl for b in stream.model.blocks_ts} == {"kernel_stream"}
    pairs = MotionBERT.from_config(cfg, device="cpu", attn_impl="kernel")
    np.testing.assert_array_equal(stream.lift(x[None]), pairs.lift(x[None]))


def test_pose3d_driver_trains_through_the_q8_forward(tmp_path, monkeypatch):
    """The pose3d command line takes --attn_impl, and the driver trains with
    the q8 forward and the straight-through backward: one epoch on the
    synthetic smoke set on the CPU, finite loss and errors."""
    import os
    import types

    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.train import pose3d

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = get_config(os.path.join(root, "configs", "pose3d",
                                   "MB_train_synth_smoke.yaml"))
    args.data_root = os.path.join(root, args.data_root)
    args.dt_root = os.path.join(root, args.dt_root)
    args.epochs = 1
    built = []
    real = factory.load_backbone

    def spy(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    monkeypatch.setattr(factory, "load_backbone", spy)
    opts = pose3d.parse_args(["-c", str(tmp_path), "--device", "cpu",
                              "--attn_impl", "kernel_q8"])
    assert opts.attn_impl == "kernel_q8"
    out = pose3d.train_with_config(
        args, types.SimpleNamespace(
            checkpoint=str(tmp_path), pretrained="", resume="", evaluate="",
            selection="", seed=0),
        device=opts.device, attn_impl=opts.attn_impl)
    assert _pair_fns(built[0]) == {tmodel.PAIR_IMPLS["kernel_q8"]}
    (epoch,) = out["history"]
    assert np.isfinite([epoch["losses"]["total"], epoch["e1"],
                        epoch["e2"]]).all()
