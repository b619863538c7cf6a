"""The port's DSTformer, weight conversion, checkpoint readers and public API
against the JAX package: the reference goldens, the trained anchor, and
motionbert_tpu.api.MotionBERT on the XLA fp32 path."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionbert_tpu.core.checkpoint import load_params_npz as jax_load_npz
from motionbert_tpu.geometry.skeleton import flip_data as jax_flip_data
from motionbert_tpu.models.convert import flax_to_torch_state_dict
from motionbert_tpu_torch.api import MotionBERT
from motionbert_tpu_torch.core import checkpoint as tckpt
from motionbert_tpu_torch.core.config import ConfigDict, get_config
from motionbert_tpu_torch.geometry.skeleton import H36M_FLIP_PERM, flip_data
from motionbert_tpu_torch.models import factory
from motionbert_tpu_torch.models.convert import (
    jax_from_state_dict, state_dict_from_jax, strip_module_prefix)
from motionbert_tpu_torch.models.dstformer import DSTformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
ANCHOR = os.path.join(ROOT, "data", "anchors", "flagship_synth_trained.npz")
FLAGSHIP_YAML = os.path.join(ROOT, "configs", "pose3d", "MB_ft_h36m.yaml")

# the geometries of tests/test_dstformer.py's goldens; "flagship" and
# "lite" are the registry's widths at depth 1
GOLDEN_CFGS = {
    "small": dict(dim_feat=64, dim_rep=64, depth=2, num_heads=4, mlp_ratio=2,
                  maxlen=27),
    "mid": dict(dim_feat=128, dim_rep=128, depth=5, num_heads=8, mlp_ratio=2,
                maxlen=81),
    "flagship": dict(factory.FLAGSHIP_CONFIG, depth=1, maxlen=27),
    "lite": dict(factory.LITE_CONFIG, depth=1, maxlen=27),
}


def _cpu_model(cfg, attn_impl="kernel"):
    return factory.load_backbone(ConfigDict({"num_joints": 17, **cfg}),
                                 device="cpu", attn_impl=attn_impl)


@pytest.mark.parametrize("name", sorted(GOLDEN_CFGS))
def test_goldens_strict_load_and_parity(name):
    """fp32 out and rep match the reference goldens at 2e-5, the bar the JAX
    package holds (PARITY.md §2.1)."""
    z = np.load(os.path.join(GOLDENS, f"dstformer_{name}.npz"))
    sd = {k[3:]: torch.from_numpy(np.asarray(z[k], np.float32))
          for k in z.files if k.startswith("sd:")}
    model = _cpu_model(GOLDEN_CFGS[name])
    model.load_state_dict(sd, strict=True)
    x = torch.from_numpy(z["x"])
    with torch.inference_mode():
        out, rep = model(x), model(x, return_rep=True)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), z["out"], atol=2e-5)
    np.testing.assert_allclose(rep.numpy(), z["rep"], atol=2e-5)


def test_plain_impl_equals_kernel_impl_on_cpu():
    """On the CPU the wrappers take the plain versions, so the two
    attn_impl values compute the same thing."""
    z = np.load(os.path.join(GOLDENS, "dstformer_small.npz"))
    sd = {k[3:]: torch.from_numpy(np.asarray(z[k], np.float32))
          for k in z.files if k.startswith("sd:")}
    outs = []
    for impl in ("kernel", "plain"):
        model = _cpu_model(GOLDEN_CFGS["small"], attn_impl=impl)
        model.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            outs.append(model(torch.from_numpy(z["x"])).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.fixture(scope="module")
def anchor():
    jax_params, meta = jax_load_npz(ANCHOR)
    sd, tmeta = tckpt.load_params_npz(ANCHOR)
    return jax_params, meta, sd, tmeta


def test_state_dict_from_jax_matches_flax_to_torch(anchor):
    jax_params, meta, sd, tmeta = anchor
    assert tmeta == meta
    ref = flax_to_torch_state_dict({"params": jax_params})
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert sd["ts_attn.0.weight"].shape == (2, 2 * 512)
    assert sd["pre_logits.fc.weight"].shape == (512, 512)


def test_anchor_loads_strict_into_flagship(anchor):
    model = factory.load_backbone(get_config(FLAGSHIP_YAML), device="cpu")
    model.load_state_dict(anchor[2], strict=True)
    DSTformer(**factory.FLAGSHIP_CONFIG).load_state_dict(anchor[2],
                                                          strict=True)


def test_convert_roundtrip_golden():
    z = np.load(os.path.join(GOLDENS, "dstformer_small.npz"))
    sd = {k[3:]: np.asarray(z[k], np.float32) for k in z.files
          if k.startswith("sd:")}
    back = state_dict_from_jax(jax_from_state_dict(sd))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])


def test_strip_module_prefix():
    assert strip_module_prefix({"module.a.b": 1, "c": 2}) == {"a.b": 1, "c": 2}


def _small_sd():
    z = np.load(os.path.join(GOLDENS, "dstformer_small.npz"))
    return {k[3:]: torch.from_numpy(np.asarray(z[k], np.float32))
            for k in z.files if k.startswith("sd:")}


def test_checkpoint_readers(tmp_path):
    """A reference torch .bin (model_pos, module. prefixes), a JAX package
    checkpoint (its own save_checkpoint, optax state included) and an npz
    snapshot all read into the same state_dict."""
    import optax

    from motionbert_tpu.core.checkpoint import save_checkpoint, save_params_npz
    from motionbert_tpu.models.convert import torch_state_dict_to_flax

    sd = _small_sd()
    binf = str(tmp_path / "best_epoch.bin")
    torch.save({"epoch": 3, "model_pos": {f"module.{k}": v
                                          for k, v in sd.items()}}, binf)
    params = torch_state_dict_to_flax(
        {k: v.numpy() for k, v in sd.items()})["params"]
    ckpt = str(tmp_path / "latest_epoch.ckpt")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    save_checkpoint(ckpt, epoch=1, lr=1e-3, params=jparams,
                    opt_state=optax.adamw(1e-3).init(jparams))
    npz = str(tmp_path / "snap.npz")
    save_params_npz(npz, jparams, meta={"k": 1})
    for path in (binf, ckpt, npz):
        got = tckpt.load_state_dict(path)
        assert set(got) == set(sd), path
        for k in sd:
            np.testing.assert_array_equal(got[k].numpy(), sd[k].numpy())
    assert tckpt.load_params_npz(npz)[1] == {"k": 1}


def test_config_include(tmp_path):
    (tmp_path / "base.yaml").write_text("dim_feat: 64\nnested: {a: 1}\n")
    (tmp_path / "top.yaml").write_text("base: !include base.yaml\ndepth: 2\n")
    cfg = get_config(str(tmp_path / "top.yaml"))
    assert cfg.name == "top" and cfg.depth == 2
    assert cfg.base.dim_feat == 64 and cfg.base.nested.a == 1
    flagship = get_config(FLAGSHIP_YAML)
    assert (flagship.dim_feat, flagship.depth, flagship.num_heads) == (512, 5, 8)


def test_flip_matches_jax():
    x = np.random.RandomState(0).normal(size=(2, 4, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(flip_data(torch.from_numpy(x)).numpy(),
                                  jax_flip_data(x))
    from motionbert_tpu.geometry.skeleton import H36M_FLIP_PERM as jperm
    assert list(H36M_FLIP_PERM) == list(jperm)


def test_entry_points_need_the_card_unless_told():
    """device=None means the card; with no CUDA device it raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MotionBERT.from_config(FLAGSHIP_YAML)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory.load_backbone(get_config(FLAGSHIP_YAML))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory.resolve_device("cuda:0")


def test_compute_dtype_rule():
    cfg = ConfigDict({"num_joints": 17, **GOLDEN_CFGS["small"]})
    assert factory.load_backbone(cfg, device="cpu").compute_dtype \
        == torch.float32
    cfg.bf16 = True
    model = factory.load_backbone(cfg, device="cpu")
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert factory.default_compute_dtype(torch.device("cuda")) \
        == torch.bfloat16


def test_from_config_without_checkpoint_is_seeded():
    a = MotionBERT.from_config(FLAGSHIP_YAML, device="cpu").model.state_dict()
    b = MotionBERT.from_config(FLAGSHIP_YAML, device="cpu").model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.all(a["ts_attn.0.weight"] == 0)
    assert torch.all(a["ts_attn.0.bias"] == 0.5)
    assert 0.015 < a["blocks_st.0.attn_s.qkv.weight"].std() < 0.025


def test_api_rejects_bad_input():
    mb = MotionBERT(_cpu_model(GOLDEN_CFGS["small"]), maxlen=27)
    with pytest.raises(ValueError):
        mb.lift(np.zeros((1, 9, 16, 3), np.float32))
    with pytest.raises(ValueError):
        mb.lift(np.zeros((1, 28, 17, 3), np.float32))


def test_anchor_lift_and_representation_match_jax(anchor):
    """The port's lift and get_representation on the trained anchor (depth
    5, C 512) against motionbert_tpu.api.MotionBERT on the XLA fp32 path.
    Tolerance 1e-5 abs: both are fp32 on the CPU and differ only in
    summation order through five dual layers, on outputs of O(1) (measured
    below 1e-6)."""
    from motionbert_tpu.api import MotionBERT as JaxMotionBERT
    from motionbert_tpu.core.config import get_config as jax_get_config
    from motionbert_tpu.models.factory import load_backbone as jax_backbone

    jax_params, _, sd, _ = anchor
    jmodel = jax_backbone(jax_get_config(FLAGSHIP_YAML),
                          compute_dtype=jnp.float32, attn_impl="xla")
    jmb = JaxMotionBERT(jmodel, jax_params, maxlen=243)
    tmb = MotionBERT.from_config(FLAGSHIP_YAML, device="cpu")
    tmb.model.load_state_dict(sd, strict=True)

    rs = np.random.RandomState(0)
    x = np.concatenate([rs.uniform(-1, 1, (2, 9, 17, 2)),
                        rs.uniform(0.5, 1, (2, 9, 17, 1))], -1).astype(np.float32)
    lift, jlift = tmb.lift(x), jmb.lift(x)
    assert lift.shape == (2, 9, 17, 3) and lift.dtype == np.float32
    np.testing.assert_allclose(lift, jlift, atol=1e-5, rtol=0)
    assert np.all(lift[:, :, 0] == 0)
    rep, jrep = tmb.get_representation(x), jmb.get_representation(x)
    assert rep.shape == (2, 9, 17, 512)
    np.testing.assert_allclose(rep, jrep, atol=1e-5, rtol=0)
    no_tta = tmb.lift(x, flip_tta=False, rootrel=False)
    np.testing.assert_allclose(no_tta, jmb.lift(x, flip_tta=False,
                                                rootrel=False),
                               atol=1e-5, rtol=0)


def test_attention_gate_stats_match_jax():
    """Per-sample, per-layer gate weights against the JAX package's
    ``attention_gate_stats`` on converted weights (the gate moved off its
    uniform initialisation), 1e-5; the model's own forward keeps its bits."""
    from motionbert_tpu.models.dstformer import DSTformer as JDSTformer
    from motionbert_tpu.models.dstformer import (
        attention_gate_stats as jgate_stats)
    from motionbert_tpu_torch.models.dstformer import attention_gate_stats

    cfg = dict(dim_feat=32, dim_rep=32, depth=2, num_heads=4, mlp_ratio=2,
               maxlen=9, num_joints=17)
    jmodel = JDSTformer(dim_in=3, dim_out=3, **cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 9, 17, 3)))["params"]
    rs = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rs.normal(size=a.shape).astype(np.float32)
        * 0.2, params)
    x = rs.normal(size=(3, 9, 17, 3)).astype(np.float32)
    want = jgate_stats(jmodel, {"params": params}, jnp.asarray(x))
    model = _cpu_model(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        before = model(torch.from_numpy(x))
        got = attention_gate_stats(model, torch.from_numpy(x))
        after = model(torch.from_numpy(x))
    assert torch.equal(before, after)
    for k in ("attn_count_s", "attn_count_t"):
        assert got[k].shape == (3, 2)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["attn_count_s"] + got["attn_count_t"], 1.0,
                               atol=1e-6)
    assert np.ptp(got["attn_count_s"]) > 1e-3   # the gate is not uniform
