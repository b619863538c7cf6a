"""The port's CUDA pair kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. This file imports
neither jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from motionbert_tpu_torch.core.config import ConfigDict
from motionbert_tpu_torch.models.factory import load_backbone
from motionbert_tpu_torch.ops import fused_pair as fp

# bf16 kernel vs bf16 plain: rounding flips of intermediates only
TOL = 2e-2


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
    """M = B*F*J not a multiple of the 64-row tile, and F = 1."""
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
