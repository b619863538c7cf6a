"""Plain PyTorch MLP sub-block of the DSTformer pair.

``x + fc2(GELU(fc1(LN x)))`` with the exact erf GELU, the counterpart of the
JAX package's ``_fused_mlp_xla`` (``motionbert_tpu/ops/fused_mlp.py``). The
hidden activation is rounded to x's dtype before fc2, as the CUDA pair kernel
rounds it (``ops/fused_pair.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from motionbert_tpu_torch.ops.attention import layer_norm, linear, wide


def mlp_block(x: torch.Tensor, ln_w, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """Pre-LN MLP sub-block with residual, returned in fp32."""
    h = layer_norm(x, ln_w, ln_b)
    z = F.gelu(linear(h, w1, b1)).to(x.dtype)
    return linear(z, w2, b2) + wide(x)
