"""The yardstick's arithmetic: the H100's peaks and the work a DSTformer
pair, a forward and a finetune step need, from their shapes alone.

The counts are the algorithm's, the same whatever implements it: each
product and the attention core once, the input read once, the output
written once, the weights read once. A backward is twice its forward's
products and twice its attention core (dX and dW of each product; dP, dV,
dQ and dK of the core), reading x and the output gradient, writing dx,
reading the weights and writing their gradients. Recompute is not work.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published dense peaks at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

BF16, FP32 = 2, 4


def _dims(config: dict) -> tuple:
    C = int(config["dim_feat"])
    return C, int(C * config["mlp_ratio"])


def pair_cost(config: dict, rows: int, frames: int, mode: str,
              gated: bool) -> tuple:
    """(FLOPs, bytes) of one pair's forward over ``rows`` clips of
    ``frames`` frames: LN -> qkv -> attention -> proj (+x) -> LN -> fc1 ->
    GELU -> fc2 (+y), the gated pair then the att_fuse gate."""
    C, hidden = _dims(config)
    J = int(config["num_joints"])
    M = rows * frames * J
    n = frames if mode == "temporal" else J
    w = 3 * C * C + C * C + 2 * C * hidden
    flops = 2 * M * w + 4 * M * n * C          # products; q.k^T and p.v
    nbytes = 2 * M * C * BF16                  # x in, out back
    nbytes += w * BF16 + (3 * C + C + hidden + C) * BF16 + 4 * C * FP32
    if gated:
        flops += 2 * M * 2 * C * 2
        nbytes += M * C * BF16 + 2 * 2 * C * BF16 + 2 * BF16
    return flops, nbytes


def pair_bwd_cost(config: dict, rows: int, frames: int, mode: str,
                  gated: bool) -> tuple:
    """(FLOPs, bytes) of one pair's backward: twice the forward's products
    and core; x and the output gradient in, dx out (and the twin stream's
    pair with the gate), the weights in and their gradients out."""
    C, hidden = _dims(config)
    J = int(config["num_joints"])
    M = rows * frames * J
    flops, _ = pair_cost(config, rows, frames, mode, gated)
    weights = ((3 * C * C + C * C + 2 * C * hidden) * BF16
               + (3 * C + C + hidden + C) * BF16 + 4 * C * FP32)
    nbytes = 3 * M * C * BF16 + 2 * weights
    if gated:
        nbytes += 2 * M * C * BF16 + 2 * (2 * 2 * C + 2) * BF16
    return 2 * flops, nbytes


def pairs(config: dict) -> list:
    """(mode, gated) of every pair of one forward, in order: per layer the
    S->T stream's spatial and temporal pairs, then the T->S stream's
    temporal pair and its spatial pair, which carries the gate."""
    return [("spatial", False), ("temporal", False), ("temporal", False),
            ("spatial", True)] * int(config["depth"])


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def forward_least_s(config: dict, rows: int, frames: int) -> float:
    """Least time of the pairs of one forward over ``rows`` clips."""
    return sum(least_s(*pair_cost(config, rows, frames, m, g))
               for m, g in pairs(config))


def train_step_least_s(config: dict, rows: int, frames: int) -> float:
    """Least time of the pairs of one training step: every pair's forward
    and backward."""
    return sum(least_s(*pair_cost(config, rows, frames, m, g))
               + least_s(*pair_bwd_cost(config, rows, frames, m, g))
               for m, g in pairs(config))


def model_forward_flops(config: dict, rows: int, frames: int) -> int:
    """FLOPs of one whole forward: the pairs, the joint embedding, the
    pre-logits and the head."""
    C, _ = _dims(config)
    M = rows * frames * int(config["num_joints"])
    rep = int(config["dim_rep"])
    flops = sum(pair_cost(config, rows, frames, m, g)[0]
                for m, g in pairs(config))
    return flops + 2 * M * (3 * C + C * rep + rep * 3)


def train_step_flops(config: dict, rows: int, frames: int) -> int:
    """Model FLOPs of one training step: three times the forward's."""
    return 3 * model_forward_flops(config, rows, frames)
