"""Action recognition heads and ActionNet, the backbone with a head.

The port of ``motionbert_tpu/models/action_heads.py`` (reference
lib/model/model_action.py). Input is a two-person skeleton clip (N, M=2, T,
J, 3): the backbone runs on the flattened (N*M) batch and returns its
motion representation (``return_rep=True``), in the backbone's compute
dtype (bf16 on the card, through the pair kernels); the head then runs in
fp32, as the JAX heads keep ``dtype=float32``. It pools over time, flattens
the joints, averages the two persons, and classifies (fc1 -> BatchNorm ->
ReLU -> fc2) or embeds (fc1 -> L2 normalisation) for the one-shot task's
metric learning. The head's dropout draws from the ``torch.Generator``
passed to ``forward``, as the backbone's masks do. Under tensor parallelism
(``parallel.mesh.shard_params``) the heads follow the JAX package's rules:
fc1 column-parallel, the classifier's fc2 row-parallel, the embedding's
slices gathered over the model ranks before the normalisation; the pooled
feature and its dropout mask are the same on every model rank.

Parameter and buffer names are the reference's (``backbone.*``,
``head.fc1``, ``head.bn`` with ``running_mean``, ``running_var`` and
``num_batches_tracked``, ``head.fc2``), so reference checkpoints load with
``strict=True``. A JAX ActionNet has no ``backbone.head`` parameters (the
backbone's output head is never called under ``return_rep``), so its
converted state_dict lacks those two keys and nothing else.
"""

from __future__ import annotations

import torch
from torch import nn

from motionbert_tpu_torch.geometry.rotations import f_normalize
from motionbert_tpu_torch.models.dstformer import DSTformer, dropout
from motionbert_tpu_torch.parallel.mesh import data_size, sum_over_data
from motionbert_tpu_torch.parallel.tensor import (
    WHOLE_HEAD, copy_to_model, gather_from_model, reduce_from_model)


class BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over (N, features) that follows the JAX package's
    ``nn.BatchNorm(momentum=0.9)`` (flax, eps 1e-5): fp32 statistics with
    var = max(E[x^2] - E[x]^2, 0), and a running variance that takes this
    BIASED batch variance, where torch's BatchNorm1d stores the unbiased one
    (at batch 32 the two drift apart by 1/31 per update). Running averages
    move by 0.1 (torch's momentum, flax's 1 - 0.9). The buffers keep torch's
    names, so reference checkpoints load strictly.

    Under data parallelism the statistics are the global batch's, as the JAX
    package's sharded step takes them: the fp32 sums of x and x^2 over the
    rank's rows are summed over the data ranks by a differentiable
    all-reduce (``parallel.mesh.sum_over_data``), so every rank normalises
    alike and keeps the same running averages. ``nn.SyncBatchNorm`` would
    store the unbiased variance. Under tensor parallelism the BatchNorm
    after a column-parallel fc1 holds the rank's slice of the features
    (weight, bias and running averages, cut by ``parallel.mesh.
    shard_params`` and gathered whole by ``state_dict()``), and its sums go
    over the data group only: each model rank's slice is then the 1 x 1
    run's."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            if data_size() == 1:
                mean, sq = xf.mean(0), (xf * xf).mean(0)
            else:
                sums = sum_over_data(torch.stack([xf.sum(0),
                                                  (xf * xf).sum(0)]))
                mean, sq = sums / (xf.shape[0] * data_size())
            var = (sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def _pool_feat(feat: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """(N, M, T, J, C) -> (N, J*C): dropout, mean over time, joints
    flattened, mean over the persons (reference model_action.py:19-24)."""
    N, M, T, J, C = feat.shape
    feat = dropout(feat, rate, generator)
    return feat.mean(2).reshape(N, M, J * C).mean(1)


def column_parallel(x: torch.Tensor, layer: nn.Linear, group) -> torch.Tensor:
    """``layer(x)``; with a model group, the layer's rows are the rank's
    output features and x (replicated) goes through ``copy_to_model``, so
    its gradient is summed over the model ranks."""
    if group is None:
        return layer(x)
    return nn.functional.linear(copy_to_model(x, group), layer.weight,
                                layer.bias)


def row_parallel(x: torch.Tensor, layer: nn.Linear, group) -> torch.Tensor:
    """``layer(x)``; with a model group, x and the layer's columns are the
    rank's input features: the fp32 partial product is summed over the
    model ranks (``reduce_from_model``) and the bias added once after."""
    if group is None:
        return layer(x)
    return reduce_from_model(torch.matmul(x, layer.weight.t()), group) \
        + layer.bias


class ActionHeadClassification(nn.Module):
    """fc1 -> BatchNorm -> ReLU -> fc2. Under tensor parallelism (``tp``, a
    ``parallel.tensor.HeadPlan``) fc1 is column-parallel, the BatchNorm and
    the ReLU run on the rank's hidden slice, and fc2 is row-parallel."""

    def __init__(self, dropout_ratio: float = 0.0, dim_rep: int = 512,
                 num_classes: int = 60, num_joints: int = 17,
                 hidden_dim: int = 2048):
        super().__init__()
        self.dropout_ratio = float(dropout_ratio)
        self.fc1 = nn.Linear(dim_rep * num_joints, hidden_dim)
        self.bn = BatchNorm1d(hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, num_classes)
        self.tp = None

    def forward(self, feat: torch.Tensor, generator=None) -> torch.Tensor:
        feat = _pool_feat(feat, self.dropout_ratio, generator)
        tp = self.tp or WHOLE_HEAD
        hid = torch.relu(self.bn(column_parallel(feat, self.fc1, tp.fc1)))
        return row_parallel(hid, self.fc2, tp.fc2)


class ActionHeadEmbed(nn.Module):
    """fc1 -> L2 normalisation; under tensor parallelism fc1 is
    column-parallel and its slices are gathered before the
    normalisation."""

    def __init__(self, dropout_ratio: float = 0.0, dim_rep: int = 512,
                 num_joints: int = 17, hidden_dim: int = 2048):
        super().__init__()
        self.dropout_ratio = float(dropout_ratio)
        self.fc1 = nn.Linear(dim_rep * num_joints, hidden_dim)
        self.tp = None

    def forward(self, feat: torch.Tensor, generator=None) -> torch.Tensor:
        feat = _pool_feat(feat, self.dropout_ratio, generator)
        tp = self.tp or WHOLE_HEAD
        emb = column_parallel(feat, self.fc1, tp.fc1)
        return f_normalize(gather_from_model(emb, tp.fc1, tp.n_model,
                                             tp.index))


class ActionNet(nn.Module):
    """Backbone + action head (reference model_action.py:50-71). version
    "class" gives (N, num_classes) logits, "embed" (N, hidden_dim) unit
    embeddings; both fp32."""

    def __init__(self, backbone: DSTformer, dim_rep: int = 512,
                 num_classes: int = 60, dropout_ratio: float = 0.0,
                 version: str = "class", hidden_dim: int = 2048,
                 num_joints: int = 17):
        super().__init__()
        self.backbone = backbone
        self.version = version
        if version == "class":
            self.head = ActionHeadClassification(
                dropout_ratio, dim_rep, num_classes, num_joints, hidden_dim)
        elif version == "embed":
            self.head = ActionHeadEmbed(dropout_ratio, dim_rep, num_joints,
                                        hidden_dim)
        else:
            raise ValueError(f"Version Error: {version}")

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ActionNet":
        """The backbone's reference initialisation, and flax's defaults for
        the head (the JAX heads' Dense layers: LeCun-normal weights truncated
        at 2 std, zero biases; BatchNorm scale 1, bias 0, unit running
        variance). Drawn on the CPU from ``generator``."""
        self.backbone.init_weights(generator)
        for m in self.head.modules():
            if isinstance(m, nn.Linear):
                std = m.in_features ** -0.5 / 0.87962566103423978
                cpu = torch.empty(m.weight.shape)
                m.weight.copy_(nn.init.trunc_normal_(
                    cpu, std=std, a=-2 * std, b=2 * std, generator=generator))
                nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm1d):
                m.reset_parameters()
        return self

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """x (N, M, T, J, C). generator: the source of every dropout and
        drop-path mask, read only in training mode with gradients enabled;
        needed then when a rate is above 0."""
        live = self.training and torch.is_grad_enabled()
        if live and generator is None and self.head.dropout_ratio > 0:
            raise ValueError("training with the head's dropout needs "
                             "forward(generator=...)")
        if not live:
            generator = None
        N, M, T, J, C = x.shape
        feat = self.backbone(x.reshape(N * M, T, J, C), return_rep=True,
                             generator=generator)
        feat = feat.reshape(N, M, T, J, -1).float()
        return self.head(feat, generator)
