"""Supervised contrastive loss (Khosla et al. 2020), the one-shot action
task's training loss.

The port of ``motionbert_tpu/losses/supcon.py`` (reference
lib/model/loss_supcon.py:11-98, the 'all' contrast mode that
train_action_1shot.py uses), in PyTorch, differentiable by autograd.
"""

from __future__ import annotations

import torch


def supcon_loss(features: torch.Tensor, labels: torch.Tensor = None,
                mask: torch.Tensor = None, temperature: float = 0.07,
                base_temperature: float = 0.07) -> torch.Tensor:
    """features: (bsz, n_views, d) L2-normalised embeddings; labels (bsz,)
    ints: positives are the other views of the same label. With neither
    labels nor mask it is SimCLR (the views of one sample). An anchor with
    no positive (one view, a label alone in the batch) contributes 0, as in
    the JAX package, where the reference divides 0 by 0. Returns a 0-d
    tensor in the features' dtype."""
    if features.dim() < 3:
        raise ValueError("`features` needs to be [bsz, n_views, ...]")
    if features.dim() > 3:
        features = features.reshape(features.shape[0], features.shape[1], -1)
    bsz, n_views = features.shape[:2]
    dev = features.device
    if labels is not None and mask is not None:
        raise ValueError("Cannot define both `labels` and `mask`")
    if labels is None and mask is None:
        mask = torch.eye(bsz, dtype=torch.float32, device=dev)
    elif labels is not None:
        labels = labels.reshape(-1, 1).to(dev)
        mask = (labels == labels.t()).float()
    else:
        mask = mask.float()

    # the views stacked along the batch (torch.cat(torch.unbind(f, 1)))
    contrast = torch.cat(torch.unbind(features, dim=1), dim=0)
    logits = torch.matmul(contrast, contrast.t()) / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()

    mask = mask.repeat(n_views, n_views)
    n = bsz * n_views
    logits_mask = 1.0 - torch.eye(n, dtype=torch.float32, device=dev)
    mask = mask * logits_mask
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True))
    mean_log_prob_pos = (mask * log_prob).sum(dim=1) \
        / mask.sum(dim=1).clamp_min(1.0)
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return loss.reshape(n_views, bsz).mean()
