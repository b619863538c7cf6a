"""The plain pose3d task around the plain DSTformer: the H36M-17 flip, the
finetune loss, AdamW and the flip-averaged lift, in float32 PyTorch.

Written from the published recipe (MotionBERT's train.py and loss.py, the
configuration's ``lambda_*`` weights) and independent of the program under
test: it imports nothing of it and takes none of its state.

    loss = mpjpe + lambda_scale * n_mpjpe + lambda_3d_velocity * velocity
           (+ the limb and angle terms, at their weights; the finetune
              configurations set those to 0 and this file leaves them out)
    AdamW: betas (0.9, 0.999), eps 1e-8, decoupled decay p <- p (1 - lr wd)
    lift:  (f(x) + flip(f(flip(x)))) / 2, the root joint set to 0 with
           rootrel
"""

from __future__ import annotations

import contextlib

import torch

# left/right joint pairs of H36M-17 (hips, knees, ankles, shoulders,
# elbows, wrists)
_LEFT = (4, 5, 6, 11, 12, 13)
_RIGHT = (1, 2, 3, 14, 15, 16)
FLIP_PERM = list(range(17))
for _l, _r in zip(_LEFT, _RIGHT):
    FLIP_PERM[_l], FLIP_PERM[_r] = _r, _l

ZERO_LAMBDAS = ("lambda_lv", "lambda_lg", "lambda_a", "lambda_av")


@contextlib.contextmanager
def full_fp32():
    """float32 products everywhere: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def flip(x: torch.Tensor) -> torch.Tensor:
    """Mirror (..., 17, D) data: negate x and swap the left and right
    joints."""
    x = torch.cat([-x[..., :1], x[..., 1:]], dim=-1)
    return x[..., FLIP_PERM, :]


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def loss_terms(pred: torch.Tensor, gt: torch.Tensor) -> dict:
    """The weighted terms of the finetune loss, each a full mean."""
    pos = _norm(pred - gt).mean()
    scale = ((gt * pred).sum(3, keepdim=True).mean(2, keepdim=True)
             / (pred ** 2).sum(3, keepdim=True).mean(2, keepdim=True))
    n_pos = _norm(scale * pred - gt).mean()
    vel = _norm((pred[:, 1:] - pred[:, :-1])
                - (gt[:, 1:] - gt[:, :-1])).mean()
    return {"3d_pos": pos, "3d_scale": n_pos, "3d_velocity": vel}


def total_loss(pred: torch.Tensor, gt: torch.Tensor, config: dict):
    for k in ZERO_LAMBDAS:
        if config.get(k, 0.0):
            raise ValueError(f"{k} is not 0: this reference leaves its term "
                             f"out")
    t = loss_terms(pred, gt)
    return (t["3d_pos"] + config["lambda_scale"] * t["3d_scale"]
            + config["lambda_3d_velocity"] * t["3d_velocity"])


def condition(x: torch.Tensor, gt: torch.Tensor, config: dict) -> tuple:
    """The input and target as the finetune step sees them: root-relative
    targets with rootrel, else the first frame's root depth taken off."""
    if config.get("no_conf", False):
        x = x[..., :2]
    if config["rootrel"]:
        gt = gt - gt[:, :, 0:1, :]
    else:
        gt = torch.cat([gt[..., :2], gt[..., 2:3] - gt[:, 0:1, 0:1, 2:3]], -1)
    return x, gt


class AdamW:
    """torch's AdamW arithmetic written out: m, v, bias corrections, and
    the decoupled decay applied before the update."""

    def __init__(self, params: list, lr: float, weight_decay: float):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: list) -> None:
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - self.lr * self.wd)
            denom = (v.sqrt() / c2 ** 0.5).add_(eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)


def train_steps(model, batches: list, flips: list, config: dict,
                chunk: int) -> dict:
    """Run len(batches) AdamW steps of the finetune recipe on ``model``.

    batches: [(x, gt), ...] on the model's device; flips: per step a (B,)
    bool tensor, True where the clip and its label are mirrored. The batch
    is run ``chunk`` clips at a time and the gradients summed with the
    chunk's share of the mean, which is the whole batch's gradient since
    every term is a mean over clips of equal size. Returns {"loss": [per
    step], "grad1": [first step's gradient per parameter], "delta":
    [parameter change after the steps]}."""
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    opt = AdamW(params, config["learning_rate"], config["weight_decay"])
    losses, grad1 = [], None
    model.train()
    with full_fp32():
        for (x, gt), fl in zip(batches, flips):
            f = fl.view(-1, 1, 1, 1)
            x = torch.where(f, flip(x), x)
            gt = torch.where(f, flip(gt), gt)
            x, gt = condition(x, gt, config)
            B = x.shape[0]
            grads = [torch.zeros_like(p) for p in params]
            total = 0.0
            for s in range(0, B, chunk):
                xs, gs = x[s:s + chunk], gt[s:s + chunk]
                loss = total_loss(model(xs), gs, config)
                share = xs.shape[0] / B
                g = torch.autograd.grad(loss * share, params)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                total += float(loss.detach()) * share
            losses.append(total)
            if grad1 is None:
                grad1 = [g.clone() for g in grads]
            opt.step(grads)
    delta = [(p.detach() - s) for p, s in zip(params, start)]
    return {"loss": losses, "grad1": grad1, "delta": delta,
            "names": [n for n, _ in model.named_parameters()]}


@torch.no_grad()
def lift(model, x: torch.Tensor, rootrel: bool, chunk: int,
         dtype=torch.float32) -> torch.Tensor:
    """Flip-averaged 3D poses of (N, F, 17, 3) clips, ``chunk`` at a time,
    in float32; with ``dtype`` bfloat16 under PyTorch's autocast, the plain
    bf16 yardstick that a serving cell's error is measured against."""
    model.eval()
    outs = []
    low = dtype != torch.float32
    with full_fp32(), torch.autocast(x.device.type, dtype=dtype,
                                     enabled=low):
        for s in range(0, x.shape[0], chunk):
            xs = x[s:s + chunk]
            pred = ((model(xs).float() + flip(model(flip(xs)).float())) / 2)
            if rootrel:
                pred[:, :, 0, :] = 0
            outs.append(pred)
    return torch.cat(outs)
