"""The plain reference against the program's plain path on the CPU, at a
tiny size: the same forward, the same flip-averaged lift and the same
three finetune steps, in float32. (Tests may import the program; the
reference itself may not.)"""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.compare import train_readings
from benchmark.reference import dstformer, pose3d

TINY = dict(dim_feat=64, dim_rep=32, depth=2, num_heads=2, mlp_ratio=2,
            num_joints=17, maxlen=27, rootrel=True, learning_rate=2e-4,
            weight_decay=0.01, lambda_scale=0.5, lambda_3d_velocity=20.0,
            lambda_lv=0.0, lambda_lg=0.0, lambda_a=0.0, lambda_av=0.0,
            flip=True, no_conf=False)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _program(cfg, seed):
    from motionbert_tpu_torch.models.factory import load_backbone

    model = load_backbone(cfg, device="cpu", attn_impl="plain")
    model.load_state_dict(dstformer.draw_weights(cfg, seed, "cpu"))
    return model


def _reference(cfg, seed):
    model = dstformer.build(cfg, "cpu")
    model.load_state_dict(dstformer.draw_weights(cfg, seed, "cpu"))
    return model


def test_names_and_shapes_match_the_program():
    from motionbert_tpu_torch.models.factory import load_backbone

    prog = load_backbone(TINY, device="cpu", attn_impl="plain")
    assert [(n, tuple(p.shape)) for n, p in prog.named_parameters()] == \
        dstformer.parameter_shapes(TINY)


def test_weights_come_from_the_seed():
    a = dstformer.draw_weights(TINY, 5, "cpu")
    b = dstformer.draw_weights(TINY, 5, "cpu")
    c = dstformer.draw_weights(TINY, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.weight"], c["head.weight"])


@pytest.mark.parametrize("rootrel", [True, False])
def test_forward_and_lift_match_the_program(rootrel):
    from motionbert_tpu_torch.api import MotionBERT

    x = torch.from_numpy(inputs.clip_pool(1, 3, 27)[0])
    prog, ref = _program(TINY, 3), _reference(TINY, 3)
    with torch.no_grad():
        torch.testing.assert_close(prog(x), ref(x), rtol=1e-5, atol=1e-5)
    got = MotionBERT(prog, maxlen=27).lift(x.numpy(), flip_tta=True,
                                          rootrel=rootrel)
    want = pose3d.lift(ref, x, rootrel, chunk=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_adamw_is_torchs():
    p = torch.randn(7, 3)
    q = p.clone().requires_grad_(True)
    opt = torch.optim.AdamW([q], lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    mine = pose3d.AdamW([p], 1e-2, 0.01)
    for s in range(3):
        g = torch.randn(7, 3, generator=torch.Generator().manual_seed(s))
        q.grad = g.clone()
        opt.step()
        mine.step([g])
    torch.testing.assert_close(p, q.detach(), rtol=1e-6, atol=1e-7)


def test_three_train_steps_match_the_program():
    from motionbert_tpu_torch.losses.pose import LAMBDA_KEYS
    from motionbert_tpu_torch.train.pose3d import make_train_step
    from motionbert_tpu_torch.train.state import make_adamw

    x2d, x3d = inputs.clip_pool(2, 12, 27)
    batches = [(torch.from_numpy(x2d[i:i + 4]), torch.from_numpy(x3d[i:i + 4]))
               for i in (0, 4, 8)]
    prog = _program(TINY, 4)
    start = {n: p.detach().clone() for n, p in prog.named_parameters()}
    opt = make_adamw(prog.parameters(), TINY["learning_rate"],
                     TINY["weight_decay"])
    step = make_train_step(prog, opt, {k: TINY[k] for k in LAMBDA_KEYS},
                           rootrel=True, no_conf=False, flip_aug=True,
                           generator=torch.Generator().manual_seed(9))
    losses, grad = [], None
    for i, (x, y) in enumerate(batches):
        losses.append(float(step(x, y)["total"]))
        if i == 0:
            grad = {n: float(opt.state[p]["exp_avg"].norm()) / 0.1
                    for n, p in prog.named_parameters()}
    delta = {n: p.detach() - start[n] for n, p in prog.named_parameters()}
    gen = torch.Generator().manual_seed(9)
    flips = [torch.rand((4, 1, 1, 1), generator=gen).view(-1) < 0.5
             for _ in batches]
    assert any(f.any() for f in flips) and not all(f.all() for f in flips)
    out = pose3d.train_steps(_reference(TINY, 4), batches, flips, TINY,
                             chunk=3)
    np.testing.assert_allclose(losses, out["loss"], rtol=1e-5)
    r = train_readings({"loss": losses, "grad_norm": grad, "delta": delta},
                       out)
    assert r["loss_gap"] < 1e-5 and r["grad_norm_gap"] < 1e-4
    assert r["grad_norm_gap_median"] <= r["grad_norm_gap"]
    assert r["update_norm_gap"] < 1e-3 and r["_left_out"] == []


def test_chunked_gradient_is_the_whole_batch_gradient():
    x2d, x3d = inputs.clip_pool(3, 4, 27)
    batch = [(torch.from_numpy(x2d), torch.from_numpy(x3d))]
    flips = [torch.tensor([True, False, False, True])]
    whole = pose3d.train_steps(_reference(TINY, 1), batch, flips, TINY, 4)
    parts = pose3d.train_steps(_reference(TINY, 1), batch, flips, TINY, 1)
    assert whole["loss"][0] == pytest.approx(parts["loss"][0], rel=1e-6)
    for a, b in zip(whole["grad1"], parts["grad1"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
