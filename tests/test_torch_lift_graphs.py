"""``MotionBERT.lift``'s CUDA graphs: the policy on the CPU (when a shape is
captured and replayed, when lifts stay eager, the cap and which shapes
keep a graph, a failed capture, the counts and the ``lift.forward`` span's
``graph`` argument), with the capture replaced by a stand-in; and, on the
card (``-m cuda``), replay against the eager step bit for bit on the
captured input and another, weights loaded in place, and a capture beside
a concurrent ``get_representation``.

This file imports neither jax nor the JAX package:

    python -m pytest tests/test_torch_lift_graphs.py -m cuda --noconftest -q
"""

import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from motionbert_tpu_torch import api
from motionbert_tpu_torch.api import MAX_LIFT_GRAPHS, MotionBERT
from motionbert_tpu_torch.core import profiling
from motionbert_tpu_torch.core.config import ConfigDict
from motionbert_tpu_torch.models.factory import load_backbone
from motionbert_tpu_torch.train.pose3d import make_eval_step

ROOT = Path(__file__).resolve().parents[1]
TINY = ConfigDict(dim_feat=32, dim_rep=32, depth=1, num_heads=2, mlp_ratio=2,
                  num_joints=17, maxlen=9)
NO_GRAPH = {"captures": 0, "replays": 0, "eager": 0, "failed_captures": 0,
            "evictions": 0}


def _clips(b, f=9, seed=0):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(-1, 1, (b, f, 17, 2))
    conf = rs.uniform(0.5, 1, (b, f, 17, 1))
    return np.concatenate([xy, conf], -1).astype(np.float32)


def _tiny():
    model = load_backbone(TINY, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return model.eval()


def _counts(**kw):
    return dict(NO_GRAPH, **kw)


def _want(x, flip_tta=True):
    """The eager step's answer on a fresh tiny model, root-relative."""
    step = make_eval_step(_tiny(), no_conf=False, flip_tta=flip_tta)
    out = step(torch.from_numpy(x)).numpy()
    out[:, :, 0, :] = 0
    return out


class FakeGraph:
    """What ``StepGraph`` holds, without a card: the static input and
    output, and a replay that runs the step again into the output. Reading
    ``out`` copies it, as its copy to the host does on the card."""

    def __init__(self, step, x):
        self.step, self.x = step, x.clone()
        self._out = step(self.x)
        self.graph = self

    @property
    def out(self):
        return self._out.clone()

    def replay(self):
        with torch.inference_mode():
            self._out.copy_(self.step(self.x))


def _as_on_card(monkeypatch):
    """MotionBERTs made from here on take the card's policy on the CPU."""
    init = MotionBERT.__init__

    def on_card_init(mb, *args, **kwargs):
        init(mb, *args, **kwargs)
        mb._on_card = True

    monkeypatch.setattr(MotionBERT, "__init__", on_card_init)


@pytest.fixture
def on_card(monkeypatch):
    """Lifts on the CPU take the card's policy; each capture is recorded
    (its shape) and made by ``FakeGraph``."""
    captured = []

    def capture(mb, step, x):
        captured.append(tuple(x.shape))
        return FakeGraph(step, x)

    _as_on_card(monkeypatch)
    monkeypatch.setattr(MotionBERT, "_capture", capture)
    return captured


def test_lifts_on_the_cpu_run_eager():
    mb = MotionBERT(_tiny(), maxlen=9)
    x = _clips(2)
    outs = [mb.lift(x) for _ in range(3)]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    assert mb.lift_counts == _counts(eager=3)
    assert mb._graphs == {}


@pytest.mark.parametrize("why", ["training", "tp_plan"])
def test_training_mode_and_a_tp_plan_stay_eager(why, on_card, monkeypatch):
    # the step is a stand-in: a block under a plan cannot run on the CPU
    monkeypatch.setattr(api, "make_eval_step",
                        lambda model, no_conf, flip_tta: lambda x: 2 * x)
    model = _tiny()
    if why == "training":
        model.train()
    else:
        model.blocks_ts[0].tp = object()
    mb = MotionBERT(model, maxlen=9)
    x = _clips(2)
    for _ in range(3):
        np.testing.assert_array_equal(mb.lift(x, rootrel=False), 2 * x)
    assert on_card == []
    assert mb.lift_counts == _counts(eager=3)


def test_a_shape_is_captured_on_its_second_call(on_card):
    mb = MotionBERT(_tiny(), maxlen=9)
    x, y = _clips(2), _clips(3, f=5, seed=1)
    want_x, want_y = _want(x), _want(y)
    np.testing.assert_array_equal(mb.lift(x), want_x)
    np.testing.assert_array_equal(mb.lift(y), want_y)
    assert on_card == [] and mb.lift_counts == _counts(eager=2)
    np.testing.assert_array_equal(mb.lift(x), want_x)      # captured
    assert on_card == [(2, 9, 17, 3)]
    for _ in range(2):
        np.testing.assert_array_equal(mb.lift(x), want_x)  # replayed
    assert on_card == [(2, 9, 17, 3)]
    assert mb.lift_counts == _counts(captures=1, replays=3, eager=2)
    np.testing.assert_array_equal(mb.lift(y), want_y)
    np.testing.assert_array_equal(mb.lift(x, flip_tta=False),
                                  _want(x, flip_tta=False))
    assert on_card == [(2, 9, 17, 3), (3, 5, 17, 3)]
    assert set(mb._graphs) == {((2, 9, 17, 3), True), ((3, 5, 17, 3), True)}
    assert mb.lift_counts == _counts(captures=2, replays=4, eager=3)


def test_replay_returns_each_call_its_own_answer(on_card):
    mb = MotionBERT(_tiny(), maxlen=9)
    a, b = _clips(2, seed=2), _clips(2, seed=3)
    got = [mb.lift(a), mb.lift(b), mb.lift(a), mb.lift(b)]
    assert mb.lift_counts == _counts(captures=1, replays=3, eager=1)
    for out, x in zip(got, (a, b, a, b)):
        np.testing.assert_array_equal(out, _want(x))
    assert not np.array_equal(got[2], got[3])


def test_shapes_beyond_the_cap_stay_eager(on_card):
    mb = MotionBERT(_tiny(), maxlen=9)
    shapes = [(b, 3) for b in range(1, MAX_LIFT_GRAPHS + 2)]
    for _ in range(3):
        for b, f in shapes:
            mb.lift(_clips(b, f))
    assert len(on_card) == len(mb._graphs) == MAX_LIFT_GRAPHS
    assert (MAX_LIFT_GRAPHS + 1, 3, 17, 3) not in on_card
    n = len(shapes)
    assert mb.lift_counts == _counts(
        captures=MAX_LIFT_GRAPHS, replays=2 * MAX_LIFT_GRAPHS,
        eager=3 * n - 2 * MAX_LIFT_GRAPHS)


def test_a_failed_capture_falls_back_to_eager_and_is_counted(monkeypatch):
    tries = []

    def capture(mb, step, x):
        tries.append(tuple(x.shape))
        raise RuntimeError("operation not permitted when stream is capturing")

    _as_on_card(monkeypatch)
    monkeypatch.setattr(MotionBERT, "_capture", capture)
    mb = MotionBERT(_tiny(), maxlen=9)
    x = _clips(2)
    want = _want(x)
    np.testing.assert_array_equal(mb.lift(x), want)
    with pytest.warns(RuntimeWarning, match="stays eager"):
        np.testing.assert_array_equal(mb.lift(x), want)
    for _ in range(2):
        np.testing.assert_array_equal(mb.lift(x), want)
    assert tries == [(2, 9, 17, 3)]             # not tried again
    assert mb.lift_counts == _counts(eager=4, failed_captures=1)


def test_a_shape_called_more_than_the_least_used_graph_takes_its_place(
        on_card):
    mb = MotionBERT(_tiny(), maxlen=9)
    kept = [_clips(b, 3) for b in range(1, MAX_LIFT_GRAPHS + 1)]
    for x in kept:                      # each captured on its second call
        mb.lift(x)
        mb.lift(x)
    for x in kept[1:]:                  # all but the first replayed again
        mb.lift(x)
    new = _clips(2, 4, seed=1)
    want = _want(new)
    for _ in range(2):                  # 2 calls: not more than 2 uses
        np.testing.assert_array_equal(mb.lift(new), want)
    assert len(on_card) == MAX_LIFT_GRAPHS
    np.testing.assert_array_equal(mb.lift(new), want)     # 3 calls
    assert on_card[-1] == (2, 4, 17, 3)
    assert set(mb._graphs) == {(tuple(x.shape), True)
                               for x in kept[1:] + [new]}
    assert mb.lift_counts == _counts(
        captures=MAX_LIFT_GRAPHS + 1, replays=2 * MAX_LIFT_GRAPHS,
        eager=MAX_LIFT_GRAPHS + 2, evictions=1)
    # the shape given up starts again from its first call
    np.testing.assert_array_equal(mb.lift(kept[0]), _want(kept[0]))
    assert mb._graph_calls == {((1, 3, 17, 3), True): 1}


def test_counts_age_so_the_graphs_follow_the_traffic(on_card, monkeypatch):
    monkeypatch.setattr(api, "MAX_LIFT_GRAPHS", 1)
    monkeypatch.setattr(api, "GRAPH_AGE_LIFTS", 4)
    mb = MotionBERT(_tiny(), maxlen=9)
    old, once, new = _clips(2, 3), _clips(1, 3, seed=1), _clips(3, 3, seed=2)
    mb.lift(once)
    for _ in range(20):
        mb.lift(old)
    # a shape seen once is forgotten when the counts age
    assert mb._graph_calls == {}
    assert on_card == [(2, 3, 17, 3)]
    # without ageing, old's 20 uses would hold its place for 20 more calls
    want = _want(new)
    lifts = 0
    while (tuple(new.shape), True) not in mb._graphs:
        np.testing.assert_array_equal(mb.lift(new), want)
        lifts += 1
        assert lifts < 20
    assert on_card == [(2, 3, 17, 3), (3, 3, 17, 3)]
    assert mb.lift_counts["evictions"] == 1
    np.testing.assert_array_equal(mb.lift(old), _want(old))


def test_lifts_from_many_threads_count_every_call(on_card):
    mb = MotionBERT(_tiny(), maxlen=9)
    xs = [_clips(2, seed=s) for s in range(3)] + [_clips(3, f=4, seed=3)]
    want = [_want(x) for x in xs]
    threads_n, rounds = 12, 6
    bad, old = [], sys.getswitchinterval()

    def run(t):
        for r in range(rounds):
            i = (t + r) % len(xs)
            if not np.array_equal(mb.lift(xs[i]), want[i]):
                bad.append((t, r))

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,))
                   for t in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and bad == []
    counts = mb.lift_counts
    assert counts["replays"] + counts["eager"] == threads_n * rounds
    assert counts["captures"] == len(on_card) == 2
    assert counts["failed_captures"] == 0


def test_the_forward_span_says_whether_it_replayed(on_card):
    profiling.reset()
    mb = MotionBERT(_tiny(), maxlen=9)
    x = _clips(2)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            mb.lift(x)
    rec = profiling.recorded()
    profiling.reset()
    names = [s["name"] for s in rec["spans"]]
    assert names == ["lift.h2d", "lift.forward", "lift.d2h"] * 3
    fwd = [d["args"] for d in rec["device"] if d["name"] == "lift.forward"]
    assert fwd == [{"rows": 2, "graph": 0}, {"rows": 2, "graph": 1},
                   {"rows": 2, "graph": 1}]
    assert mb.lift_counts == _counts(captures=1, replays=2, eager=1)


# -- on the card ------------------------------------------------------------------

CONFIGS = ("motionbert_lite", "motionbert")
BUCKETS = (1, 8, 32, 128)


@pytest.fixture(scope="module")
def card_lifters():
    """A MotionBERT a benchmark configuration, on the card with the kernel
    tier and the benchmark's seeded weights, made at first use."""
    made = {}

    def get(name):
        if name not in made:
            if not torch.cuda.is_available():
                pytest.skip("needs a CUDA device")
            from benchmark.reference.dstformer import draw_weights

            cfg = json.loads((ROOT / "benchmark" / "configs"
                              / f"{name}.json").read_text())["config"]
            dev = torch.device("cuda", 0)
            model = load_backbone(cfg, device=dev, attn_impl="kernel")
            model.load_state_dict(draw_weights(cfg, 24, dev))
            made[name] = (MotionBERT(model.eval(), maxlen=243), cfg)
        return made[name]

    yield get
    made.clear()
    torch.cuda.empty_cache()


def _eager(mb, x, flip_tta=True):
    step = make_eval_step(mb.model, no_conf=False, flip_tta=flip_tta)
    return step(torch.from_numpy(x).to(mb.device)).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("config", CONFIGS)
def test_replay_is_the_eager_step_bit_for_bit(card_lifters, config, bucket):
    mb, _ = card_lifters(config)
    x, y = (_clips(bucket, 243, seed=s) for s in (bucket, 1000 + bucket))
    want, want_y = _eager(mb, x), _eager(mb, y)
    before = dict(mb.lift_counts)
    got = [mb.lift(x, rootrel=False) for _ in range(3)]
    # another input of the captured shape: the graph reads its static
    # input anew, and bakes in nothing of the input it was captured on
    got_y = mb.lift(y, rootrel=False)
    delta = {k: mb.lift_counts[k] - before[k] for k in before}
    assert delta == _counts(captures=1, replays=3, eager=1)
    assert np.isfinite(want).all()
    for out in got:
        np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(got_y, want_y)
    assert not np.array_equal(got_y, want)


@pytest.mark.cuda
def test_replays_in_any_order_after_every_capture(card_lifters):
    # the graphs share one memory pool: each replay rewrites what another's
    # output may occupy, and each output is read before the next replay
    mb, _ = card_lifters("motionbert_lite")
    xs = {b: _clips(b, 243, seed=100 + b) for b in BUCKETS}
    want = {b: _eager(mb, x) for b, x in xs.items()}
    for b, x in xs.items():
        for _ in range(2):
            mb.lift(x, rootrel=False)
    replays = mb.lift_counts["replays"]
    order = (128, 1, 32, 8, 1, 128, 8, 32)
    for b in order:
        np.testing.assert_array_equal(mb.lift(xs[b], rootrel=False), want[b])
    assert mb.lift_counts["replays"] == replays + len(order)


@pytest.mark.cuda
def test_a_graph_given_up_for_another_shape_on_the_card(card_lifters,
                                                        monkeypatch):
    # the new shape's capture reuses the pool the given-up graph left; the
    # graph kept and the new one replay bit for bit the eager step
    monkeypatch.setattr(api, "MAX_LIFT_GRAPHS", 2)
    lite, _ = card_lifters("motionbert_lite")
    mb = MotionBERT(lite.model, maxlen=243)
    a, b, c = (_clips(4, f, seed=f) for f in (27, 81, 243))
    want = {id(x): _eager(mb, x) for x in (a, b, c)}
    for x in (a, a, b, b, b, c, c, c, c):
        np.testing.assert_array_equal(mb.lift(x, rootrel=False), want[id(x)])
    assert set(mb._graphs) == {((4, 81, 17, 3), True), ((4, 243, 17, 3), True)}
    assert mb.lift_counts == _counts(captures=3, replays=5, eager=4,
                                     evictions=1)
    for x in (c, b, a, c, b):
        np.testing.assert_array_equal(mb.lift(x, rootrel=False), want[id(x)])


@pytest.mark.cuda
def test_replay_follows_weights_loaded_in_place(card_lifters):
    from benchmark.reference.dstformer import draw_weights

    mb, cfg = card_lifters("motionbert_lite")
    x = _clips(8, 243, seed=5)
    for _ in range(3):
        mb.lift(x, rootrel=False)
    captures = mb.lift_counts["captures"]
    old = {k: v.clone() for k, v in mb.model.state_dict().items()}
    try:
        mb.model.load_state_dict(draw_weights(cfg, 25, mb.device))
        want = _eager(mb, x)
        got = mb.lift(x, rootrel=False)
        assert mb.lift_counts["captures"] == captures
        np.testing.assert_array_equal(got, want)
    finally:
        mb.model.load_state_dict(old)
    np.testing.assert_array_equal(mb.lift(x, rootrel=False), _eager(mb, x))


@pytest.mark.cuda
def test_a_capture_beside_a_concurrent_representation(card_lifters):
    mb, _ = card_lifters("motionbert_lite")
    x, r = _clips(8, 81, seed=6), _clips(8, 243, seed=7)
    want_lift, want_rep = _eager(mb, x), mb.get_representation(r)
    mb.lift(x, rootrel=False)                   # first call: eager
    done, reps, errors = threading.Event(), [], []

    def represent():
        try:
            while not done.is_set() or not reps:
                reps.append(mb.get_representation(r))
        except Exception as e:                  # reported below
            errors.append(e)

    t = threading.Thread(target=represent)
    before = mb.lift_counts["captures"]
    t.start()
    try:
        got = [mb.lift(x, rootrel=False) for _ in range(2)]
    finally:
        done.set()
        t.join(timeout=300)
    assert not errors and not t.is_alive()
    assert mb.lift_counts["captures"] == before + 1
    assert mb.lift_counts["failed_captures"] == 0
    for out in got:
        np.testing.assert_array_equal(out, want_lift)
    for rep in reps:
        np.testing.assert_array_equal(rep, want_rep)


@pytest.mark.cuda
def test_a_capture_that_syncs_stays_eager_on_the_card(card_lifters,
                                                      monkeypatch):
    mb, _ = card_lifters("motionbert_lite")
    real = make_eval_step(mb.model, no_conf=False, flip_tta=False)

    def syncing(x):
        out = real(x)
        float(out.sum())        # a host read: not allowed while capturing
        return out

    x = _clips(2, 27, seed=8)
    want = _eager(mb, x, flip_tta=False)
    mb._lift_steps[False] = syncing
    try:
        before = dict(mb.lift_counts)
        with pytest.warns(RuntimeWarning, match="stays eager"):
            for _ in range(3):
                np.testing.assert_array_equal(
                    mb.lift(x, flip_tta=False, rootrel=False), want)
        delta = {k: mb.lift_counts[k] - before[k] for k in before}
        assert delta == _counts(eager=3, failed_captures=1)
        # the card is sound after the failed capture: a shape after it is
        # captured and replayed as usual
        y = _clips(2, 30, seed=9)
        want_y = _eager(mb, y)
        before = dict(mb.lift_counts)
        for _ in range(3):
            np.testing.assert_array_equal(mb.lift(y, rootrel=False), want_y)
        delta = {k: mb.lift_counts[k] - before[k] for k in before}
        assert delta == _counts(captures=1, replays=2, eager=1)
    finally:
        del mb._lift_steps[False]
