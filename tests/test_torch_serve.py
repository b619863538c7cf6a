"""The port's batching server (motionbert_tpu_torch.serve) on the CPU: the
behaviour tests/test_serve.py expects of the JAX package's server, and
MotionBERTServer answers equal to the port's direct lift."""

import threading

import numpy as np
import pytest

from motionbert_tpu_torch.api import MotionBERT
from motionbert_tpu_torch.core.config import ConfigDict
from motionbert_tpu_torch.infer.batching import run_batched
from motionbert_tpu_torch.models.factory import load_backbone
from motionbert_tpu_torch.serve import BatchingServer, MotionBERTServer


def _echo_fn(batch):
    return batch * 2.0 + 1.0


def _tiny_mb():
    import torch

    cfg = ConfigDict(dim_feat=32, dim_rep=32, depth=1, num_heads=2,
                     mlp_ratio=2, num_joints=17, maxlen=27)
    model = load_backbone(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():  # a non-trivial gate, so both streams matter
        for lin in model.ts_attn:
            lin.weight.normal_(0, 0.1, generator=torch.Generator()
                               .manual_seed(1))
    return MotionBERT(model, maxlen=27)


def test_results_match_direct_calls():
    rs = np.random.RandomState(0)
    clips = [rs.randn(9, 17, 3).astype(np.float32) for _ in range(40)]
    with BatchingServer(_echo_fn, batch_buckets=(1, 8), max_wait_ms=20) as s:
        futs = [s.submit(c) for c in clips]
        for c, f in zip(clips, futs):
            np.testing.assert_allclose(f.result(timeout=10),
                                       _echo_fn(c[None])[0])


def test_mixed_lengths_grouped_by_length():
    seen = []

    def fn(batch):
        seen.append(batch.shape)
        return batch

    clips = [np.full((9, 2, 2), 1.0, np.float32),
             np.full((27, 2, 2), 2.0, np.float32)] * 5
    with BatchingServer(fn, batch_buckets=(1, 8, 16), max_wait_ms=50) as s:
        futs = [s.submit(c) for c in clips]
        for c, f in zip(clips, futs):
            np.testing.assert_array_equal(f.result(timeout=10), c)
    assert all(shape[1] in (9, 27) for shape in seen)


def test_cancelled_future_does_not_poison_round():
    done = threading.Event()

    def fn(x):
        done.wait(timeout=10)
        return np.asarray(x)

    clip = np.ones((4, 3), np.float32)
    with BatchingServer(fn, batch_buckets=(1, 4), max_wait_ms=30) as srv:
        futs = [srv.submit(clip) for _ in range(4)]
        assert futs[0].cancel()
        done.set()
        for f in futs[1:]:
            np.testing.assert_allclose(f.result(timeout=30), clip)
        np.testing.assert_allclose(srv.submit(clip).result(timeout=30), clip)


def test_exception_propagates_to_all_callers():
    def boom(batch):
        raise ValueError("device on fire")

    with BatchingServer(boom, batch_buckets=(1, 8), max_wait_ms=20) as s:
        futs = [s.submit(np.zeros((5, 3), np.float32)) for _ in range(4)]
        for f in futs:
            with pytest.raises(ValueError, match="device on fire"):
                f.result(timeout=10)


def test_shutdown_rejects_new_work_and_drains():
    s = BatchingServer(_echo_fn, batch_buckets=(1, 8), max_wait_ms=5)
    fut = s.submit(np.ones((5, 3), np.float32))
    s.shutdown()
    np.testing.assert_allclose(fut.result(timeout=10), 3.0)
    with pytest.raises(RuntimeError):
        s.submit(np.ones((5, 3), np.float32))


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_shutdown_fails_undrained_futures():
    srv = BatchingServer(lambda x: np.asarray(x), batch_buckets=(1, 4),
                         max_wait_ms=5)
    clip = np.ones((4, 3), np.float32)
    srv.submit(clip).result(timeout=30)

    def boom():
        raise RuntimeError("collector killed (test)")

    srv._collect = boom
    srv.submit(clip).result(timeout=30)
    srv._worker.join(timeout=30)
    assert not srv._worker.is_alive()
    orphan = srv.submit(clip)
    srv.shutdown()
    with pytest.raises(RuntimeError, match="before this request"):
        orphan.result(timeout=5)
    with pytest.raises(RuntimeError):
        srv.submit(clip)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_submit_fails_when_queue_full_and_collector_dead():
    """A full queue behind a dead collector is never drained: submit raises
    instead of waiting forever."""
    srv = BatchingServer(lambda x: np.asarray(x), batch_buckets=(1,),
                         max_wait_ms=1, max_queue=1)
    clip = np.ones((4, 3), np.float32)

    def boom():
        raise RuntimeError("collector killed (test)")

    srv._collect = boom
    srv.submit(clip).result(timeout=30)
    srv._worker.join(timeout=30)
    assert not srv._worker.is_alive()
    srv.submit(clip)  # fills the queue
    with pytest.raises(RuntimeError, match="not running"):
        srv.submit(clip)
    srv.shutdown()


@pytest.mark.parametrize("buckets,n,plan", [
    ((1, 8, 48), 44, [(44, 48)]),
    ((1, 8, 16, 32, 64, 96, 192), 105, [(96, 96), (8, 8), (1, 1)]),
    ((1, 8, 16, 32, 64, 96, 192), 200, [(192, 192), (8, 8)]),
])
def test_plan_chunks_as_jax_package(buckets, n, plan):
    s = BatchingServer.__new__(BatchingServer)
    s._plan_memo, s._buckets = {}, tuple(buckets)
    assert s._plan_chunks(n) == plan


def test_run_batched_preserves_order():
    rs = np.random.RandomState(1)
    clips = [rs.randn(t, 17, 3).astype(np.float32) for t in (9, 5, 9, 9, 5)]
    outs = run_batched(clips, 2, _echo_fn)
    for c, o in zip(clips, outs):
        np.testing.assert_allclose(o, _echo_fn(c))


def test_motionbert_server_matches_direct_lift_and_rep():
    """Concurrent clients with mixed lengths get exactly api.MotionBERT's
    lift and representation (fp32 on the CPU; rows of a batch are
    independent, so batching changes no sum)."""
    mb = _tiny_mb()
    rs = np.random.RandomState(3)
    clips = [rs.randn(9 if i % 2 else 27, 17, 3).astype(np.float32)
             for i in range(12)]
    direct = [mb.lift(c[None])[0] for c in clips]
    direct_rep = [mb.get_representation(c[None])[0] for c in clips[:4]]
    futs = [None] * len(clips)
    with MotionBERTServer(mb, batch_buckets=(1, 8), max_wait_ms=30) as srv:
        def client(tid):
            for i in range(tid, len(clips), 3):
                futs[i] = srv.lift(clips[i])

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for out, ref in zip((f.result(timeout=60) for f in futs), direct):
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(out[:, 0, :], 0.0)
        reps = [srv.get_representation(c) for c in clips[:4]]
        for out, ref in zip(reps, direct_rep):
            np.testing.assert_allclose(out.result(timeout=60), ref,
                                       rtol=1e-5, atol=1e-5)
        assert srv.stats["lift"].requests == len(clips)
    with pytest.raises(RuntimeError):
        srv.lift(clips[0])
