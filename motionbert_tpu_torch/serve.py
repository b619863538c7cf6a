"""Online serving: async request batching over the port's model.

Concurrent callers submit individual clips; a collector thread groups
requests of the same full clip shape into padded device batches, runs each
group as one call, and resolves per-request futures. The port of
``motionbert_tpu/serve.py``: the same planner (``_plan_chunks``), the same
cancel-tolerant ``_resolve``, grouping by full shape and shutdown that fails
undrained futures; in addition ``submit`` fails, instead of waiting forever,
when the queue is full and the collector is dead.

Grouping is by exact clip length because temporal attention attends over
every frame of the clip; padding the batch axis is free, so short groups are
padded by repetition and the padding rows dropped on the way out.

    server = BatchingServer(fn)                # fn: (B, T, J, C) -> result
    fut = server.submit(clip)                  # clip: (T, J, C)
    result = fut.result()                      # (T, J, C) numpy

    mb_server = MotionBERTServer.from_config(cfg, checkpoint=...)
    pose3d = mb_server.lift(motion_2d).result()
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

from motionbert_tpu_torch.infer.batching import (
    fetch_result, stack_padded, unstack_result)


def _resolve(fut: Future, result=None, exc=None):
    """Resolve a future, tolerating a client that cancelled it: cancel()
    succeeds while a request is queued, after which set_result/set_exception
    raise InvalidStateError — which must neither poison the other requests
    in the round nor kill the collector thread. A done()-check cannot close
    the race (cancel can land between the check and the set), so swallow."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:
        pass  # cancelled (or already resolved by the last-resort guard)


@dataclass
class ServerStats:
    """Aggregate serving counters (only the collector thread writes them)."""
    requests: int = 0
    batches: int = 0
    padded_rows: int = 0
    batched_requests: int = 0  # running sum of real (unpadded) batch rows

    @property
    def avg_batch_size(self) -> float:
        return self.batched_requests / self.batches if self.batches else 0.0


class BatchingServer:
    """Groups concurrent single-clip requests into device batches.

    fn: callable taking a (B, T, J, C) numpy array and returning an
        array, tensor, or dict/list/tuple of them with a leading batch
        dimension.
    batch_buckets: allowed device batch sizes, ascending. A group of n
        same-length requests is split greedily into the largest buckets
        that fit entirely; only the final sub-bucket remainder is padded
        (by repeating the last clip) up to the smallest bucket >= it — so
        each clip length runs at most len(batch_buckets) batch shapes and
        padding waste is bounded by one bucket step.
    max_wait_ms: how long the collector holds an incomplete batch open for
        stragglers before dispatching (the latency/throughput knob).
    """

    def __init__(self, fn: Callable, batch_buckets: Sequence[int] =
                 (1, 8, 32, 128), max_wait_ms: float = 5.0,
                 max_queue: int = 4096):
        buckets = tuple(int(b) for b in batch_buckets)
        # non-empty + positive: an empty/zero ladder would IndexError the
        # collector thread, leaving every submitted future hanging forever
        if not buckets or list(buckets) != sorted(set(buckets)) \
                or buckets[0] < 1:
            raise ValueError("batch_buckets must be a non-empty ascending "
                             "sequence of positive ints")
        self._fn = fn
        self._buckets = buckets
        self._max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._closed = False
        # guards the _closed check + enqueue pair: without it a submit can
        # pass the check while shutdown() enqueues the sentinel, landing its
        # item BEHIND the sentinel where the worker never sees it
        self._submit_lock = threading.Lock()
        self._plan_memo: dict = {}  # group size -> [(take, bucket), ...]
        self.stats = ServerStats()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="mbt-torch-serving-collector")
        self._worker.start()

    # -- client side --------------------------------------------------------

    def submit(self, clip: np.ndarray) -> Future:
        """Enqueue one (T, ...) clip; returns a Future of fn's per-clip
        output (numpy, leading batch dim removed)."""
        # copy: the collector may stack this buffer up to max_wait_ms later;
        # a caller reusing its array after submit must not corrupt the batch
        arr = np.array(clip, copy=True)
        if arr.ndim < 1:
            # fail the bad request HERE — a 0-d clip would IndexError the
            # collector's length grouping and poison the whole round
            raise ValueError(
                f"clip must have a leading time axis; got shape {arr.shape}")
        fut: Future = Future()
        item = (arr, fut)
        while True:
            # put_nowait under the lock, sleep outside it: blocking on a
            # full queue while HOLDING the lock would serialize all
            # submitters on the lock and deadlock shutdown() against it
            with self._submit_lock:
                if self._closed:
                    raise RuntimeError("server is shut down")
                try:
                    self._q.put_nowait(item)
                    return fut
                except queue.Full:
                    # a dead collector never drains the queue: fail instead
                    # of waiting on it forever
                    if not self._worker.is_alive():
                        raise RuntimeError("server collector is not running")
            time.sleep(0.001)  # backpressure wait

    def shutdown(self, wait: bool = True):
        """Stop accepting work; drain the queue, then stop the worker."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
        # _closed is set (under the same lock submit takes), so no new item
        # can land behind the sentinel; enqueue it without blocking forever
        # on a full queue whose collector may already be dead
        while True:
            try:
                self._q.put_nowait(None)  # sentinel
                break
            except queue.Full:
                if not self._worker.is_alive():
                    break
                time.sleep(0.001)
        if wait and self._worker.is_alive():
            self._worker.join()
        if not self._worker.is_alive():
            # the collector is gone (joined or died): fail anything it
            # never drained so a timeout-less fut.result() can't hang.
            # With wait=False and a LIVE collector we must not touch the
            # queue — it will drain everything up to the sentinel itself.
            while True:
                try:
                    leftover = self._q.get_nowait()
                except queue.Empty:
                    break
                if leftover is not None:
                    _resolve(leftover[1], exc=RuntimeError(
                        "server shut down before this request was "
                        "dispatched"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- worker side --------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    # The cost of one dispatch, in rows of device compute: splitting a group
    # beats padding it only when it saves more than this many padded rows
    # per extra dispatch. The value is the JAX package's (motionbert_tpu/
    # serve.py), kept so both servers plan alike; it has not been measured
    # for the port. With buckets (1,8,...,96,192), 105 waiting clips plan as
    # 96+8+1 real rows; with (1,8,48) a 44-clip group still pads to one 48
    # batch rather than six 8s.
    DISPATCH_OVERHEAD_ROWS = 4

    def _plan_chunks(self, n: int):
        """Split an n-request group into [(take, bucket), ...] minimizing
        total cost = sum(bucket rows) + overhead per dispatch."""
        memo = self._plan_memo
        if n in memo:
            return memo[n]
        # bottom-up DP (iterative — a recursive cost(m) -> cost(m-1) chain
        # would hit Python's recursion limit for ladders with a top bucket
        # in the ~1000s): m -> (cost, (take, bucket))
        best: dict = {0: (0.0, None)}
        for m in range(1, n + 1):
            c = self._bucket_for(m) + self.DISPATCH_OVERHEAD_ROWS \
                if m <= self._buckets[-1] else float("inf")
            choice = (m, self._bucket_for(m))
            for b in self._buckets:
                if b > m or b == 0:
                    continue
                cb = b + self.DISPATCH_OVERHEAD_ROWS + best[m - b][0]
                if cb < c:
                    c, choice = cb, (b, b)
            best[m] = (c, choice)
        plan, m = [], n
        while m > 0:
            take, bucket = best[m][1]
            plan.append((take, bucket))
            m -= take
        # big chunks first: resolving the large batch releases most
        # closed-loop callers earliest
        plan.sort(key=lambda t: -t[0])
        memo[n] = plan
        return plan

    def _collect(self):
        """Block for one item, then gather more until the oldest item's
        deadline passes or the largest bucket fills. Returns (items, done)
        where items is a list of (clip, future)."""
        first = self._q.get()
        if first is None:
            return [], True
        items = [first]
        deadline = time.monotonic() + self._max_wait
        while len(items) < self._buckets[-1]:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                return items, True
            items.append(nxt)
        return items, False

    def _dispatch_group(self, group):
        """Run one same-length group as bucket-padded device batches."""
        for take, bucket in self._plan_chunks(len(group)):
            chunk, group = group[:take], group[take:]
            # everything from stacking on is guarded: a bad clip (e.g. same
            # T but mismatched trailing shape) must fail its own futures,
            # never the collector thread
            try:
                batch = stack_padded([c for c, _ in chunk], bucket)
                res = fetch_result(self._fn(batch))
                results = [unstack_result(res, k) for k in range(len(chunk))]
            except Exception as e:  # propagate to every caller in the batch
                for _, fut in chunk:
                    _resolve(fut, exc=e)
                continue
            self.stats.batches += 1
            self.stats.padded_rows += bucket - len(chunk)
            self.stats.batched_requests += len(chunk)
            for (_, fut), out in zip(chunk, results):
                _resolve(fut, result=out)

    def _run(self):
        done = False
        while not done:
            items, done = self._collect()
            if not items:
                continue
            self.stats.requests += len(items)
            try:
                by_shape: dict = {}
                for clip, fut in items:
                    # group by the FULL shape, not just clip length: a
                    # malformed clip (right length, wrong trailing shape)
                    # must form its own group and fail alone, never the
                    # well-formed requests it would otherwise co-batch with
                    by_shape.setdefault(clip.shape, []).append((clip, fut))
                # largest groups first: best amortization while stragglers
                # of other lengths keep queueing behind
                for _, grp in sorted(by_shape.items(),
                                     key=lambda kv: -len(kv[1])):
                    self._dispatch_group(grp)
            except Exception as e:  # last-resort guard: the collector must
                for _, fut in items:  # outlive any malformed request
                    if not fut.done():
                        _resolve(fut, exc=e)  # races with cancel(): tolerate


class MotionBERTServer:
    """Online-serving facade over api.MotionBERT: batched flip-TTA 3D
    lifting and representation extraction behind futures.

    lift serves exactly api.MotionBERT.lift at the constructor's flip_tta and
    rootrel (default: flip test-time averaging and root-relative output), so
    moving a caller from the blocking API to the server changes latency, not
    numerics."""

    def __init__(self, mb, batch_buckets: Sequence[int] = (1, 8, 32, 128),
                 max_wait_ms: float = 5.0, flip_tta: bool = True,
                 rootrel: bool = True):
        self.mb = mb
        self._lift = BatchingServer(
            lambda x: mb.lift(x, flip_tta=flip_tta, rootrel=rootrel),
            batch_buckets, max_wait_ms)
        self._rep = BatchingServer(mb.get_representation, batch_buckets,
                                   max_wait_ms)

    @classmethod
    def from_config(cls, config_path: str, checkpoint: Optional[str] = None,
                    device=None, attn_impl: Optional[str] = None,
                    **kw) -> "MotionBERTServer":
        from motionbert_tpu_torch.api import MotionBERT

        return cls(MotionBERT.from_config(config_path, checkpoint, device,
                                          attn_impl=attn_impl), **kw)

    def lift(self, motion_2d: np.ndarray) -> Future:
        """(T<=maxlen, 17, 3) normalized 2D+conf -> Future[(T, 17, 3)]."""
        return self._lift.submit(motion_2d)

    def get_representation(self, motion_2d: np.ndarray) -> Future:
        """(T<=maxlen, 17, 3) -> Future[(T, 17, dim_rep)]."""
        return self._rep.submit(motion_2d)

    @property
    def stats(self):
        return {"lift": self._lift.stats, "rep": self._rep.stats}

    def shutdown(self):
        self._lift.shutdown()
        self._rep.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
