"""Traffic kind ``serve_open``: single clips lifted through
``MotionBERTServer``, arriving on an open-loop schedule.

Set-up builds the server the configuration describes (``api.MotionBERT``
on ``load_backbone(..., attn_impl="kernel")``, the traffic's buckets,
``max_wait_ms`` and flip-TTA, the configuration's ``rootrel``), warms every
bucket's batch shape and the server's path, and draws the schedule. One
generator thread submits each request at its instant, whatever the server
is doing; latency runs from the instant a request was due to the moment
its future completed, so a late generator or a stalled server both count.
After the window closes the harness waits up to ``drain_s`` for every
request due in it; one that fails or never completes is missing. Then the
program is freed and the plain reference lifts a seeded sample of the
requests' clips.

Traffic keys: ``rate_per_s``, ``frames``, ``pool`` (distinct clips drawn
from the seed), ``batch_buckets``, ``max_wait_ms``, ``flip_tta``,
``sample`` (requests compared), ``drain_s``, ``reference_chunk``.
Faults, for the harness's own tests: ``stale`` (each call returns the
previous call's answers), ``half_batch`` (the second half of a batch gets
the first half's answers), ``altered`` (one joint's track in every answer
is moved by a tenth of the answer's largest magnitude).
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from benchmark import inputs, work
from benchmark.compare import lift_readings
from benchmark.reference import dstformer as ref_model
from benchmark.reference import pose3d as ref_task

KIND = "serve"
REGIONS = ()


class TimedLift:
    """The model the server calls, with a span around each ``lift``: the
    call ends in the host copy of its result, so the span is the call's
    whole time. Rows are the dispatched batch's, padding included."""

    def __init__(self, mb, trace, faults):
        self.mb, self.trace, self.faults = mb, trace, faults
        self.spans = []      # (start, seconds, rows)
        self._last = None

    def lift(self, x, flip_tta=True, rootrel=True):
        t = time.perf_counter()
        with self.trace.region("bench.lift"):
            out = self.mb.lift(x, flip_tta=flip_tta, rootrel=rootrel)
        self.spans.append((t, time.perf_counter() - t, int(x.shape[0])))
        return self._break(out)

    def _break(self, out):
        if "stale" in self.faults:
            last, self._last = self._last, out
            if last is not None and last.shape == out.shape:
                return last
        if "half_batch" in self.faults and len(out) > 1:
            h = len(out) // 2
            out = np.concatenate([out[:h], out[:len(out) - h]])
        if "altered" in self.faults:      # one joint's track moved
            out = out.copy()
            out[:, :, 9, 1] += 0.1 * np.abs(out).max()
        return out

    def get_representation(self, x):
        return self.mb.get_representation(x)


class Cell:
    def __init__(self, cell, seed: int, device, trace, faults=(),
                 attn_impl: str = "kernel"):
        self.cfg, self.tr = cell.config["config"], cell.traffic
        self.seeds = inputs.streams(seed)
        self.device, self.trace = device, trace
        self.faults, self.attn_impl = frozenset(faults), attn_impl
        self.F = int(self.tr["frames"])
        self.rate = float(self.tr["rate_per_s"])

    def setup(self):
        from motionbert_tpu_torch.api import MotionBERT
        from motionbert_tpu_torch.models.factory import load_backbone
        from motionbert_tpu_torch.serve import MotionBERTServer

        cfg, dev, tr = self.cfg, self.device, self.tr
        self.marks = [("import", time.perf_counter())]
        self.clips = inputs.clip_pool(self.seeds["clips"], int(tr["pool"]),
                                      self.F, int(cfg["num_joints"]))[0]
        model = load_backbone(cfg, device=dev, attn_impl=self.attn_impl)
        model.load_state_dict(
            ref_model.draw_weights(cfg, self.seeds["weights"], dev))
        mb = MotionBERT(model, maxlen=int(cfg["maxlen"]))
        self.lifter = TimedLift(mb, self.trace, self.faults)
        self.server = MotionBERTServer(
            self.lifter, batch_buckets=tuple(tr["batch_buckets"]),
            max_wait_ms=float(tr["max_wait_ms"]),
            flip_tta=bool(tr["flip_tta"]), rootrel=bool(cfg["rootrel"]))
        self.marks.append(("inputs and weights", time.perf_counter()))
        for b in tr["batch_buckets"]:       # every batch shape, twice
            for _ in range(2):
                mb.lift(self.clips[:b], flip_tta=bool(tr["flip_tta"]),
                        rootrel=bool(cfg["rootrel"]))
        warm = [self.server.lift(c) for c in self.clips[:16]]
        for f in warm:
            f.result()
        self.marks.append(("warm-up", time.perf_counter()))

    # -- the window ---------------------------------------------------------

    def schedule(self, seconds: float) -> None:
        self.arrive, self.which = inputs.poisson_schedule(
            self.seeds["arrivals"], self.rate, seconds, len(self.clips))
        n = len(self.arrive)
        k = min(int(self.tr["sample"]), n)
        rng = np.random.default_rng(self.seeds["sample"])
        self.sample = set(int(i) for i in rng.choice(n, k, replace=False))

    def measure(self, seconds: float) -> None:
        self.schedule(seconds)
        n = len(self.arrive)
        self.done = np.full(n, np.nan)
        self.late = np.zeros(n)
        self.answers = {}
        lock, finished, count = threading.Lock(), threading.Event(), [0]
        if n == 0:
            finished.set()

        def settled():
            with lock:
                count[0] += 1
                if count[0] == n:
                    finished.set()

        def on_done(i, fut):
            t = time.perf_counter()
            if fut.exception() is None:
                self.done[i] = t
                if i in self.sample:
                    self.answers[i] = fut.result()
            settled()

        def generate(t0):
            for i in range(n):
                due = t0 + self.arrive[i]
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                clip = self.clips[self.which[i]]
                self.late[i] = time.perf_counter() - due
                try:
                    fut = self.server.lift(clip)
                except RuntimeError:        # refused: never completes
                    settled()
                    continue
                fut.add_done_callback(lambda f, i=i: on_done(i, f))

        stats = self.server.stats["lift"]
        before = (stats.batches, stats.batched_requests, stats.padded_rows)
        spans0 = len(self.lifter.spans)
        self.trace.start()
        with self.trace.window():
            t0 = time.perf_counter() + 0.005
            gen = threading.Thread(target=generate, args=(t0,),
                                   name="bench-arrivals")
            gen.start()
            gen.join()
            close = t0 + seconds
            finished.wait(timeout=max(close + float(self.tr["drain_s"])
                                      - time.perf_counter(), 0.0))
        self.trace.stop()
        self.t0, self.close = t0, close
        self.stats = (stats.batches - before[0],
                      stats.batched_requests - before[1],
                      stats.padded_rows - before[2])
        self.spans = self.lifter.spans[spans0:]

    def latencies_ms(self) -> np.ndarray:
        lat = (self.done - (self.t0 + self.arrive)) * 1e3
        lat[~np.isfinite(lat)] = math.inf
        return lat

    def end_to_end(self) -> dict:
        lat = self.latencies_ms()
        return {"lift_p50_ms": inputs.percentile(lat, 50),
                "lift_p95_ms": inputs.percentile(lat, 95)}

    def counts(self) -> tuple:
        """(attempted, failed): the requests due in the window, and those
        that failed or never completed."""
        return len(self.arrive), int((~np.isfinite(self.done)).sum())

    def lateness_ms(self) -> dict:
        late = self.late * 1e3
        return {"p50": inputs.percentile(late, 50),
                "p99": inputs.percentile(late, 99),
                "max": float(late.max()) if late.size else 0.0}

    def backlog(self) -> dict:
        """Whether the server kept pace: requests still open when the
        window closed, and the completions against the arrivals in the
        window's last quarter."""
        seconds = self.close - self.t0
        q = self.t0 + 0.75 * seconds
        arrived = int(((self.t0 + self.arrive) >= q).sum())
        completed = int(((self.done >= q) & (self.done < self.close)).sum())
        still_open = int((((self.t0 + self.arrive) < self.close)
                          & ~(self.done < self.close)).sum())
        return {"open_at_close": still_open,
                "last_quarter_completed_per_arrived":
                    completed / arrived if arrived else math.nan}

    def records(self) -> dict:
        batches, real, padded = self.stats
        flips = 2 if self.tr["flip_tta"] else 1
        least = sum(flips * work.forward_least_s(self.cfg, rows, self.F)
                    for _, _, rows in self.spans)
        flops = sum(flips * work.model_forward_flops(self.cfg, rows, self.F)
                    for _, _, rows in self.spans)
        return {"kind": KIND, "batches": batches, "real_rows": real,
                "padded_rows": padded,
                "lift_s": sum(s for _, s, _ in self.spans),
                "lift_rows": sum(r for _, _, r in self.spans),
                "least_s": least, "model_flops": flops}

    # -- correctness --------------------------------------------------------

    def readings(self) -> dict:
        """Free the program, lift the sampled requests' clips with the
        reference, and compare each answer."""
        import torch

        dev = self.device
        self.server.shutdown()
        del self.server, self.lifter
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = ref_model.build(self.cfg, dev)
        ref.load_state_dict(
            ref_model.draw_weights(self.cfg, self.seeds["weights"], dev))
        order = sorted(self.sample)
        x = torch.from_numpy(self.clips[self.which[order]]).to(dev)
        if not self.tr["flip_tta"]:
            raise ValueError("the reference lifts with flip-TTA only")
        lift = [ref_task.lift(ref, x, bool(self.cfg["rootrel"]),
                              int(self.tr["reference_chunk"]), dt).cpu().numpy()
                for dt in (torch.float32, torch.bfloat16)]
        return lift_readings(self.answers, dict(zip(order, lift[0])),
                             dict(zip(order, lift[1])))
