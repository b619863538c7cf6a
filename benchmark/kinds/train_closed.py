"""Traffic kind ``train_closed``: the finetune step, closed loop, back to
back.

Set-up builds one training step (``train.pose3d.make_train_step`` on
``load_backbone(..., attn_impl="kernel")``, AdamW as ``make_adamw`` with
the configuration's learning rate and decay, the random flip from a seeded
generator on the card) and drives it through its first ``check_steps``
steps with the window's own call and feed: batches of distinct pool rows,
copied from host memory by the trainer's own ``device_prefetch``, every
loss term read back each step as the trainer's loop reads it. Those steps
are the warm-up; the same object then runs the window. After the window
the program is freed and the plain reference follows the first steps from
the same weights, batches and flips.

Traffic keys: ``batch``, ``frames``, ``pool`` (clips drawn from the seed),
``check_steps``, ``reference_chunk`` (clips per reference forward).
Faults, for the harness's own tests: ``frozen`` (the optimizer's step does
nothing), ``half_batch`` (the step gets the first half of each batch).
"""

from __future__ import annotations

import math
import time

from benchmark import inputs, work
from benchmark.compare import train_readings
from benchmark.reference import dstformer as ref_model
from benchmark.reference import pose3d as ref_task

KIND = "train"
REGIONS = ("Optimizer.step#",)


class Cell:
    def __init__(self, cell, seed: int, device, trace, faults=(),
                 attn_impl: str = "kernel"):
        self.cfg, self.tr = cell.config["config"], cell.traffic
        self.seeds = inputs.streams(seed)
        self.device, self.trace = device, trace
        self.faults, self.attn_impl = frozenset(faults), attn_impl
        self.B, self.F = int(self.tr["batch"]), int(self.tr["frames"])

    # -- set-up -------------------------------------------------------------

    def _batches(self):
        """Host batches of distinct pool rows; the first ones are kept for
        the reference."""
        for idx in inputs.batch_order(self.seeds["clips"], len(self.x2d),
                                      self.B):
            batch = (self.x2d[idx], self.x3d[idx])
            if len(self.first) < int(self.tr["check_steps"]):
                self.first.append(batch)
            if "half_batch" in self.faults:
                batch = (batch[0][:self.B // 2], batch[1][:self.B // 2])
            yield batch

    def setup(self):
        import torch
        from motionbert_tpu_torch.data.datasets import device_prefetch
        from motionbert_tpu_torch.losses.pose import LAMBDA_KEYS
        from motionbert_tpu_torch.models.factory import load_backbone
        from motionbert_tpu_torch.train.pose3d import make_train_step
        from motionbert_tpu_torch.train.state import make_adamw

        cfg, dev = self.cfg, self.device
        self.marks = [("import", time.perf_counter())]
        self.x2d, self.x3d = inputs.clip_pool(
            self.seeds["clips"], int(self.tr["pool"]), self.F,
            int(cfg["num_joints"]))
        self.first = []
        model = load_backbone(cfg, device=dev, attn_impl=self.attn_impl)
        model.load_state_dict(
            ref_model.draw_weights(cfg, self.seeds["weights"], dev))
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.marks.append(("inputs and weights", time.perf_counter()))
        opt = make_adamw(model.parameters(), cfg["learning_rate"],
                         cfg["weight_decay"])
        if "frozen" in self.faults:
            opt.step = lambda *a, **k: None
        gen = torch.Generator(device=dev).manual_seed(self.seeds["flips"])
        self.step = make_train_step(
            model, opt, {k: cfg.get(k, 0.0) for k in LAMBDA_KEYS},
            rootrel=cfg["rootrel"], no_conf=cfg.get("no_conf", False),
            flip_aug=bool(cfg.get("flip", False)), generator=gen)
        self.feed = device_prefetch(self._batches(), dev)
        self.model, self.opt = model, opt
        self.program = {"loss": [], "grad_norm": {}, "delta": {}}
        for i in range(int(self.tr["check_steps"])):
            terms = self._one_step()
            self.program["loss"].append(terms["total"])
            if i == 0:
                self.program["grad_norm"] = self._first_gradient()
        with torch.no_grad():   # kept on the host past the program
            self.program["delta"] = {
                n: (p - start[n]).cpu() for n, p in model.named_parameters()}
        del start
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.marks.append(("first steps", time.perf_counter()))

    def _first_gradient(self) -> dict:
        """Each parameter's first gradient norm, from AdamW's state after
        one step: exp_avg = (1 - beta1) g."""
        out = {}
        for n, p in self.model.named_parameters():
            state = self.opt.state.get(p, {})
            m = state.get("exp_avg")
            out[n] = 0.0 if m is None else float(m.norm()) / 0.1
        return out

    def _one_step(self) -> dict:
        with self.trace.region("bench.feed"):
            x, y = next(self.feed)
        with self.trace.region("bench.step"):
            terms = self.step(x, y)
        with self.trace.region("bench.read_loss"):
            return {k: float(v) for k, v in terms.items()}

    # -- the window ---------------------------------------------------------

    def measure(self, seconds: float) -> None:
        import torch

        dev, cuda = self.device, self.device.type == "cuda"
        events, steps, bad = [], 0, 0
        self.trace.start()
        with self.trace.window():
            t0 = time.perf_counter()
            while True:
                if cuda:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                terms = self._one_step()
                if cuda:
                    ev[1].record()
                    events.append(ev)
                steps += 1
                bad += not all(math.isfinite(v) for v in terms.values())
                if time.perf_counter() - t0 >= seconds:
                    break
            if cuda:
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
        self.trace.stop()
        self.steps, self.bad, self.window_s = steps, bad, t1 - t0
        self.step_ms = [a.elapsed_time(b) for a, b in events]

    def end_to_end(self) -> dict:
        return {"train_clips_per_s": self.steps * self.B / self.window_s}

    def counts(self) -> tuple:
        """(attempted, failed): steps in the window, and those whose loss
        terms were not finite."""
        return self.steps, self.bad

    def records(self) -> dict:
        return {"kind": KIND, "steps": self.steps, "step_ms": self.step_ms,
                "clips": self.steps * self.B,
                "least_s": self.steps * work.train_step_least_s(
                    self.cfg, self.B, self.F),
                "model_flops": self.steps * work.train_step_flops(
                    self.cfg, self.B, self.F)}

    # -- correctness --------------------------------------------------------

    def _reference_steps(self, fp8: bool = False) -> dict:
        """The plain reference's first steps from the run's weights,
        batches and flips."""
        import torch

        dev = self.device
        ref = ref_model.build(self.cfg, dev, fp8=fp8)
        ref.load_state_dict(
            ref_model.draw_weights(self.cfg, self.seeds["weights"], dev))
        batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
                   for x, y in self.first]
        gen = torch.Generator(device=dev).manual_seed(self.seeds["flips"])
        flips = [torch.rand((self.B, 1, 1, 1), generator=gen, device=dev,
                            dtype=torch.float32).view(-1) < 0.5
                 for _ in batches]
        return ref_task.train_steps(ref, batches, flips, self.cfg,
                                    int(self.tr["reference_chunk"]))

    def readings(self) -> dict:
        """Free the program, run the reference over the first steps, and
        compare."""
        import torch

        del self.step, self.feed, self.model, self.opt
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return train_readings(self.program, self._reference_steps())

    def control_readings(self) -> dict:
        """The control in the program's place: the reference with its
        products in float8 over the same first steps, compared like the
        program. The program's own W8A8 tier is no such path for training:
        its backward is the bf16 pair backward."""
        self.x2d, self.x3d = inputs.clip_pool(
            self.seeds["clips"], int(self.tr["pool"]), self.F,
            int(self.cfg["num_joints"]))
        order = inputs.batch_order(self.seeds["clips"], len(self.x2d), self.B)
        self.first = [(self.x2d[i], self.x3d[i]) for i in
                      (next(order) for _ in range(int(self.tr["check_steps"])))]
        low = self._reference_steps(fp8=True)
        control = {"loss": low["loss"],
                   "grad_norm": {n: float(g.norm()) for n, g in
                                 zip(low["names"], low["grad1"])},
                   "delta": {n: d.cpu() for n, d in
                             zip(low["names"], low["delta"])}}
        del low
        return train_readings(control, self._reference_steps())
