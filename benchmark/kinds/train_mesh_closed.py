"""Traffic kind ``train_mesh_closed``: the mesh-recovery finetune step,
closed loop, back to back.

Set-up draws, from the run's seed, the body model (``reference.mesh
.draw_body`` at the configuration's ``body_model`` sizes, handed to the
program's ``SMPLModel`` constructor as the official files' tables), the
weights (``reference.mesh.draw_weights``) and a pool of clips: SMPL
parameters near the mean pose (axis-angles N(0, 0.25) a clip plus a random
walk of N(0, 0.01) a frame), betas N(0, 1) a clip, and as the 2D input the
x, y of the H36M joints that the reference skins from them on the card
(``reference.mesh.targets``), in metres, with confidences U(0.5, 1). It
builds the model as the mesh trainer does (``train.mesh.build_mesh_model``:
the DSTformer through the pair kernels, bf16 on the card; the head and SMPL
in fp32), AdamW in two groups (``make_two_group_adamw``) and the step
(``make_mesh_train_step``, its dropout masks from a seeded generator on the
card), and drives its first ``check_steps`` steps with the window's own
call and feed: batches of distinct pool rows, each clip flipped with
probability 1/2 on the host (its 2D input and its theta, with the
loader's ``flip_data_np`` / ``flip_thetas_np``), handed to the trainer's
``device_prefetch`` as the 2D input and theta alone, so that the step skins
the targets on the card; every loss term read back as one copy a step.
Those steps are the warm-up; the same object then runs the window. In the
window each step's terms are read one step behind: their copy to the host
is queued right after the step, and the host waits for it only after it
has launched the next step, as a trainer that logs every step without
stalling the card reads them (the mesh trainer's own loop reads its meters
at each print only); the window closes with the last step's read and a
synchronise. After
the window the program is freed and the plain reference
(``reference/mesh.py``) follows the first steps from the same weights, body
model, batches, flips and dropout masks.

Besides the training numbers and the first forward's vertices, the check
runs the reference's head, SMPL and loss alone, forward and backward, on
the program's own first representation, with the reference's targets of
that batch and the same dropout masks, and compares the head's first
gradient and its change after the first step with the program's
(``head_gaps``): the backward through the head, SMPL and the loss, and the
head's AdamW group, held to float32. It also runs the reference's
backbone backward alone from the gradient that reached the program's
representation in its first step, and compares the backbone's first
gradient with the program's (``backbone_grad_gap``): the pair kernels'
backward at this cell's shapes, held to the bf16 of the configuration.

Traffic keys: ``batch``, ``frames``, ``pool`` (clips drawn from the seed),
``check_steps``. Faults, for the harness's own tests: ``frozen`` (the
optimizer's step does nothing), ``half_batch`` (the step gets the first
half of each batch), ``half_loss`` (the loss's gradient reaches the first
half of each batch's clips alone; the forward and the loss keep their
values). The controls (``control_readings``): the reference
with its head and SMPL under bf16 autocast in the program's place, or with
``faults`` holding ``fp8`` its backbone's pair products in float8.
"""

from __future__ import annotations

import math
import time

import numpy as np

from benchmark import inputs, work, work_smpl
from benchmark.compare import ROUNDOFF_SHARE, train_readings
from benchmark.reference import mesh as ref_mesh

KIND = "train"
REGIONS = ("Optimizer.step#", "mesh.smpl")
POSE_STD, DRIFT_STD = 0.25, 0.01


def vertex_err_mm(mine, ref) -> float:
    """The mean over vertices of the distance between two (N, T, V, 3)
    meshes in mm; inf where the shapes differ or a value is not finite."""
    if mine is None or tuple(mine.shape) != tuple(ref.shape):
        return math.inf
    err = float((mine.to(ref.device) - ref).norm(dim=-1).mean())
    return err if math.isfinite(err) else math.inf


def head_gaps(mine, ref) -> dict:
    """mine, ref: {"grad": {name: first gradient}, "delta": {name: change
    after the first step}} over the head's parameters (ref as
    ``reference.mesh.head_step`` gives it, or None). ``head_grad_gap``:
    ||mine - ref|| / ||ref|| of the first gradient, all the head's
    parameters as one vector; ``head_update_gap``: the same of the change,
    over the elements whose reference gradient is at least
    ``ROUNDOFF_SHARE`` of the head's root-mean-square gradient (under it,
    Adam's sign-like first step moves an element by its rounding). inf
    where a side or a parameter is missing, a shape differs or a value is
    not finite."""
    inf = {"head_grad_gap": math.inf, "head_update_gap": math.inf}
    if mine is None or ref is None or set(mine["grad"]) != set(ref["grad"]):
        return inf
    grads = list(ref["grad"].values())
    rms = math.sqrt(sum(float(g.square().sum()) for g in grads)
                    / sum(g.numel() for g in grads))
    sums = [0.0, 0.0, 0.0, 0.0]
    for n, g in ref["grad"].items():
        a, b, d = mine["grad"][n], mine["delta"][n], ref["delta"][n]
        if tuple(a.shape) != tuple(g.shape) or tuple(b.shape) != tuple(
                g.shape):
            return inf
        a, b = a.to(g.device), b.to(g.device)
        keep = g.abs() >= ROUNDOFF_SHARE * rms
        sums[0] += float((a - g).square().sum())
        sums[1] += float(g.square().sum())
        sums[2] += float((b - d)[keep].square().sum())
        sums[3] += float(d[keep].square().sum())
    out = {"head_grad_gap": math.sqrt(sums[0] / sums[1]) if sums[1] else
           math.inf,
           "head_update_gap": math.sqrt(sums[2] / sums[3]) if sums[3] else
           math.inf}
    return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}


def backbone_grad_gap(mine, ref) -> float:
    """mine, ref: {name: first gradient} over the backbone's trained
    parameters: ||mine - ref|| / ||ref||, all of them as one vector; inf
    where a side or a parameter is missing, a shape differs or a value is
    not finite."""
    if not mine or not ref or set(mine) != set(ref):
        return math.inf
    diff = norm = 0.0
    for n, g in ref.items():
        if tuple(mine[n].shape) != tuple(g.shape):
            return math.inf
        diff += float((mine[n].to(g) - g).square().sum())
        norm += float(g.square().sum())
    gap = math.sqrt(diff / norm) if norm else math.inf
    return gap if math.isfinite(gap) else math.inf


def _half_loss(module, args, out: dict) -> dict:
    """The fault ``half_loss``: the outputs' second half of clips detached,
    so the loss's gradient reaches the first half alone."""
    import torch

    n = out["verts"].shape[0] // 2
    return {k: torch.cat([v[:n], v[n:].detach()]) for k, v in out.items()}


class Cell:
    def __init__(self, cell, seed: int, device, trace, faults=(),
                 attn_impl: str = "kernel"):
        self.cfg, self.tr = cell.config["config"], cell.traffic
        self.body_sizes = cell.config["body_model"]
        self.seeds = inputs.streams(seed)
        self.device, self.trace = device, trace
        self.faults, self.attn_impl = frozenset(faults), attn_impl
        self.B, self.F = int(self.tr["batch"]), int(self.tr["frames"])

    # -- set-up -------------------------------------------------------------

    def _body(self) -> dict:
        """The run's body model: the reference's tables on the device."""
        return ref_mesh.draw_body(
            int(self.body_sizes["num_verts"]),
            int(self.body_sizes["num_betas"]), self.seeds["weights"],
            self.device)

    def _pool(self, body: dict) -> None:
        """The pool's theta (pool, F, 72 + n_betas) and 2D input (pool, F,
        17, 3), float32 on the host, the 2D from the reference's
        skinning."""
        import torch

        n, F, nb = int(self.tr["pool"]), self.F, body["mean_shape"].shape[0]
        rng = np.random.default_rng(self.seeds["clips"])
        pose = rng.normal(0.0, POSE_STD, (n, 1, 72)) + np.cumsum(
            rng.normal(0.0, DRIFT_STD, (n, F, 72)), axis=1)
        betas = np.repeat(rng.normal(0.0, 1.0, (n, 1, nb)), F, axis=1)
        self.theta = np.concatenate([pose, betas], -1).astype(np.float32)
        conf = rng.uniform(0.5, 1.0, (n, F, 17, 1)).astype(np.float32)
        kp = []
        with ref_mesh.full_fp32():
            for s in range(0, n, self.B):
                th = torch.from_numpy(self.theta[s:s + self.B]).to(
                    self.device)
                kp.append(ref_mesh.targets(body, th)["kp_3d"][..., :2]
                          .cpu().numpy())
        self.x2d = np.concatenate([np.concatenate(kp) / 1000.0, conf], -1
                                  ).astype(np.float32)

    def _batches(self):
        """Host batches (2D input, theta) of distinct pool rows, each clip
        flipped with probability 1/2; the first ones' rows and flips are
        kept for the reference."""
        from motionbert_tpu_torch.geometry.rotations import flip_thetas_np
        from motionbert_tpu_torch.geometry.skeleton import flip_data_np

        B, F = self.B, self.F
        for idx in inputs.batch_order(self.seeds["clips"], len(self.x2d), B):
            fl = self.flip_rng.random(B) < 0.5
            if len(self.first) < int(self.tr["check_steps"]):
                self.first.append((idx.copy(), fl))
            x, th = self.x2d[idx], self.theta[idx]
            x[fl] = flip_data_np(x[fl])
            th[fl, :, :72] = flip_thetas_np(
                th[fl, :, :72].reshape(-1, F, 24, 3)).reshape(-1, F, 72)
            if "half_batch" in self.faults:
                x, th = x[:B // 2], th[:B // 2]
            yield x, th

    def setup(self):
        import torch
        from motionbert_tpu_torch.core.config import ConfigDict
        from motionbert_tpu_torch.data.datasets import device_prefetch
        from motionbert_tpu_torch.losses.mesh import LAMBDA_KEYS
        from motionbert_tpu_torch.models.smpl import SMPLModel
        # a program whose step cannot skin its own targets stops here
        from motionbert_tpu_torch.train.mesh import (  # noqa: F401
            build_mesh_model, make_mesh_train_step, mesh_targets)
        from motionbert_tpu_torch.train.state import make_two_group_adamw

        cfg, dev = self.cfg, self.device
        self.marks = [("import", time.perf_counter())]
        self.body = self._body()
        smpl = SMPLModel(**{k: v.cpu().numpy() for k, v in self.body.items()})
        model = build_mesh_model(ConfigDict(cfg), smpl, device=dev,
                                 attn_impl=self.attn_impl)
        model.load_state_dict(ref_mesh.draw_weights(
            cfg, smpl.num_betas, self.seeds["weights"], dev))
        self._pool(self.body)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.marks.append(("inputs and weights", time.perf_counter()))
        opt = make_two_group_adamw(model, cfg["lr_backbone"], cfg["lr_head"],
                                   cfg["weight_decay"])
        if "frozen" in self.faults:
            opt.step = lambda *a, **k: None
        if "half_loss" in self.faults:
            model.register_forward_hook(_half_loss)
        gen = torch.Generator(device=dev).manual_seed(self.seeds["flips"])
        self.flip_rng = np.random.default_rng(self.seeds["flips"])
        self.step = make_mesh_train_step(
            model, opt, {k: cfg[k] for k in LAMBDA_KEYS},
            cfg.get("loss_type", "L1"), generator=gen)
        self.first = []
        self.feed = device_prefetch(self._batches(), dev)
        self.model, self.opt = model, opt
        self.program = {"loss": [], "grad_norm": {}, "delta": {}}
        seen = {}

        def keep_rep(module, args):
            rep = args[0]
            seen["rep"] = rep.detach().cpu()
            if rep.requires_grad:
                rep.register_hook(lambda g: seen.__setitem__(
                    "rep_grad", g.detach().float().cpu()))

        def keep_verts(module, args, out):
            seen["verts"] = out["verts"].detach().cpu()

        hooks = [model.head.register_forward_pre_hook(keep_rep),
                 model.register_forward_hook(keep_verts)]
        for i in range(int(self.tr["check_steps"])):
            terms = self._one_step()
            self.program["loss"].append(terms["total"])
            if i == 0:
                for h in hooks:
                    h.remove()
                self.program.update(seen)
                self.program["grad_norm"] = self._first_gradient()
                self.program["head"] = self._first_grads(start)
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
            m = self.opt.state.get(p, {}).get("exp_avg")
            out[n] = 0.0 if m is None else float(m.norm()) / 0.1
        return out

    def _first_grads(self, start: dict) -> dict:
        """The head's first gradients (still in ``.grad`` until the next
        step) and its change after the first step, and the backbone's first
        gradients, on the host."""
        import torch

        out = {"grad": {}, "delta": {}, "backbone": {}}
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                g = (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                if name.startswith("head."):
                    out["grad"][name] = g
                    out["delta"][name] = (p - start[name]).cpu()
                elif name.startswith("backbone.") and not name.startswith(
                        "backbone.head."):
                    out["backbone"][name] = g
        return out

    def _launch(self) -> tuple:
        """Feed and launch one step, and start the copy of its loss terms
        to the host: (their names, the copy, its event or None)."""
        import torch

        with self.trace.region("bench.feed"):
            x, theta = next(self.feed)
        with self.trace.region("bench.step"):
            terms = self.step(x, {"theta": theta})
            values = torch.stack(list(terms.values()))
            if self.device.type != "cuda":
                return list(terms), values, None
            copy = values.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return list(terms), copy, done

    def _read(self, launched: tuple) -> dict:
        """A launched step's loss terms on the host, waiting for that step
        alone."""
        names, values, done = launched
        with self.trace.region("bench.read_loss"):
            if done is not None:
                done.synchronize()
            return dict(zip(names, values.tolist()))

    def _one_step(self) -> dict:
        return self._read(self._launch())

    # -- the window ---------------------------------------------------------

    def measure(self, seconds: float) -> None:
        import torch

        dev, cuda = self.device, self.device.type == "cuda"
        events, steps, bad, last = [], 0, 0, None
        finite = lambda t: all(math.isfinite(v) for v in t.values())
        self.trace.start()
        with self.trace.window():
            t0 = time.perf_counter()
            while True:
                if cuda:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                launched = self._launch()
                if cuda:
                    ev[1].record()
                    events.append(ev)
                if last is not None:
                    bad += not finite(self._read(last))
                last = launched
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            bad += not finite(self._read(last))
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
        frames = self.B * self.F
        sizes = dict(self.body_sizes, num_joints=self.cfg["num_joints"])
        return {"kind": KIND, "steps": self.steps, "step_ms": self.step_ms,
                "clips": self.steps * self.B,
                "least_s": self.steps * work.train_step_least_s(
                    self.cfg, self.B, self.F),
                "model_flops": self.steps * work.train_step_flops(
                    self.cfg, self.B, self.F),
                "smpl_least_s": self.steps * work_smpl.smpl_least_s(
                    sizes, frames)}

    # -- correctness --------------------------------------------------------

    def _reference_inputs(self) -> tuple:
        """The body model, and the first steps' unflipped batches and
        flips, on the device."""
        import torch

        dev, body = self.device, self.body
        batches = [(torch.from_numpy(self.x2d[i]).to(dev),
                    torch.from_numpy(self.theta[i]).to(dev))
                   for i, _ in self.first]
        flips = [torch.from_numpy(f).to(dev) for _, f in self.first]
        return body, batches, flips

    def _reference(self, body, batches, flips, rep=None, low: str = "",
                   fp8: bool = False, rep_grad=None) -> tuple:
        """(the reference's first steps, its head step on ``rep`` against
        the first batch's targets (``reference.mesh.head_step``; None where
        ``rep`` has another number of clips), that representation, its
        backbone's first gradients from ``rep_grad`` at the
        representation (``reference.mesh.backbone_grads``; None where
        ``rep_grad`` is None or of another shape)) from the run's weights
        and dropout masks; ``rep`` None: the reference's own first
        representation."""
        import torch

        dev, nb = self.device, body["mean_shape"].shape[0]
        model = ref_mesh.build(self.cfg, nb, dev, fp8=fp8)
        model.load_state_dict(ref_mesh.draw_weights(
            self.cfg, nb, self.seeds["weights"], dev))
        x, fl = batches[0][0], flips[0].view(-1, 1, 1, 1)
        x = torch.where(fl, ref_mesh.flip(x), x)
        if rep is None:
            with torch.no_grad(), ref_mesh.full_fp32():
                rep = model.representation(x)
        bb = None
        if rep_grad is not None and rep_grad.shape[0] == x.shape[0]:
            bb = ref_mesh.backbone_grads(model, x, rep_grad.to(dev))
        rep = rep.to(dev)
        gen = lambda: torch.Generator(device=dev).manual_seed(
            self.seeds["flips"])
        theta, fl = batches[0][1], flips[0].view(-1, 1, 1)
        head = None
        if rep.shape[0] == theta.shape[0]:
            with ref_mesh.full_fp32():
                gt = ref_mesh.targets(body, torch.where(
                    fl, ref_mesh.flip_theta(theta), theta))
            head = ref_mesh.head_step(model, body, rep, gt, gen(), self.cfg,
                                      low)
        steps = ref_mesh.train_steps(model, body, batches, flips, gen(),
                                     self.cfg, low)
        return steps, head, rep, bb

    def readings(self) -> dict:
        """Free the program, run the reference over the first steps, and
        compare: the three training numbers of ``compare.train_readings``,
        the first forward's vertices against the reference's
        (``vertex_err_mm``), and against the reference's head and SMPL on
        the program's own first representation (``head_vertex_err_mm``:
        the head and SMPL alone), the head's first gradient and change
        against that head step's (``head_gaps``), and the backbone's first
        gradient against the reference backbone's backward from the
        program's own gradient at the representation
        (``backbone_grad_gap``)."""
        import torch

        del self.step, self.feed, self.model, self.opt
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        body, batches, flips = self._reference_inputs()
        rep = self.program.get("rep")
        mine = self.program.get("head")
        ref, head, _, bb = self._reference(
            body, batches, flips, rep=rep,
            rep_grad=self.program.get("rep_grad"))
        out = train_readings(self.program, ref)
        verts = self.program.get("verts")
        out["vertex_err_mm"] = vertex_err_mm(verts, ref["out"]["verts"])
        out["head_vertex_err_mm"] = (
            math.inf if head is None else
            vertex_err_mm(verts, head["out"]["verts"]))
        out.update(head_gaps(mine, head))
        out["backbone_grad_gap"] = backbone_grad_gap(
            mine and mine["backbone"], bb)
        return out

    def control_readings(self) -> dict:
        """The control in the program's place, compared like the program:
        the reference with its head and SMPL under bf16 autocast, or with
        ``fp8`` among the faults its backbone's pair products in float8."""
        import torch

        self.body = self._body()
        self._pool(self.body)
        self.flip_rng = np.random.default_rng(self.seeds["flips"])
        self.first = []
        batches = self._batches()
        for _ in range(int(self.tr["check_steps"])):
            next(batches)
        body, batches, flips = self._reference_inputs()
        fp8 = "fp8" in self.faults
        low, head_low, rep, _ = self._reference(
            body, batches, flips, low="" if fp8 else "head_bf16", fp8=fp8)
        control = {"loss": low["loss"],
                   "grad_norm": {n: float(g.norm()) for n, g in
                                 zip(low["names"], low["grad1"])},
                   "delta": {n: d.cpu() for n, d in
                             zip(low["names"], low["delta"])}}
        ref, head, _, bb = self._reference(body, batches, flips, rep=rep,
                                           rep_grad=low["rep_grad"])
        out = train_readings(control, ref)
        out["vertex_err_mm"] = vertex_err_mm(low["out"]["verts"],
                                             ref["out"]["verts"])
        out["head_vertex_err_mm"] = vertex_err_mm(head_low["out"]["verts"],
                                                  head["out"]["verts"])
        out.update(head_gaps(head_low, head))
        out["backbone_grad_gap"] = backbone_grad_gap(
            {n: g for n, g in zip(low["names"], low["grad1"])
             if n.startswith("backbone.")}, bb)
        return out
