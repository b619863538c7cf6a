"""The numbers that decide ``correct``, from the program's outputs and the
plain reference's, and their judgement against a cell's limits.

Training (the first steps of the object the window then drives):

- ``loss_gap``: the largest relative gap of a step's loss, over the
  steps the reference follows (read and printed, not compared: neither
  the control nor a fault reads it far enough above the program);
- ``grad_norm_gap``: for the first step's gradient as the optimizer got
  it, the worst parameter's gap between the program's norm and the
  reference's, over the larger of that parameter's reference norm and the
  median parameter's. The worst is nearly always an att_fuse gate weight,
  a sum over every token row whose bf16 error swings with how small the
  seed makes that gradient (0.004-0.037 over 18 seeds on an H100; plain
  PyTorch bf16 reads as much on the same leaves), so its limit sits
  between that and a state left unchanged (1);
- ``grad_norm_gap_median``: the same gaps' median over the parameters:
  steady from seed to seed, and what the float8 control and half a batch
  move;
- ``update_norm_gap``: the median parameter's gap of norms for the
  parameters' change over the steps (over the larger of its reference
  norm and the median parameter's), leaving out what moves by round-off
  alone: every element whose first reference gradient is under a
  thousandth of the median parameter's root-mean-square gradient (the key
  third of a packed qkv bias, whose exact gradient is 0 under softmax, is
  such a part of a parameter; a parameter with no element left is left
  out whole). The median, not the worst: the worst is one of the
  two-element gate biases or another small parameter, whose change under
  Adam's sign-like first steps swings from seed to seed (0.003-0.054 over
  37 seeds of the program on the card);

Serving (each sampled request's answer against the reference's lift of
its clip):

- ``lift_mse_ratio``: the sampled answers' squared distance from the
  float32 reference over the plain bf16 reference's (PyTorch's autocast
  on the same model and clips), summed over the sample: how many times
  plain bf16's mean squared error the program makes. Dividing by the
  plain bf16 error takes out how sensitive a seed's weights make the
  model, which moves a bare error fourfold from seed to seed;
- ``lift_err_max``, ``lift_err_l2``: the worst request's largest absolute
  error over its answer's largest magnitude, and its relative L2 error
  (read and printed, not compared: the W8A8 control reads under three
  times the program's largest on them).

A number passes when it is at most its limit; a missing number fails.
Only the numbers a cell's limits file names are compared. ``_grad_top``
names the three parameters of the largest gradient gaps, each with its
gap and its reference norm over the median parameter's.
"""

from __future__ import annotations

import math

import numpy as np

ROUNDOFF_SHARE = 1e-3


def _gap(p: float, r: float, floor: float) -> float:
    """|p - r| over max(|r|, floor); inf where either side is not finite."""
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / max(abs(r), floor)


def train_readings(program: dict, reference: dict) -> dict:
    """program: {"loss": [...], "grad_norm": {name: norm}, "delta": {name:
    change tensor}}; reference: ``reference.pose3d.train_steps``' result.
    Returns the three numbers, the worst parameter of each, and the
    parameters left out of the change."""
    names = reference["names"]
    loss = max(_gap(p, r, 1e-30)
               for p, r in zip(program["loss"], reference["loss"]))
    if len(program["loss"]) != len(reference["loss"]):
        loss = math.inf
    rg = {n: float(g.norm()) for n, g in zip(names, reference["grad1"])}
    med_g = float(np.median(list(rg.values())))
    gaps_g = {n: _gap(program["grad_norm"].get(n, 0.0), rg[n], med_g)
              for n in names}
    rms = float(np.median([float(g.norm()) / g.numel() ** 0.5
                           for g in reference["grad1"]]))
    rd, pd = {}, {}
    for n, g, d in zip(names, reference["grad1"], reference["delta"]):
        keep = g.abs() >= ROUNDOFF_SHARE * rms
        if not bool(keep.any()):
            continue
        mine = program["delta"].get(n)
        rd[n] = float(d[keep].norm())
        pd[n] = (0.0 if mine is None
                 else float(mine.to(d.device)[keep].norm()))
    med_d = float(np.median(list(rd.values())))
    gaps_d = {n: _gap(pd[n], rd[n], med_d) for n in rd}
    top_g = sorted(gaps_g, key=gaps_g.get, reverse=True)[:3]
    worst_g = top_g[0]
    worst_d = max(gaps_d, key=gaps_d.get)
    return {"loss_gap": loss,
            "grad_norm_gap": gaps_g[worst_g],
            "grad_norm_gap_median": float(np.median(list(gaps_g.values()))),
            "update_norm_gap": float(np.median(list(gaps_d.values()))),
            "_worst": {"grad_norm_gap": worst_g,
                       "update_norm_gap": (worst_d, gaps_d[worst_d])},
            "_left_out": sorted(set(names) - set(rd)),
            "_grad_top": [(n, round(gaps_g[n], 6), round(rg[n] / med_g, 4))
                          for n in top_g]}


def lift_readings(answers: dict, reference: dict, bf16: dict) -> dict:
    """answers, reference, bf16: {request index: (F, 17, 3) array}, the
    program's answers, the float32 reference's and the plain bf16
    reference's. A sampled request with no answer reads inf."""
    inf = {"lift_mse_ratio": math.inf, "lift_err_max": math.inf,
           "lift_err_l2": math.inf}
    per_max, per_l2, d2, b2 = [], [], 0.0, 0.0
    for i, ref in reference.items():
        ans = answers.get(i)
        if ans is None:
            return inf
        ref = np.asarray(ref, np.float64)
        d = np.asarray(ans, np.float64) - ref
        if not np.isfinite(d).all():
            return inf
        per_max.append(float(np.abs(d).max() / np.abs(ref).max()))
        per_l2.append(float(np.linalg.norm(d) / np.linalg.norm(ref)))
        d2 += float((d * d).sum())
        b2 += float(((np.asarray(bf16[i], np.float64) - ref) ** 2).sum())
    return {"lift_mse_ratio": d2 / b2 if b2 > 0 else math.inf,
            "lift_err_max": max(per_max), "lift_err_l2": max(per_l2)}


def judge(readings: dict, limits: dict) -> tuple:
    """(passed, [(name, value, limit), ...]) over the cell's limits."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        if not value <= limit:
            ok = False
        rows.append((name, value, limit))
    return ok, rows
