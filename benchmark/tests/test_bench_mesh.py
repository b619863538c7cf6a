"""The mesh cell on the CPU: the SMPL work counts against hand counts, its
three span readers on a recorded span set, and the whole run at a tiny size
with the cell's own limits: a sound run comes out correct, a run with its
timed path broken underneath (a state left unchanged, half of each batch
left out, or half of each batch's clips cut off from the loss's gradient)
does not."""

import copy
import math

import pytest
import torch

from benchmark import run, spec, work_smpl

CELL = "train.motionbert_mesh.b128"
SMPL = dict(num_verts=6890, num_betas=10, num_joints=17)
TINY = dict(dim_feat=64, dim_rep=32, depth=1, num_heads=2, mlp_ratio=2,
            hidden_dim=64)
SHRINK = dict(batch=8, frames=8, pool=32)


def test_smpl_work_by_hand():
    V, K, H, J, P = 6890, 10, 17, 24, 207
    per_frame = (2 * V * 3 * K + V * 3          # shape blend
                 + 2 * J * V * 3                # joints
                 + P + 2 * V * 3 * P + V * 3    # pose blend
                 + 23 * 128 + J * 21            # chain, rest pose out
                 + 2 * V * J * 12               # blended transforms
                 + 2 * V * 9 + V * 3            # vertices moved
                 + V * 3 + 2 * H * V * 3)       # mm, H36M joints
    assert per_frame == 14_844_715
    assert work_smpl.smpl_flops_per_frame(SMPL) == per_frame
    # template, shapedirs, posedirs, both joint regressors, the weights
    assert work_smpl.smpl_model_bytes(SMPL) == 4 * (
        V * 3 + V * 3 * K + V * 3 * P + J * V + V * J + H * V) == 19_815_640
    assert work_smpl.smpl_frame_bytes(SMPL) == 4 * (K + 216 + V * 3 + 51)
    flops, nbytes = work_smpl.smpl_cost(SMPL, 2048)
    assert (flops, nbytes) == (2048 * per_frame,
                               19_815_640 + 2048 * 83_788)
    # a (128, 16) batch is compute-bound on the float32 peak: ~0.45 ms
    least = work_smpl.smpl_least_s(SMPL, 2048)
    assert least == pytest.approx(flops / 66.9e12)
    assert 4.4e-4 < least < 4.6e-4 and nbytes / 3.35e12 < least / 5


@pytest.fixture
def recorded(monkeypatch):
    from motionbert_tpu_torch.core import profiling

    window = {"spans": [], "samples": [], "device": [
        {"name": "mesh.smpl", "id": 1, "args": {}, "ms": 20.0},
        {"name": "mesh.smpl", "id": 2, "args": {}, "ms": 22.0},
        {"name": "mesh.smpl", "id": 3, "args": {}, "ms": 30.0},
        {"name": "mesh.targets", "id": 4, "args": {}, "ms": 6.0},
        {"name": "mesh.targets", "id": 5, "args": {}, "ms": 7.0},
        {"name": "mesh.targets", "id": 6, "args": {}, "ms": 8.0},
        {"name": "train.forward", "id": 7, "args": {}, "ms": 50.0}]}
    monkeypatch.setattr(profiling, "recorded", lambda: window)


@pytest.mark.parametrize("name, rec, want", [
    ("smpl_forward_ms_p50", {"kind": "train", "steps": 3}, 22.0),
    ("mesh_targets_ms", {"kind": "train", "steps": 3}, 7.0),
    ("smpl_roofline.train", {"kind": "train", "steps": 3,
                             "smpl_least_s": 0.0015,
                             "region_device_s": {"mesh.smpl": 0.06}}, 2.5),
])
def test_span_readers(recorded, name, rec, want):
    read = spec.reader(name)
    assert read(rec) == pytest.approx(want)
    assert read(dict(rec, kind="serve")) is None
    assert read({}) is None


def test_span_readers_without_the_spans(monkeypatch):
    """A program without the spans (the parent's) gives nothing to read."""
    from motionbert_tpu_torch.core import profiling

    monkeypatch.setattr(profiling, "recorded", lambda: {
        "spans": [], "device": [], "samples": []})
    rec = {"kind": "train", "steps": 3, "smpl_least_s": 1e-3,
           "region_device_s": {"Optimizer.step#": 0.1, "mesh.smpl": 0.0}}
    for name in ("smpl_forward_ms_p50", "mesh_targets_ms",
                 "smpl_roofline.train"):
        assert spec.reader(name)(rec) is None, name


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny():
    cell = spec.load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["config"].update(TINY)
    cell.config["body_model"]["num_verts"] = 128
    cell.traffic = dict(cell.traffic, **SHRINK)
    return cell


def _run(faults=()):
    return run.run(_tiny(), 2 ** 31 + 4242, 0.6, False, torch.device("cpu"),
                   faults=faults)


def test_a_sound_mesh_run_is_correct():
    r = _run()
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["check"]) == set(spec.load_cell(CELL).limits["limits"])
    assert all(math.isfinite(v["value"]) for v in r["check"].values())


# each planted fault and the limits it fails (half a batch fed fails on
# its shape as well)
FAILS = {"frozen": {"grad_norm_gap_median", "update_norm_gap",
                    "head_update_gap"},
         "half_batch": {"vertex_err_mm", "head_vertex_err_mm",
                        "head_grad_gap", "head_update_gap"},
         "half_loss": {"head_grad_gap", "head_update_gap"}}


@pytest.mark.parametrize("fault", sorted(FAILS))
def test_a_broken_mesh_run_is_not_correct(fault):
    r = _run((fault,))
    assert not r["correct"], r["check"]
    failed = {k for k, v in r["check"].items() if not v["value"] <= v["limit"]}
    assert FAILS[fault] <= failed, r["check"]
