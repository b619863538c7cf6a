"""The whole run past its look for a card, on the CPU at a tiny size, with
each committed cell's own limits: a sound run comes out correct, and a run
with its timed path broken underneath comes out not correct, once for each
fault the cell can have (a state left unchanged, half of a batch left out,
an answer altered where it is produced; the cells run on one card, so no
exchange between cards can be left out)."""

import copy

import pytest
import torch

from benchmark import run, spec

TINY = dict(dim_feat=64, dim_rep=32, depth=1, num_heads=2, mlp_ratio=2,
            maxlen=27)
SHRINK = {
    "train.motionbert.b32": dict(batch=8, frames=27, pool=32,
                                 reference_chunk=4),
    "serve.motionbert_lite.poisson": dict(frames=27, pool=32, rate_per_s=300,
                                          sample=32, batch_buckets=[1, 8],
                                          max_wait_ms=20, reference_chunk=8),
}
FAULTS = {"train.motionbert.b32": ["frozen", "half_batch"],
          "serve.motionbert_lite.poisson": ["stale", "half_batch",
                                            "altered"]}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(workload):
    cell = spec.load_cell(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["config"].update(TINY)
    cell.traffic = dict(cell.traffic, **SHRINK[workload])
    return cell


def _run(workload, faults=()):
    return run.run(_tiny(workload), 2 ** 31 + 12345, 0.6, False,
                   torch.device("cpu"), faults=faults)


@pytest.mark.parametrize("workload", sorted(SHRINK))
def test_a_sound_run_is_correct(workload):
    r = _run(workload)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-2:] == ["check", "_readings"]


@pytest.mark.parametrize("workload, fault", [
    (w, f) for w in sorted(FAULTS) for f in FAULTS[w]])
def test_a_broken_run_is_not_correct(workload, fault):
    r = _run(workload, (fault,))
    assert not r["correct"], r["check"]
