"""Each cell's control, at the cell's own size on the card, comes out not
correct under the cell's committed limits: a training cell's float8
reference in the program's place, a serving cell's W8A8 tier (the
program's own lower-precision path). On the card:

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q
"""

import pytest
import torch

from benchmark import spec
from benchmark.compare import judge
from benchmark.trace import Trace

SEED = 3000000299


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_training_control_is_not_correct(cuda):
    cell = spec.load_cell("train.motionbert.b32")
    c = spec.kind(cell.traffic["kind"]).Cell(cell, SEED, cuda,
                                             Trace(False, ()))
    ok, rows = judge(c.control_readings(), cell.limits["limits"])
    assert not ok, rows


@pytest.mark.cuda
def test_serving_control_is_not_correct(cuda):
    cell = spec.load_cell("serve.motionbert_lite.poisson")
    c = spec.kind(cell.traffic["kind"]).Cell(cell, SEED, cuda,
                                             Trace(False, ()),
                                             attn_impl="kernel_q8")
    c.setup()
    c.measure(3.0)
    ok, rows = judge(c.readings(), cell.limits["limits"])
    assert not ok, rows
