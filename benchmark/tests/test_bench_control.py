"""The control on the card: the reference in the program's place with TF32
on comes out not correct against each cell's limits, on three seeds, at
the cell's own size.  Run on the card with

    python -m pytest benchmark/tests/test_bench_control.py -q -m cuda
"""

import pytest
import torch

from bench_tiny import CELLS, ROOT
from harness import correct, spec

SEEDS = (3000000001, 3000000002, 3000000003)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("the control runs on the card (TF32 exists there only)")
    import control

    cell = spec.resolve(ROOT, name)
    for seed in SEEDS:
        readings = control.readings(cell, seed, 0.5, torch.device("cuda", 0))
        assert correct.judge(readings["program"], cell.limits), readings
        assert not correct.judge(readings["control"], cell.limits), readings
