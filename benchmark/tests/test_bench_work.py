"""The benchmark's work counts against independent enumerations."""

import numpy as np
import pytest
import torch

import bench_tiny  # noqa: F401  (puts the benchmark on the path)
from harness import work
from reference.linear import Linear
from reference.packed_tp import get_plan

CASES = [
    ("2x0e+1x1o", "0e+1o", "1x0e+1x1o", "3x0e+2x1o"),
    ("3x0e+2x1o+1x2e", "0e+1o+2e", "2x0e+2x1o+1x2e", "2x0e+2x1o+1x2e"),
    ("4x1o+2x3o", "0e+1o+2e+3o", "1x0e+1x2e+1x1o", "1x0e+2x2e+3x1o"),
]


def enumerate_forward(plan, has_w: bool):
    """FLOPs and per-edge floats of the pipeline by walking its plan: every
    nonzero coupling entry, every (mid column, channel, m1) product, every
    scaled mid, every (output element, row) product of the Linear."""
    flops = 0
    for _sl, mul, d1, C, groups in plan.per_chunk:
        for _j in range(C.shape[0]):
            for _i in range(d1):
                flops += 2 * int(np.count_nonzero(np.abs(C[_j, _i]) > 1e-12))
        K = C.shape[-1]
        for _k in range(K):
            for _u in range(mul):
                flops += 2 * d1 + (1 if has_w else 0)
    for (fan_in, _ofs), mio in zip(plan.out_plans, plan.irreps_out):
        for _v in range(mio.mul):
            for _m in range(mio.ir.dim):
                flops += 2 * fan_in
    floats = (plan.irreps_in.dim + plan.irreps_sh.dim + (plan.weight_numel if has_w else 0)
              + plan.irreps_out.dim)
    return flops, floats


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("has_w", [True, False])
def test_tp_work_forward_matches_an_enumeration(case, has_w):
    plan = get_plan(*case)
    count = work.tp_work(*case, has_w=has_w)
    flops, floats = enumerate_forward(plan, has_w)
    assert count.fwd_flops == flops
    assert count.fwd_bytes_edge == 4 * floats
    assert count.fixed_bytes == 4 * plan.linear_numel


@pytest.mark.parametrize("case", CASES)
def test_tp_backward_counts_its_products(case):
    """The backward holds the mids, two Linear-sized products, the radial
    weights' gradient and dx: more than the forward, less than three."""
    c = work.tp_work(*case, has_w=True)
    assert c.fwd_flops < c.bwd_flops < 3 * c.fwd_flops
    plan = get_plan(*case)
    d = plan.irreps_in.dim + plan.irreps_sh.dim + plan.weight_numel + plan.irreps_out.dim
    assert c.bwd_bytes_edge == 4 * (d + plan.irreps_in.dim + plan.weight_numel)


def test_least_time_takes_the_larger_bound():
    c = work.tp_work(*CASES[1], has_w=True)
    e = 10_000
    t = c.least_s(e, backward=False)
    assert t == pytest.approx(max(c.fwd_flops * e / work.PEAK_FP32_FLOPS,
                                  (c.fwd_bytes_edge * e + c.fixed_bytes)
                                  / work.PEAK_HBM_BYTES_PER_S))


@pytest.mark.parametrize("irreps", [("4x0e+2x1o", "3x0e+5x1o"), ("2x0e+2x2e+3x1o", "1x1o+4x2e")])
def test_linear_count_matches_torch_flop_counter(irreps):
    """(torch counts no product whose contraction has length 1, so every
    output irrep here has a fan-in of two or more.)"""
    from torch.utils.flop_counter import FlopCounterMode

    lin = Linear(*irreps)
    with torch.no_grad():
        lin.w.normal_()
    x = torch.randn(7, lin.irreps_in.dim)
    with FlopCounterMode(display=False) as counter:
        lin(x)
    assert counter.get_total_flops() == 7 * work.linear_flops_per_row(lin)
