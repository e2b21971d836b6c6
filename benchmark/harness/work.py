"""The benchmark's count of the work a configuration requires, and the
H100's peaks it is held against.

TP pipelines (``tp_work``): per edge, what the pipeline's instructions
require, whatever implements them: for each input chunk (mul, l1) and each
path to an output irrep l3 through an SH irrep l2, the coupling entries
W[i, k] = sum_j C[j, i, k] sh[j] (2 FLOPs a nonzero Clebsch-Gordan entry,
shared by the chunk's channels) and the mids mid[k, u] = sum_i W[i, k] x[u, i]
(2 d1 d3 FLOPs a channel); the radial scale (one product a mid element, with
radial weights); the Linear over the mids (2 fan_in mul_out d3 a row of each
output chunk).  Bytes: each input read once (x, sh, the radial weights, the
flat Linear weight) and the output written once; the backward reads x, sh,
the radial weights, the flat weight and the output gradient, and writes dx,
the radial weights' gradient and the flat weight's.  The backward's FLOPs are
the mids again (its inputs do not hold them), the two Linear-sized products
(dWcat, dBLK), the radial weights' gradient and dx through the coupling
entries; no padding is counted.

The model (``model_work``): every product of the reference model's forward
counted at its real rows from the module shapes (equivariant Linears,
radial MLPs, the heads' merge products, the TP pipelines above), per node
and per edge; elementwise work is not counted.  A training step counts three
forwards (the backward at twice the forward).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import numpy as np
import torch

# H100 SXM, NVIDIA's data sheet: dense fp32 on the CUDA cores, HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class TPWork:
    """Per-edge FLOPs and bytes of one TP pipeline, and its fixed bytes (the
    flat Linear weight)."""
    fwd_flops: int
    bwd_flops: int
    fwd_bytes_edge: int
    bwd_bytes_edge: int
    fixed_bytes: int

    def least_s(self, edges: int, backward: bool) -> float:
        """Least time on the H100 for ``edges`` edges: max(FLOPs / peak,
        bytes / bandwidth)."""
        flops = (self.bwd_flops if backward else self.fwd_flops) * edges
        per_edge = self.bwd_bytes_edge if backward else self.fwd_bytes_edge
        nbytes = per_edge * edges + self.fixed_bytes * (2 if backward else 1)
        return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def tp_paths(irreps_in, irreps_sh, target_irreps):
    """(mul, l1 irrep, l2 irrep, l3 irrep) of every path of the TP of
    ``irreps_in`` with ``irreps_sh`` onto an irrep of ``target_irreps``."""
    from reference.irreps import Irreps

    target = {mi.ir for mi in Irreps(target_irreps)}
    out = []
    for mul, ir1 in Irreps(irreps_in):
        for _, ir2 in Irreps(irreps_sh):
            for ir3 in ir1 * ir2:
                if ir3 in target:
                    out.append((mul, ir1, ir2, ir3))
    return out


def cg_nonzeros(l1: int, l2: int, l3: int) -> int:
    from reference.wigner import wigner_3j

    return int(np.count_nonzero(np.abs(wigner_3j(l1, l2, l3)) > 1e-12))


def tp_work(irreps_in, irreps_sh, target_irreps, irreps_out, has_w: bool) -> TPWork:
    from reference.irreps import Irreps

    paths = tp_paths(irreps_in, irreps_sh, target_irreps)
    fan_in: Dict = {}
    coupling = mids = scale = 0
    n_ch = 0
    for mul, ir1, ir2, ir3 in paths:
        coupling += 2 * cg_nonzeros(ir1.l, ir2.l, ir3.l)
        mids += 2 * ir1.dim * ir3.dim * mul
        scale += ir3.dim * mul
        n_ch += mul
        fan_in[ir3] = fan_in.get(ir3, 0) + mul
    linear = sum(2 * fan_in.get(mi.ir, 0) * mi.mul * mi.ir.dim for mi in Irreps(irreps_out))
    linear_numel = sum(fan_in.get(mi.ir, 0) * mi.mul for mi in Irreps(irreps_out))
    if not has_w:
        scale = 0
    fwd = coupling + mids + scale + linear
    dw = 2 * scale
    bwd = coupling + mids + scale + 2 * linear + dw + scale + mids
    d_in, d_sh, d_out = Irreps(irreps_in).dim, Irreps(irreps_sh).dim, Irreps(irreps_out).dim
    w_edge = n_ch if has_w else 0
    return TPWork(fwd_flops=fwd, bwd_flops=bwd,
                  fwd_bytes_edge=4 * (d_in + d_sh + w_edge + d_out),
                  bwd_bytes_edge=4 * (d_in + d_sh + w_edge + d_out + d_in + w_edge),
                  fixed_bytes=4 * linear_numel)


@dataclasses.dataclass
class ModelWork:
    """A forward's FLOPs per node and per edge, and the TP pipelines it runs
    (each on every edge), in call order."""
    flops_node: int
    flops_edge: int
    pipelines: List[TPWork]

    def forward_flops(self, nodes: int, edges: int) -> int:
        return self.flops_node * nodes + self.flops_edge * edges

    def tp_least_s(self, edges: int, backward: bool) -> float:
        return sum(p.least_s(edges, backward) for p in self.pipelines)


def linear_flops_per_row(lin) -> int:
    return sum(2 * fan_in * mio.mul * mio.ir.dim
               for (_src, fan_in, _ofs), mio in zip(lin._plans, lin.irreps_out))


def model_work(ref_model, probe_graph) -> ModelWork:
    """Count a forward of ``ref_model`` (the reference, on the CPU) on the
    small ``probe_graph`` by hooks: each product's rows are the graph's
    nodes or its edges, which must differ in number.  The TP pipelines are
    counted by ``tp_work`` and not run."""
    from reference import packed_tp
    from reference.linear import Linear
    from reference.mlp import FullyConnectedNet
    from reference.output import HamGNNPlusPlusOut
    from reference.soc import HamGNNSOCOut

    n, e = probe_graph.num_nodes, probe_graph.num_edges
    if n == e:
        raise ValueError("the probe graph needs different node and edge counts")
    per = {n: 0, e: 0}
    pipelines: List[TPWork] = []

    def add(rows, flops_row):
        if rows not in per:
            raise ValueError(f"a product on {rows} rows, neither {n} nodes nor {e} edges")
        per[rows] += flops_row

    def on_linear(mod, args, _out):
        add(args[0].reshape(-1, args[0].shape[-1]).shape[0], linear_flops_per_row(mod))

    def on_mlp(mod, args, _out):
        add(args[0].shape[0], sum(2 * a * b for a, b in zip(mod.hs[:-1], mod.hs[1:])))

    def counted_call(plan, x, sh, weight, flat_w):
        work = tp_work(plan.irreps_in, plan.irreps_sh, _target(plan), plan.irreps_out,
                       weight is not None)
        pipelines.append(work)
        add(x.shape[0], work.fwd_flops)
        return x.new_zeros((x.shape[0], plan.irreps_out.dim))

    hooks = []
    with contextlib.ExitStack() as stack:
        for mod in ref_model.modules():
            if isinstance(mod, Linear):
                hooks.append(mod.register_forward_hook(on_linear))
            elif isinstance(mod, FullyConnectedNet):
                hooks.append(mod.register_forward_hook(on_mlp))
        stack.callback(lambda: [h.remove() for h in hooks])
        saved = packed_tp.PackedTPPlan.__call__
        packed_tp.PackedTPPlan.__call__ = counted_call
        stack.callback(lambda: setattr(packed_tp.PackedTPPlan, "__call__", saved))
        with torch.no_grad():
            ref_model(probe_graph)
    head = ref_model.output
    if isinstance(head, HamGNNPlusPlusOut):
        merges = (2 if head.symmetrize else 1) * 2 * head.M.numel()
        per[n] += merges
        per[e] += merges
    elif isinstance(head, HamGNNSOCOut):
        mat = head.codec if head.soc_basis == "su2" else getattr(head, "merge", None)
        if mat is not None:
            per[n] += 2 * mat.numel()
            per[e] += 2 * mat.numel()
    return ModelWork(flops_node=per[n], flops_edge=per[e], pipelines=pipelines)


def _target(plan):
    """The target irreps a plan was built for (its key's third entry)."""
    return plan.key[2]
