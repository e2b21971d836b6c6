"""Weighted Clebsch-Gordan tensor products with a static plan, counterpart of
``hamgnn_tpu/e3/tensor_product.py``.

The instructions are enumerated on the host, each (l1, l2, l3) path keeps its
Wigner-3j tensor (times its path normalisation) as a buffer, and the product
runs as a short chain of einsums.  Connection modes ``uvw`` and ``uvu``;
e3nn's defaults (``normalization='component'``, ``path_normalization=
'element'``): per instruction sqrt(ir_out.dim / sum of the elements into the
same output), sum-normalised 3j tensors, N(0, 1) weights named
``w<instruction index>``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .irreps import Irreps
from .wigner import wigner_3j


@dataclasses.dataclass(frozen=True)
class Instruction:
    i_in1: int
    i_in2: int
    i_out: int
    mode: str  # 'uvw' | 'uvu'
    has_weight: bool
    path_weight: float = 1.0  # the plan's normalisation alpha


def _num_elements(irreps_in1: Irreps, irreps_in2: Irreps, ins: Instruction) -> int:
    if ins.mode == "uvw":
        return irreps_in1[ins.i_in1].mul * irreps_in2[ins.i_in2].mul
    if ins.mode == "uvu":
        return irreps_in2[ins.i_in2].mul
    raise NotImplementedError(ins.mode)


class TensorProductPlan:
    """The instructions with their normalisation and weight shapes."""

    def __init__(self, irreps_in1, irreps_in2, irreps_out, instructions: Sequence[Tuple]):
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self.irreps_out = Irreps(irreps_out)

        ins_list: List[Instruction] = []
        for (i1, i2, io, mode, has_w) in instructions:
            mi1, mi2, mio = self.irreps_in1[i1], self.irreps_in2[i2], self.irreps_out[io]
            if mio.ir not in mi1.ir * mi2.ir:
                raise ValueError(f"{mi1.ir} x {mi2.ir} has no path to {mio.ir}")
            if mode == "uvu" and mio.mul != mi1.mul:
                raise ValueError(f"uvu instruction {(i1, i2, io)}: output multiplicity "
                                 f"{mio.mul} is not the first input's {mi1.mul}")
            ins_list.append(Instruction(i1, i2, io, mode, has_w))

        norm_ins: List[Instruction] = []
        for ins in ins_list:
            fan = sum(_num_elements(self.irreps_in1, self.irreps_in2, other)
                      for other in ins_list if other.i_out == ins.i_out)
            alpha = self.irreps_out[ins.i_out].ir.dim / max(fan, 1)
            norm_ins.append(dataclasses.replace(ins, path_weight=float(np.sqrt(alpha))))
        self.instructions: List[Instruction] = norm_ins

        self.weight_shapes: List[Optional[Tuple[int, ...]]] = []
        n = 0
        for ins in self.instructions:
            if not ins.has_weight:
                self.weight_shapes.append(None)
                continue
            mul1 = self.irreps_in1[ins.i_in1].mul
            mul2 = self.irreps_in2[ins.i_in2].mul
            mul3 = self.irreps_out[ins.i_out].mul
            shape = (mul1, mul2, mul3) if ins.mode == "uvw" else (mul1, mul2)
            self.weight_shapes.append(shape)
            n += int(np.prod(shape))
        self.weight_numel = n


def tp_out_irreps_with_instructions(irreps1, irreps2, target_irreps, mode: str = "uvw",
                                    trainable: bool = True) -> Tuple[Irreps, List[Tuple]]:
    """Every (in1 x in2 -> out) path whose output irrep is in
    ``target_irreps``; the output irreps sorted and the instructions remapped
    and sorted by output."""
    irreps1, irreps2, target_irreps = Irreps(irreps1), Irreps(irreps2), Irreps(target_irreps)
    out_list = []
    instructions = []
    for i, (mul_in, ir_in) in enumerate(irreps1):
        for j, (_, ir_edge) in enumerate(irreps2):
            for _, (mul_out, ir_out) in enumerate(target_irreps):
                if ir_out in ir_in * ir_edge:
                    k = len(out_list)
                    out_list.append((mul_out if mode == "uvw" else mul_in, ir_out))
                    instructions.append((i, j, k, mode, trainable))
    irreps_out, permut, _ = Irreps(out_list).sort()
    instructions = [(i1, i2, permut[io], m, t) for (i1, i2, io, m, t) in instructions]
    instructions = sorted(instructions, key=lambda x: x[2])
    return irreps_out, instructions


class TensorProduct(nn.Module):
    """Weighted CG tensor product with internal shared weights."""

    def __init__(self, irreps_in1, irreps_in2, irreps_out, instructions: Sequence[Tuple]):
        super().__init__()
        self.plan = TensorProductPlan(irreps_in1, irreps_in2, irreps_out, instructions)
        plan = self.plan
        self._slices = (plan.irreps_in1.slices(), plan.irreps_in2.slices())
        for idx, (ins, shape) in enumerate(zip(plan.instructions, plan.weight_shapes)):
            if shape is not None:
                self.register_parameter(f"w{idx}", nn.Parameter(torch.zeros(shape)))
            l1 = plan.irreps_in1[ins.i_in1].ir.l
            l2 = plan.irreps_in2[ins.i_in2].ir.l
            l3 = plan.irreps_out[ins.i_out].ir.l
            self.register_buffer(f"cg{idx}", torch.as_tensor(
                ins.path_weight * wigner_3j(l1, l2, l3), dtype=torch.float32),
                persistent=False)

    def forward(self, x1, x2):
        plan = self.plan
        batch = torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1])
        chunks = [None] * len(plan.irreps_out)
        for idx, (ins, shape) in enumerate(zip(plan.instructions, plan.weight_shapes)):
            mi1, mi2 = plan.irreps_in1[ins.i_in1], plan.irreps_in2[ins.i_in2]
            mio = plan.irreps_out[ins.i_out]
            x1c = x1[..., self._slices[0][ins.i_in1]]
            x2c = x2[..., self._slices[1][ins.i_in2]]
            x1c = x1c.reshape(x1c.shape[:-1] + (mi1.mul, mi1.ir.dim))
            x2c = x2c.reshape(x2c.shape[:-1] + (mi2.mul, mi2.ir.dim))
            cg = getattr(self, f"cg{idx}")
            w = getattr(self, f"w{idx}") if shape is not None else None
            if ins.mode == "uvw":
                tmp = torch.einsum("...ui,...vj,ijk->...uvk", x1c, x2c, cg)
                out = tmp.sum(dim=(-3, -2))[..., None, :] if w is None else \
                    torch.einsum("...uvk,uvw->...wk", tmp, w)
            elif ins.mode == "uvu":
                # the v-sum into x2 first: sum_v w_uv (x1_u (x) x2_v) ==
                # x1_u (x) (sum_v w_uv x2_v), no (..., u, v, k) intermediate
                x2w = x2c.sum(dim=-2)[..., None, :] if w is None else \
                    torch.einsum("...vj,uv->...uj", x2c, w)
                out = torch.einsum("...ui,...uj,ijk->...uk", x1c, x2w, cg)
            else:
                raise NotImplementedError(ins.mode)
            out = out.reshape(batch + (mio.dim,))
            prev = chunks[ins.i_out]
            chunks[ins.i_out] = out if prev is None else prev + out
        return torch.cat([c if c is not None else x1.new_zeros(batch + (mio.dim,))
                          for c, mio in zip(chunks, plan.irreps_out)], dim=-1)


class FullyConnectedTensorProduct(nn.Module):
    """All allowed uvw paths from (irreps_in1 x irreps_in2) into irreps_out."""

    def __init__(self, irreps_in1, irreps_in2, irreps_out):
        super().__init__()
        irreps1, irreps2, irreps_out = Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out)
        instructions = [
            (i, j, k, "uvw", True)
            for i, (_, ir1) in enumerate(irreps1)
            for j, (_, ir2) in enumerate(irreps2)
            for k, (_, ir3) in enumerate(irreps_out)
            if ir3 in ir1 * ir2
        ]
        self.tp = TensorProduct(irreps1, irreps2, irreps_out, tuple(instructions))

    def forward(self, x1, x2):
        return self.tp(x1, x2)
