"""Reference-parametrization (e3nn-compat) execution path and the full
reference-checkpoint import, counterpart of
``hamgnn_tpu/interfaces/e3nn_compat.py``.

The native path fuses e3nn's ``o3.TensorProduct`` internal uvw weights into
the post-scale equivariant Linear (the packed TP kernels): a different
parametrization, so a checkpoint of the reference cannot be loaded into it
weight for weight.  These modules mirror the reference's module structure
instead:

    MessagePackBlock   = TP (internal uvw weights) -> LinearScaleWithWeights
                         (per-channel radial scale + o3.Linear) -> Linear out
    ConvBlockE3        = skip Linear + scatter-sum + ResidualBlock
    PairInteraction[Embedding]Block
    HamGNNConvE3Compat (the reference's models/hamgnn_conv.py)

with attribute names equal to the JAX package's flax scope names (which are
the reference's attribute names), so ``state_dict`` keys are the flax keys
with ``/`` -> ``.``; plus ``map_reference_state``, the automatic
state_dict -> parameter mapping (o3.Linear reindex, per-instruction TP weight
split, FCN copy).  The uvw products run as the plain einsums of
``e3/tensor_product.py``, as the JAX package runs them outside any Pallas
kernel; no hand-written kernel lies on this path.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.graph import Graph
from ..e3.gate import make_gate
from ..e3.irreps import Irreps
from ..e3.linear import ElementwiseChannelScale, Linear
from ..e3.spherical import spherical_harmonics
from ..e3.tensor_product import (TensorProduct, TensorProductPlan,
                                 tp_out_irreps_with_instructions)
from ..nn.blocks import CorrProductBlock, ResidualBlock, fuse_src_dst, segment_sum
from ..nn.mlp import FullyConnectedNet
from ..nn.radial import RBF_REGISTRY, cosine_cutoff
from .torch_ckpt import convert_o3_linear_weight

# ---------------------------------------------------------------------------
# compat blocks
# ---------------------------------------------------------------------------


def _weight_gen(num_in: int, radial_mlp, numel: int) -> FullyConnectedNet:
    return FullyConnectedNet((num_in, *radial_mlp, numel), "silu")


class MessagePackBlockCompat(nn.Module):
    """Reference-parametrized edge message kernel (the reference's
    nn/message_passing.py MessagePackBlock)."""

    def __init__(self, irreps_node_feats, irreps_edge_feats, irreps_sh, irreps_out,
                 num_edge_scalars: int, radial_mlp=(64, 64)):
        super().__init__()
        self.irreps_node = Irreps(irreps_node_feats)
        irreps_edge = Irreps(irreps_edge_feats)
        irreps_sh = Irreps(irreps_sh)
        irreps_out = Irreps(irreps_out)
        combined = Irreps([(2 * mul, ir) for mul, ir in self.irreps_node])
        mid_n, ins_n = tp_out_irreps_with_instructions(combined, irreps_sh, irreps_out)
        mid_e, ins_e = tp_out_irreps_with_instructions(irreps_edge, irreps_sh, irreps_out)
        self.node_tensor_product = TensorProduct(combined, irreps_sh, mid_n, tuple(ins_n))
        self.edge_tensor_product = TensorProduct(irreps_edge, irreps_sh, mid_e,
                                                 tuple(ins_e))
        self.node_linear_scaler = ElementwiseChannelScale(mid_n.simplify(), irreps_out)
        self.edge_linear_scaler = ElementwiseChannelScale(mid_e.simplify(), irreps_out)
        self.node_weight_generator = _weight_gen(
            num_edge_scalars, radial_mlp, self.node_linear_scaler.weight_numel)
        self.edge_weight_generator = _weight_gen(
            num_edge_scalars, radial_mlp, self.edge_linear_scaler.weight_numel)
        self.node_linear_out = Linear(irreps_out, irreps_out)
        self.edge_linear_out = Linear(irreps_out, irreps_out)

    def forward(self, src_feats, dst_feats, edge_feats, edge_sh, edge_scalars):
        node_inter = fuse_src_dst(self.irreps_node, src_feats, dst_feats)
        up_n = self.node_tensor_product(node_inter, edge_sh)
        up_e = self.edge_tensor_product(edge_feats, edge_sh)
        dn_n = self.node_linear_scaler(up_n, self.node_weight_generator(edge_scalars))
        dn_e = self.edge_linear_scaler(up_e, self.edge_weight_generator(edge_scalars))
        return self.node_linear_out(dn_n) + self.edge_linear_out(dn_e)


class TPWithMemoryOptCompat(nn.Module):
    """The reference's TensorProductWithMemoryOptimizationWithWeight."""

    def __init__(self, irreps_in1, irreps_in2, irreps_out, num_edge_scalars: int,
                 radial_mlp=(64, 64)):
        super().__init__()
        irreps1, irreps2 = Irreps(irreps_in1), Irreps(irreps_in2)
        irreps_out = Irreps(irreps_out)
        mid, ins = tp_out_irreps_with_instructions(irreps1, irreps2, irreps_out)
        self.tensor_product = TensorProduct(irreps1, irreps2, mid, tuple(ins))
        self.linear_scaler = ElementwiseChannelScale(mid.simplify(), irreps_out)
        self.weight_generator = _weight_gen(num_edge_scalars, radial_mlp,
                                            self.linear_scaler.weight_numel)

    def forward(self, x1, x2, edge_scalars):
        up = self.tensor_product(x1, x2)
        return self.linear_scaler(up, self.weight_generator(edge_scalars))


class PairInteractionEmbeddingBlockCompat(nn.Module):
    def __init__(self, irreps_node_attrs, irreps_edge_feats, irreps_sh,
                 num_edge_scalars: int, radial_mlp=(64, 64)):
        super().__init__()
        irreps_attr = Irreps(irreps_node_attrs)
        self.linear_up_src = Linear(irreps_attr, irreps_attr)
        self.linear_up_dst = Linear(irreps_attr, irreps_attr)
        self.conv_tp = TPWithMemoryOptCompat(irreps_attr, irreps_sh, irreps_edge_feats,
                                             num_edge_scalars, radial_mlp)

    def forward(self, node_attrs, edge_sh, edge_scalars, edge_index):
        src, dst = edge_index[0], edge_index[1]
        x = self.linear_up_src(node_attrs)[src] + self.linear_up_dst(node_attrs)[dst]
        return self.conv_tp(x, edge_sh, edge_scalars)


class ConvBlockE3Compat(nn.Module):
    def __init__(self, irreps_in, irreps_out, irreps_sh, num_edge_scalars: int,
                 radial_mlp=(64, 64), use_skip_connections: bool = True):
        super().__init__()
        irreps_in, irreps_out = Irreps(irreps_in), Irreps(irreps_out)
        self.skip_linear = Linear(irreps_in, irreps_out) if use_skip_connections else None
        self.conv_tp = MessagePackBlockCompat(irreps_in, irreps_in, irreps_sh, irreps_out,
                                              num_edge_scalars, radial_mlp)
        self.residual = ResidualBlock(irreps_out, irreps_out)

    def forward(self, node_feats, edge_feats, edge_sh, edge_scalars, edge_index,
                edge_mask):
        src, dst = edge_index[0], edge_index[1]
        messages = self.conv_tp(node_feats[src], node_feats[dst], edge_feats, edge_sh,
                                edge_scalars)
        messages = messages * edge_mask[:, None].to(messages.dtype)
        out = self.residual(segment_sum(messages, dst, node_feats.shape[0]))
        return out if self.skip_linear is None else out + self.skip_linear(node_feats)


class PairInteractionBlockCompat(nn.Module):
    def __init__(self, irreps_node_feats, irreps_edge_feats, irreps_sh,
                 num_edge_scalars: int, radial_mlp=(64, 64),
                 use_skip_connections: bool = True, legacy_edge_update: bool = False):
        super().__init__()
        irreps_node, irreps_edge = Irreps(irreps_node_feats), Irreps(irreps_edge_feats)
        self.legacy_edge_update = legacy_edge_update
        self.linear_up_src = Linear(irreps_node, irreps_node)
        self.linear_up_tar = Linear(irreps_node, irreps_node)
        self.conv_tp = MessagePackBlockCompat(irreps_node, irreps_edge, irreps_sh,
                                              irreps_edge, num_edge_scalars, radial_mlp)
        self.skip_linear = Linear(irreps_edge, irreps_edge) if use_skip_connections \
            else None

    def forward(self, node_feats, edge_feats, edge_sh, edge_scalars, edge_index):
        if self.skip_linear is None and self.legacy_edge_update:
            # the message block's parameters exist (flax creates them before
            # the branch) but the legacy update keeps the edge features
            return edge_feats
        src, dst = edge_index[0], edge_index[1]
        mix = self.conv_tp(self.linear_up_src(node_feats)[src],
                           self.linear_up_tar(node_feats)[dst], edge_feats, edge_sh,
                           edge_scalars)
        return mix if self.skip_linear is None else mix + self.skip_linear(edge_feats)


class _Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with the kernel (in, out)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def draw_parameters(self, gen: torch.Generator) -> None:
        """flax's default: LeCun-normal kernel, zero bias."""
        fan_in = self.kernel.shape[0]
        self.kernel.copy_(torch.randn(self.kernel.shape, generator=gen) / np.sqrt(fan_in))
        self.bias.zero_()

    def forward(self, x):
        return x @ self.kernel + self.bias


class DenseRegressionCompat(nn.Module):
    """The reference's ``denseRegression`` with use_batch_norm=False:
    (n_h-1) x [Linear+bias -> Softplus] -> Linear+bias.  Torch Linear weights
    are (out, in); the import transposes them into (in, out) kernels."""

    def __init__(self, in_features: int, out_features: int, n_h: int = 2):
        super().__init__()
        self.n_h = n_h
        for i in range(n_h - 1):
            self.add_module(f"fc_{i}", _Dense(in_features, in_features))
        self.fc_out = _Dense(in_features, out_features)

    def forward(self, x):
        for i in range(self.n_h - 1):
            x = F.softplus(getattr(self, f"fc_{i}")(x))
        return self.fc_out(x)


def _one_hot(z, num_types: int, dtype):
    """one-hot(z) by comparison, as the native embedding makes it: zeros for
    a type out of range, as ``jax.nn.one_hot`` gives.  ``F.one_hot`` checks
    the range of ``z`` on the host (on the CPU, and on the card in some
    PyTorch builds), which a CUDA graph cannot capture."""
    return (z[:, None] == torch.arange(num_types, device=z.device)).to(dtype)


class ChargeDopedOneHotCompat(nn.Module):
    """The reference's ``Embedding_block_q``: one-hot + mlp_q(smear(q)) -
    mlp_q(smear(0))."""

    def __init__(self, num_types: int, num_charge_attr_feas: int = 8):
        super().__init__()
        self.num_types = num_types
        self.n = num_charge_attr_feas
        self.mlp_q = DenseRegressionCompat(num_charge_attr_feas, num_types)

    def forward(self, z, per_node_charge):
        one_hot = _one_hot(z, self.num_types, per_node_charge.dtype)
        cmin, cmax = -8.0, 8.0
        n = self.n
        width = (cmax - cmin) / (n - 1) if n > 1 else 1.0
        centers = torch.linspace(cmin, cmax, n, device=z.device)
        gamma = 1.0 / width**2

        def smear(q):
            d = torch.clamp(q, cmin, cmax)[..., None] - centers
            return torch.exp(-gamma * d * d)

        q = smear(per_node_charge)
        neutral = smear(torch.zeros_like(per_node_charge))
        return one_hot + self.mlp_q(q) - self.mlp_q(neutral)


class HamGNNConvE3Compat(nn.Module):
    """Reference-parametrized representation network for imported
    checkpoints, producing {node_attr, edge_attr} features."""

    def __init__(self, num_types: int = 96,
                 irreps_edge_sh: str = "0e + 1o + 2e + 3o + 4e + 5o",
                 irreps_node_features: str = "64x0e+32x1o+16x2e",
                 num_layers: int = 3, num_radial: int = 64, rbf_func: str = "bessel",
                 cutoff: float = 26.0, radial_mlp=(64, 64),
                 legacy_edge_update: bool = False, use_corr_prod: bool = False,
                 correlation: int = 2, num_hidden_features: int = 16,
                 apply_charge_doping: bool = False, num_charge_attr_feas: int = 8):
        super().__init__()
        irreps_sh = Irreps(irreps_edge_sh)
        irreps_feat = Irreps(irreps_node_features)
        irreps_onehot = Irreps(f"{num_types}x0e")
        radial_mlp = tuple(radial_mlp)
        self.num_types = num_types
        self.num_layers = num_layers
        self.cutoff = cutoff
        self.sh_ls = [ir.l for _, ir in irreps_sh]
        self.use_corr_prod = use_corr_prod
        self.apply_charge_doping = apply_charge_doping
        if apply_charge_doping:
            self.atomic_embedding = ChargeDopedOneHotCompat(num_types, num_charge_attr_feas)
        self.radial_basis = RBF_REGISTRY[rbf_func](num_radial, cutoff)
        self.pair_embedding = PairInteractionEmbeddingBlockCompat(
            irreps_onehot, irreps_feat, irreps_sh, num_radial, radial_mlp)
        self.chemical_embedding = Linear(irreps_onehot, irreps_feat)
        for i in range(num_layers):
            self.add_module(f"convolutions_{i}", ConvBlockE3Compat(
                irreps_feat, irreps_feat, irreps_sh, num_radial, radial_mlp))
            if use_corr_prod:
                self.add_module(f"corr_products_{i}", CorrProductBlock(
                    irreps_feat, num_hidden_features, correlation, num_types,
                    use_skip_connections=True))
            self.add_module(f"pair_interactions_{i}", PairInteractionBlockCompat(
                irreps_feat, irreps_feat, irreps_sh, num_radial, radial_mlp,
                use_skip_connections=(i > 0) if legacy_edge_update else True,
                legacy_edge_update=legacy_edge_update))

    def forward(self, graph: Graph):
        if self.apply_charge_doping and graph.doping_charge is not None:
            node_attrs = self.atomic_embedding(graph.z, graph.doping_charge[graph.batch])
        else:
            node_attrs = _one_hot(graph.z, self.num_types, graph.pos.dtype)
        edge_vec = graph.edge_vectors()
        edge_len = torch.sqrt(torch.sum(edge_vec * edge_vec, dim=-1))
        edge_len = torch.where(graph.edge_mask, edge_len, torch.ones_like(edge_len))
        edge_sh = spherical_harmonics(self.sh_ls, edge_vec, normalize=True)
        rbf = self.radial_basis(edge_len)
        edge_scalars = rbf * cosine_cutoff(edge_len, self.cutoff)[:, None]

        edge_feats = self.pair_embedding(node_attrs, edge_sh, edge_scalars,
                                         graph.edge_index)
        node_feats = self.chemical_embedding(node_attrs)
        for i in range(self.num_layers):
            node_feats = getattr(self, f"convolutions_{i}")(
                node_feats, edge_feats, edge_sh, edge_scalars, graph.edge_index,
                graph.edge_mask)
            if self.use_corr_prod:
                node_feats = getattr(self, f"corr_products_{i}")(node_feats, node_attrs)
            edge_feats = getattr(self, f"pair_interactions_{i}")(
                node_feats, edge_feats, edge_sh, edge_scalars, graph.edge_index)
        return {"node_attr": node_feats, "edge_attr": edge_feats}


# ---------------------------------------------------------------------------
# automatic state_dict -> parameter mapping
# ---------------------------------------------------------------------------


def split_e3nn_tp_weight(flat: np.ndarray, irreps1, irreps2, irreps_out,
                         instructions) -> Dict[str, np.ndarray]:
    """e3nn TensorProduct flat internal ``weight`` -> the per-instruction
    ``w{idx}`` dict (same instruction order, row-major shapes)."""
    plan = TensorProductPlan(irreps1, irreps2, irreps_out, instructions)
    flat = np.asarray(flat).reshape(-1)
    out: Dict[str, np.ndarray] = {}
    ofs = 0
    for idx, shape in enumerate(plan.weight_shapes):
        if shape is None:
            continue
        n = int(np.prod(shape))
        out[f"w{idx}"] = flat[ofs : ofs + n].reshape(shape)
        ofs += n
    if ofs != flat.size:
        raise ValueError(f"TP weight numel {flat.size} != expected {ofs}")
    return out


def _gate_in_irreps(irreps: Irreps) -> Tuple[Irreps, Irreps]:
    gate, gate_in = make_gate(Irreps(irreps))
    return Irreps(gate_in), Irreps(gate.irreps_out)


# buffers in the reference state_dict that carry no parameters
_BUFFER_MARKERS = ("U_matrix_", "charge_centers", "charge_gamma",
                   "neutral_charge_attrs", ".cutoff_func.",
                   "cg_calculator", "oyzx2spin", "Us_openmx",
                   "hamiltonian_irreps_dimensions")

# reference attribute names -> this package's (applied in order)
_RENAMES = (
    ("convolutions.", "convolutions_"),
    ("pair_interactions.", "pair_interactions_"),
    ("corr_products.", "corr_products_"),
    (".prod.linear.", ".prod_linear."),
    ("chemical_embedding.linear", "chemical_embedding"),
    ("onsite_hamiltonian_network.", "onsite_hamiltonian."),
    ("offsite_hamiltonian_network.", "offsite_hamiltonian."),
    ("onsite_overlap_network.", "onsite_overlap."),
    ("offsite_overlap_network.", "offsite_overlap."),
    ("onsite_ksi_network.", "onsite_ksi."),
    ("offsite_ksi_network.", "offsite_ksi."),
    ("residual_block.", "residual."),
    ("linear_transform", "head"),
    ("radial_basis.basis.", "radial_basis."),
)


def _ours_path(ref_key: str) -> str:
    for old, new in _RENAMES:
        ref_key = ref_key.replace(old, new)
    return ref_key.replace(".", "/")


def reference_state_shapes(*, num_types: int, irreps_node_features, irreps_edge_sh,
                           num_layers: int, irreps_ham, num_radial: int,
                           radial_mlp=(64, 64)) -> Dict[str, Tuple[int, ...]]:
    """The keys and shapes of the reference's Lightning ``state_dict`` for a
    ``HamGNNConvE3`` of these widths with the two Hamiltonian heads (e3nn's
    flat weights, the Bessel frequencies, the radial FCN layers): what
    ``map_reference_state`` reads, so a synthetic checkpoint of any width
    can be made from it."""
    feat = Irreps(irreps_node_features)
    sh = Irreps(irreps_edge_sh)
    onehot = Irreps(f"{num_types}x0e")
    combined = Irreps([(2 * mul, ir) for mul, ir in feat])
    gate_in, gate_out = _gate_in_irreps(feat)
    shapes: Dict[str, Tuple[int, ...]] = {}

    def lin(key, ir_in, ir_out):
        n = sum(mi.mul * mo.mul for mi in Irreps(ir_in) for mo in Irreps(ir_out)
                if mi.ir == mo.ir)
        shapes[f"{key}.weight"] = (n,)

    def tp(key, i1, i2, io, ins):
        shapes[f"{key}.weight"] = (TensorProductPlan(i1, i2, io, ins).weight_numel,)

    def fcn(key, numel):
        hs = (num_radial, *radial_mlp, numel)
        for i in range(len(hs) - 1):
            shapes[f"{key}.layers.{i}.weight"] = (hs[i], hs[i + 1])

    def msgpack(base):
        for side, ir1 in (("node", combined), ("edge", feat)):
            mid, ins = tp_out_irreps_with_instructions(ir1, sh, feat)
            tp(f"{base}.{side}_tensor_product", ir1, sh, mid, ins)
            lin(f"{base}.{side}_linear_scaler.linear_out", mid.simplify(), feat)
            lin(f"{base}.{side}_linear_out", feat, feat)
            fcn(f"{base}.{side}_weight_generator", mid.simplify().num_irreps)

    R = "representation."
    shapes[R + "radial_basis.basis.bessel_weights"] = (num_radial,)
    lin(R + "chemical_embedding.linear", onehot, feat)
    lin(R + "pair_embedding.linear_up_src", onehot, onehot)
    lin(R + "pair_embedding.linear_up_dst", onehot, onehot)
    mid, ins = tp_out_irreps_with_instructions(onehot, sh, feat)
    tp(R + "pair_embedding.conv_tp.tensor_product", onehot, sh, mid, ins)
    lin(R + "pair_embedding.conv_tp.linear_scaler.linear_out", mid.simplify(), feat)
    fcn(R + "pair_embedding.conv_tp.weight_generator", mid.simplify().num_irreps)
    for i in range(num_layers):
        lin(R + f"convolutions.{i}.skip_linear", feat, feat)
        lin(R + f"convolutions.{i}.residual.linear1", feat, gate_in)
        lin(R + f"convolutions.{i}.residual.linear2", gate_out, feat)
        msgpack(R + f"convolutions.{i}.conv_tp")
        for name in ("linear_up_src", "linear_up_tar", "skip_linear"):
            lin(R + f"pair_interactions.{i}.{name}", feat, feat)
        msgpack(R + f"pair_interactions.{i}.conv_tp")
    for head in ("onsite_hamiltonian", "offsite_hamiltonian"):
        base = f"output_module.{head}_network"
        lin(f"{base}.residual_block.linear1", feat, gate_in)
        lin(f"{base}.residual_block.linear2", gate_out, feat)
        lin(f"{base}.linear_transform", feat, Irreps(irreps_ham))
    return shapes


def map_reference_state(state: Mapping[str, np.ndarray], *,
                        num_types: int,
                        irreps_node_features,
                        irreps_edge_sh,
                        num_layers: int,
                        irreps_ham,
                        rep_prefix: str = "representation.",
                        out_prefix: str = "output_module.",
                        use_corr_prod: bool = False,
                        correlation: int = 2,
                        num_hidden_features: int = 16,
                        apply_charge_doping: bool = False,
                        ham_only: bool = True,
                        soc_basis: Optional[str] = None,
                        irreps_ham_su2=None,
                        nao_max: Optional[int] = None,
                        add_H_nonsoc: bool = False,
                        ) -> Dict[str, np.ndarray]:
    """Reference Lightning ``state_dict`` -> flat assignments for a
    {"representation": HamGNNConvE3Compat, "output": head} model (paths
    "/"-joined for ``interfaces.torch_ckpt.assign_params``).

    Covers the HamGNNConvE3 stack (o3.Linear reindexed, TP internal weights
    split per instruction, radial FCNs, Bessel frequencies), the
    CorrProductBlock / MACE symmetric-contraction weights, the charge-doping
    embedding, the overlap heads and the SOC su2/so3 heads.  Raises KeyError
    for any reference key it does not understand, so coverage failures are
    loud.  ``apply_charge_doping`` is accepted for the JAX signature; the
    doping keys are recognised by name.
    """
    feat = Irreps(irreps_node_features)
    sh = Irreps(irreps_edge_sh)
    onehot = Irreps(f"{num_types}x0e")
    combined = Irreps([(2 * mul, ir) for mul, ir in feat])
    ham = Irreps(irreps_ham)
    gate_in_feat, gate_out_feat = _gate_in_irreps(feat)

    mid_n, ins_n = tp_out_irreps_with_instructions(combined, sh, feat)
    mid_pe, ins_pe = tp_out_irreps_with_instructions(onehot, sh, feat)

    # site tables: linear sites -> (irreps_in, irreps_out), tp sites -> specs
    linears: Dict[str, Tuple[Irreps, Irreps]] = {
        "representation/chemical_embedding": (onehot, feat),
        "representation/pair_embedding/linear_up_src": (onehot, onehot),
        "representation/pair_embedding/linear_up_dst": (onehot, onehot),
        "representation/pair_embedding/conv_tp/linear_scaler/linear_out":
            (mid_pe.simplify(), feat),
    }
    tps: Dict[str, Tuple[Irreps, Irreps, Irreps, list]] = {
        "representation/pair_embedding/conv_tp/tensor_product":
            (onehot, sh, mid_pe, ins_pe),
    }
    fcns = {"representation/pair_embedding/conv_tp/weight_generator"}

    def add_msgpack(base: str, irreps_edge_in: Irreps):
        mid_e_l, ins_e_l = tp_out_irreps_with_instructions(irreps_edge_in, sh, feat)
        tps[f"{base}/node_tensor_product"] = (combined, sh, mid_n, ins_n)
        tps[f"{base}/edge_tensor_product"] = (irreps_edge_in, sh, mid_e_l, ins_e_l)
        linears[f"{base}/node_linear_scaler/linear_out"] = (mid_n.simplify(), feat)
        linears[f"{base}/edge_linear_scaler/linear_out"] = (mid_e_l.simplify(), feat)
        linears[f"{base}/node_linear_out"] = (feat, feat)
        linears[f"{base}/edge_linear_out"] = (feat, feat)
        fcns.add(f"{base}/node_weight_generator")
        fcns.add(f"{base}/edge_weight_generator")

    for i in range(num_layers):
        conv = f"representation/convolutions_{i}"
        linears[f"{conv}/skip_linear"] = (feat, feat)
        linears[f"{conv}/residual/linear1"] = (feat, gate_in_feat)
        linears[f"{conv}/residual/linear2"] = (gate_out_feat, feat)
        add_msgpack(f"{conv}/conv_tp", feat)
        pair = f"representation/pair_interactions_{i}"
        linears[f"{pair}/linear_up_src"] = (feat, feat)
        linears[f"{pair}/linear_up_tar"] = (feat, feat)
        linears[f"{pair}/skip_linear"] = (feat, feat)
        add_msgpack(f"{pair}/conv_tp", feat)

    # --- output heads (HamLayer = residual + linear head) ---------------
    heads: List[Tuple[str, Irreps]] = []
    if soc_basis == "su2":
        if irreps_ham_su2 is None:
            raise ValueError("su2 import needs irreps_ham_su2")
        su2 = Irreps(irreps_ham_su2)
        doubled = su2 + su2
        heads += [("onsite_hamiltonian", doubled), ("offsite_hamiltonian", doubled)]
    else:
        if not (soc_basis == "so3" and add_H_nonsoc):
            heads += [("onsite_hamiltonian", ham), ("offsite_hamiltonian", ham)]
        if soc_basis == "so3":
            if nao_max is None:
                raise ValueError("so3 import needs nao_max")
            ksi = Irreps(f"{nao_max * nao_max}x0e")
            heads += [("onsite_ksi", ksi), ("offsite_ksi", ksi)]
    if not ham_only:
        heads += [("onsite_overlap", ham), ("offsite_overlap", ham)]
    for head, irreps_out_head in heads:
        base = f"output/{head}"
        linears[f"{base}/residual/linear1"] = (feat, gate_in_feat)
        linears[f"{base}/residual/linear2"] = (gate_out_feat, feat)
        linears[f"{base}/head"] = (feat, irreps_out_head)

    # --- corr_products (MACE symmetric contraction) ---------------------
    feat_s = feat.simplify()
    hidden = Irreps([(num_hidden_features, ir) for _, ir in feat_s])
    if use_corr_prod:
        for i in range(num_layers):
            cp = f"representation/corr_products_{i}"
            linears[f"{cp}/linear_pre"] = (feat_s, hidden)
            linears[f"{cp}/linear_sc"] = (feat_s, feat_s)
            linears[f"{cp}/prod_linear"] = (hidden, hidden)
            linears[f"{cp}/linear_out"] = (hidden, feat_s)
    hidden_irs = [ir for _, ir in feat_s]

    assignments: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        if any(m in key for m in _BUFFER_MARKERS):
            continue
        if (soc_basis == "so3" and add_H_nonsoc and key.startswith(out_prefix)
                and "hamiltonian_network" in key):
            # present in the reference checkpoint but unused at inference:
            # under add_H_nonsoc the spatial H comes from the stage-1 model
            continue
        if key.startswith(rep_prefix):
            path = "representation/" + _ours_path(key[len(rep_prefix):])
        elif key.startswith(out_prefix):
            path = "output/" + _ours_path(key[len(out_prefix):])
        else:
            raise KeyError(f"unrecognized state_dict key {key!r}")

        if path.endswith("/bessel_weights"):
            assignments[path] = np.asarray(value)
            continue

        # charge-doping mlp_q (denseRegression, n_h=2, no batch norm):
        # fcs.{i}.0.{weight,bias} -> fc_{i}/{kernel,bias}; fc_out likewise;
        # torch Linear weight (out, in) -> transposed into the kernel
        m = re.search(r"/mlp_q/(?:fcs/(\d+)/0|fc_out)/(weight|bias)$", path)
        if m is not None:
            layer = "fc_out" if m.group(1) is None else f"fc_{m.group(1)}"
            base = path[: m.start()] + "/mlp_q/" + layer
            if m.group(2) == "weight":
                assignments[base + "/kernel"] = np.asarray(value).T
            else:
                assignments[base + "/bias"] = np.asarray(value)
            continue

        # MACE symmetric-contraction weights:
        # .../prod/symmetric_contractions/contractions/{j}/weights_max -> the
        # nu=correlation tensor of contraction_{ir_j}; /weights/{k} -> the
        # nu=correlation-1-k tensor.  The contraction here divides its
        # parameter by num_params at use (MACE only at init), so imported
        # values are multiplied by num_params.
        m = re.search(r"/prod/symmetric_contractions/contractions/(\d+)/"
                      r"(weights_max|weights/(\d+))$", path)
        if m is not None:
            if np.asarray(value).shape[1] == 0:
                continue  # zero-path order: no matching parameter here
            j = int(m.group(1))
            nu = (correlation if m.group(2) == "weights_max"
                  else correlation - 1 - int(m.group(3)))
            ir_j = hidden_irs[j]
            base = path[: path.index("/prod/symmetric_contractions")]
            num_params = int(np.asarray(value).shape[1])
            assignments[f"{base}/prod/contraction_{ir_j}/w{nu}"] = (
                np.asarray(value) * num_params)
            continue

        if not path.endswith("/weight"):
            raise KeyError(f"no mapping for reference key {key!r}")
        site = path[: -len("/weight")]
        if site in linears:
            ir_in, ir_out = linears[site]
            assignments[site + "/w"] = convert_o3_linear_weight(value, ir_in, ir_out)
        elif site in tps:
            i1, i2, io, ins = tps[site]
            for wname, wval in split_e3nn_tp_weight(value, i1, i2, io, ins).items():
                assignments[f"{site}/{wname}"] = wval
        else:
            # FCN layer weights: site = <fcn>/layers/<i>
            parts = site.rsplit("/layers/", 1)
            if len(parts) == 2 and parts[0] in fcns:
                assignments[f"{parts[0]}/w{parts[1]}"] = np.asarray(value)
            else:
                raise KeyError(f"no mapping for reference key {key!r}")
    return assignments
