"""Equivariant GNN blocks: a frozen copy of ``hamgnn_tpu_torch/nn/blocks.py``
for one device (no halo boundary pass, no correlation product, no V2 block).

``ConvBlockE3.gathered_call`` and ``PairInteractionBlock.gathered_call`` take
pre-gathered endpoint rows.  Module attribute names are the program's, so
one set of named weights loads into both.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .fused_tp import mid_irreps
from .gate import NormActivation, make_gate
from .irreps import Irreps
from .linear import ElementwiseChannelScale, Linear
from .mlp import add_generator, make_weight_generator


def segment_sum(messages, receiver, num_nodes: int):
    """Edge-to-node aggregation with a static output size."""
    out = messages.new_zeros((num_nodes,) + messages.shape[1:])
    return out.index_add_(0, receiver, messages)


def fuse_src_dst(irreps, src_feats, dst_feats):
    """Interleave src/dst features into doubled-multiplicity irreps: each
    (mul, ir) chunk becomes (2*mul, ir) = [src muls | dst muls]."""
    chunks = []
    for sl in Irreps(irreps).slices():
        chunks.append(src_feats[..., sl])
        chunks.append(dst_feats[..., sl])
    return torch.cat(chunks, dim=-1)


class ResidualBlock(nn.Module):
    """linear -> Gate/NormActivation -> linear (+ resnet)."""

    def __init__(self, irreps_in, irreps_hidden, resnet: bool = True,
                 nonlinearity_type: str = "gate",
                 nonlinearity_scalars: Tuple[str, str] = ("ssp", "tanh"),
                 nonlinearity_gates: Tuple[str, str] = ("ssp", "abs")):
        super().__init__()
        irreps_in = Irreps(irreps_in)
        irreps_hidden = Irreps(irreps_hidden)
        self.resnet = resnet
        if nonlinearity_type == "gate":
            gate, gate_in = make_gate(irreps_hidden, nonlinearity_scalars,
                                      nonlinearity_gates)
            self.linear1 = Linear(irreps_in, gate_in)
            self.act = gate
            self.linear2 = Linear(gate.irreps_out, irreps_in)
        else:
            self.linear1 = Linear(irreps_in, irreps_hidden)
            self.act = NormActivation(irreps_hidden, nonlinearity_scalars[0])
            self.linear2 = Linear(irreps_hidden, irreps_in)

    def forward(self, x):
        h = self.linear2(self.act(self.linear1(x)))
        return x + h if self.resnet else h


class MessagePackBlock(nn.Module):
    """Edge message: fused (src, dst) node features x edge SH and edge
    features x edge SH, each through the packed TP -> radial scale -> Linear
    pipeline, then an equivariant Linear each, summed.  ``lite_mode`` runs
    both pipelines without radial weights and scales their sum instead."""

    def __init__(self, irreps_node_feats, irreps_edge_feats, irreps_local_env_edge,
                 irreps_out, num_edge_scalars: int,
                 radial_mlp: Sequence[int] = (64, 64), use_kan: bool = False,
                 lite_mode: bool = False):
        super().__init__()
        self.irreps_node = Irreps(irreps_node_feats)
        self.irreps_edge = Irreps(irreps_edge_feats)
        self.irreps_sh = Irreps(irreps_local_env_edge)
        irreps_out = Irreps(irreps_out)
        self.lite_mode = lite_mode
        self.combined = Irreps([(2 * mul, ir) for mul, ir in self.irreps_node])
        mid_node = mid_irreps(self.combined, self.irreps_sh, irreps_out)
        mid_edge = mid_irreps(self.irreps_edge, self.irreps_sh, irreps_out)

        if lite_mode:
            self.node_scaler = Linear(mid_node.simplify(), irreps_out)
            self.edge_scaler = Linear(mid_edge.simplify(), irreps_out)
            self.combine = ElementwiseChannelScale(irreps_out.simplify(), irreps_out)
            self._gen = (add_generator(self, 0, make_weight_generator(
                num_edge_scalars, radial_mlp, self.combine.weight_numel, use_kan)),)
            return
        self.node_scaler = ElementwiseChannelScale(mid_node.simplify(), irreps_out)
        self.edge_scaler = ElementwiseChannelScale(mid_edge.simplify(), irreps_out)
        node_plan = self.node_scaler.packed_plan(self.combined, self.irreps_sh)
        edge_plan = self.edge_scaler.packed_plan(self.irreps_edge, self.irreps_sh)
        # the radial generators emit packed channel order directly
        self._gen = (
            add_generator(self, 0, make_weight_generator(
                num_edge_scalars, radial_mlp, self.node_scaler.weight_numel,
                use_kan, out_perm=node_plan.scale_perm)),
            add_generator(self, 1, make_weight_generator(
                num_edge_scalars, radial_mlp, self.edge_scaler.weight_numel,
                use_kan, out_perm=edge_plan.scale_perm)))
        self.node_out = Linear(irreps_out, irreps_out)
        self.edge_out = Linear(irreps_out, irreps_out)

    def forward(self, node_feats_src, node_feats_dst, edge_feats, local_env_edge,
                edge_scalars):
        node_inter = fuse_src_dst(self.irreps_node, node_feats_src, node_feats_dst)
        if self.lite_mode:
            node_dn = self.node_scaler.packed_tp_call(
                self.combined, self.irreps_sh, node_inter, local_env_edge)
            edge_dn = self.edge_scaler.packed_tp_call(
                self.irreps_edge, self.irreps_sh, edge_feats, local_env_edge)
            w = getattr(self, self._gen[0])(edge_scalars)
            return self.combine(node_dn + edge_dn, w)
        w_node = getattr(self, self._gen[0])(edge_scalars)
        w_edge = getattr(self, self._gen[1])(edge_scalars)
        node_dn = self.node_scaler.packed_tp_call(
            self.combined, self.irreps_sh, node_inter, local_env_edge, w_node,
            weight_packed=True)
        edge_dn = self.edge_scaler.packed_tp_call(
            self.irreps_edge, self.irreps_sh, edge_feats, local_env_edge, w_edge,
            weight_packed=True)
        return self.node_out(node_dn) + self.edge_out(edge_dn)


class ConvBlockE3(nn.Module):
    """Node update: skip + segment-sum of edge messages + residual."""

    def __init__(self, irreps_in, irreps_out, irreps_edge_attrs, num_edge_scalars: int,
                 radial_mlp: Sequence[int] = (64, 64, 64),
                 use_skip_connections: bool = True, use_kan: bool = False,
                 lite_mode: bool = False):
        super().__init__()
        irreps_in = Irreps(irreps_in)
        irreps_out = Irreps(irreps_out)
        if use_skip_connections:
            self.skip = Linear(irreps_in, irreps_out)
        else:
            self.skip = None
        self.conv_tp = MessagePackBlock(
            irreps_in, irreps_in, irreps_edge_attrs, irreps_out, num_edge_scalars,
            radial_mlp=radial_mlp, use_kan=use_kan, lite_mode=lite_mode)
        self.residual = ResidualBlock(irreps_out, irreps_out)

    def gathered_call(self, node_feats_own, src_feats, dst_feats, edge_feats,
                      edge_sh, edge_scalars, dst_idx, edge_mask):
        num_nodes = node_feats_own.shape[0]
        messages = self.conv_tp(src_feats, dst_feats, edge_feats, edge_sh,
                                edge_scalars)
        messages = messages * edge_mask[:, None].to(messages.dtype)
        agg = segment_sum(messages, dst_idx, num_nodes)
        out = self.residual(agg)
        if self.skip is not None:
            out = out + self.skip(node_feats_own)
        return out

    def forward(self, node_feats, edge_feats, edge_sh, edge_scalars, edge_index,
                edge_mask):
        src, dst = edge_index[0], edge_index[1]
        return self.gathered_call(node_feats, node_feats[src], node_feats[dst],
                                  edge_feats, edge_sh, edge_scalars, dst, edge_mask)


class PairInteractionBlock(nn.Module):
    """Edge update from lifted node features.  ``legacy_edge_update``:
    without skip connections the edge features pass through unchanged (the
    mix still runs so parameter shapes match)."""

    def __init__(self, irreps_node_feats, irreps_edge_feats, irreps_edge_attrs,
                 num_edge_scalars: int, radial_mlp: Sequence[int] = (64, 64, 64),
                 use_skip_connections: bool = True, use_kan: bool = False,
                 lite_mode: bool = False, legacy_edge_update: bool = False):
        super().__init__()
        irreps_node = Irreps(irreps_node_feats)
        irreps_edge = Irreps(irreps_edge_feats)
        self.use_skip_connections = use_skip_connections
        self.legacy_edge_update = legacy_edge_update
        self.linear_up_src = Linear(irreps_node, irreps_node)
        self.linear_up_tar = Linear(irreps_node, irreps_node)
        self.conv_tp = MessagePackBlock(
            irreps_node, irreps_edge, irreps_edge_attrs, irreps_edge,
            num_edge_scalars, radial_mlp=radial_mlp, use_kan=use_kan,
            lite_mode=lite_mode)
        if use_skip_connections:
            self.skip = Linear(irreps_edge, irreps_edge)

    def lift(self, node_feats):
        return self.linear_up_src(node_feats), self.linear_up_tar(node_feats)

    def gathered_call(self, src_lifted, dst_lifted, edge_feats, edge_sh, edge_scalars):
        mix = self.conv_tp(src_lifted, dst_lifted, edge_feats, edge_sh, edge_scalars)
        if self.use_skip_connections:
            return mix + self.skip(edge_feats)
        if self.legacy_edge_update:
            return edge_feats
        return mix

    def forward(self, node_feats, edge_feats, edge_sh, edge_scalars, edge_index):
        src, dst = edge_index[0], edge_index[1]
        up_src, up_dst = self.lift(node_feats)
        return self.gathered_call(up_src[src], up_dst[dst], edge_feats, edge_sh,
                                  edge_scalars)


class PairInteractionEmbeddingBlock(nn.Module):
    """Initial edge features: TP of (lin(src) + lin(dst)) with the edge SH,
    scaled per channel by radial weights, through the packed pipeline."""

    def __init__(self, irreps_node_feats, irreps_edge_feats, irreps_edge_attrs,
                 num_edge_scalars: int, radial_mlp: Sequence[int] = (64, 64, 64),
                 use_kan: bool = False):
        super().__init__()
        self.irreps_node = Irreps(irreps_node_feats)
        irreps_out = Irreps(irreps_edge_feats)
        self.irreps_sh = Irreps(irreps_edge_attrs)
        self.linear_up_src = Linear(self.irreps_node, self.irreps_node)
        self.linear_up_dst = Linear(self.irreps_node, self.irreps_node)
        mid = mid_irreps(self.irreps_node, self.irreps_sh, irreps_out)
        self.scaler = ElementwiseChannelScale(mid.simplify(), irreps_out)
        plan = self.scaler.packed_plan(self.irreps_node, self.irreps_sh)
        self._gen = add_generator(self, 0, make_weight_generator(
            num_edge_scalars, radial_mlp, self.scaler.weight_numel, use_kan,
            out_perm=plan.scale_perm))

    def forward(self, src_rows, dst_rows, edge_sh, edge_scalars):
        """``src_rows``/``dst_rows``: (E, D) node features of each edge's
        endpoints (the lift linears commute with the gather)."""
        x = self.linear_up_src(src_rows) + self.linear_up_dst(dst_rows)
        w = getattr(self, self._gen)(edge_scalars)
        return self.scaler.packed_tp_call(self.irreps_node, self.irreps_sh, x,
                                          edge_sh, w, weight_packed=True)
