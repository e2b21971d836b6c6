"""Equivariant graph attention, counterpart of ``hamgnn_tpu/nn/attention.py``:
multi-head irreps head split, dot-product edge logits, a cutoff-weighted
softmax over each destination node's edges, and the weighted sum of the
values, with masked segment ops (padded edges get zero attention).

Every op has a static size and reads nothing back to the host, so a step
through it can be captured as a CUDA graph.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..e3.irreps import Irreps
from ..e3.linear import Linear
from .blocks import MessagePackBlock, ResidualBlock, segment_sum
from .radial import SoftUnitStepCutoff


def heads_irreps(irreps, num_heads: int) -> Irreps:
    """Per-head irreps: the multiplicities divided by ``num_heads``."""
    return Irreps([(max(1, int(mul / num_heads)), ir) for mul, ir in Irreps(irreps)])


def split_heads(x, irreps, num_heads: int):
    """(N, irreps.dim) -> (N, H, head_dim): each chunk reshaped to (H,
    mul // H * dim), then concatenated.  Raises ValueError on a chunk whose
    multiplicity ``num_heads`` does not divide (the JAX reshape fails there)."""
    irreps = Irreps(irreps)
    pieces = []
    for sl, (mul, ir) in zip(irreps.slices(), irreps):
        if mul % num_heads:
            raise ValueError(f"chunk {mul}x{ir}: {num_heads} heads do not divide its "
                             f"multiplicity {mul}")
        pieces.append(x[..., sl].reshape(x.shape[:-1] + (num_heads, (mul // num_heads) * ir.dim)))
    return torch.cat(pieces, dim=-1)


def merge_heads(x, head_irreps):
    """(N, H, head_dim) -> (N, H * head_dim) per chunk, the inverse of
    ``split_heads``."""
    pieces = []
    ofs = 0
    n, h, _ = x.shape
    for mul, ir in Irreps(head_irreps):
        d = mul * ir.dim
        pieces.append(x[:, :, ofs: ofs + d].reshape(n, h * d))
        ofs += d
    return torch.cat(pieces, dim=-1)


def edge_softmax(logits, dst, num_nodes: int, edge_mask=None):
    """Numerically stable softmax of per-edge logits (E,) or (E, H) over the
    edges of each destination node.  Masked edges get weight 0; a node
    without edges gets none."""
    if edge_mask is not None:
        mask = edge_mask[:, None] if logits.ndim == 2 else edge_mask
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    index = dst[:, None].expand_as(logits) if logits.ndim == 2 else dst
    # the shift by the segment max has no gradient in exact arithmetic (it
    # cancels between numerator and denominator), so it is taken without
    # one, and no amax backward runs
    with torch.no_grad():
        seg_max = torch.full((num_nodes,) + logits.shape[1:], -math.inf,
                             dtype=logits.dtype, device=logits.device)
        seg_max = seg_max.scatter_reduce(0, index, logits, "amax", include_self=False)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    ex = torch.exp(logits - seg_max[dst])
    if edge_mask is not None:
        ex = ex * mask.to(ex.dtype)
    denom = segment_sum(ex, dst, num_nodes)
    return ex / torch.clamp(denom[dst], min=1e-12)


class AttentionBlockE3(nn.Module):
    """Node update by multi-head equivariant attention: keys from the source
    and queries from the destination nodes, values from a MessagePackBlock,
    logits scaled by a soft cutoff of the edge length, a residual block and a
    Linear skip."""

    def __init__(self, irreps_in, irreps_out, irreps_edge_attrs, num_edge_scalars: int,
                 num_heads: int = 4, max_radius: float = 6.0,
                 radial_mlp: Sequence[int] = (64, 64, 64),
                 use_skip_connections: bool = True, use_kan: bool = False):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        irreps_out = Irreps(irreps_out)
        self.num_heads = num_heads
        self.h_irreps = heads_irreps(self.irreps_in, num_heads)
        self.skip = Linear(self.irreps_in, irreps_out) if use_skip_connections else None
        self.linear_key = Linear(self.irreps_in, self.irreps_in)
        self.linear_key2 = Linear(self.irreps_in, self.irreps_in)
        self.conv_tp_value = MessagePackBlock(
            self.irreps_in, self.irreps_in, irreps_edge_attrs, self.irreps_in,
            num_edge_scalars, radial_mlp=tuple(radial_mlp), use_kan=use_kan)
        self.linear_up_src = Linear(self.irreps_in, self.irreps_in)
        self.linear_up_tar = Linear(self.irreps_in, self.irreps_in)
        self.linear_up_edge = Linear(self.irreps_in, self.irreps_in)
        self.cutoff = SoftUnitStepCutoff(max_radius)
        self.residual = ResidualBlock(self.irreps_in, irreps_out)

    def gathered_call(self, node_feats_own, gather_src, gather_dst, edge_feats, edge_sh,
                      edge_scalars, edge_len, dst_idx, edge_mask):
        """The block with the endpoint gathers passed in (the per-node
        Linears run on the node rows, then are gathered)."""
        num_nodes = node_feats_own.shape[0]
        key = gather_src(self.linear_key(node_feats_own))
        query = gather_dst(self.linear_key2(node_feats_own))
        value = self.conv_tp_value(
            gather_src(self.linear_up_src(node_feats_own)),
            gather_dst(self.linear_up_tar(node_feats_own)),
            self.linear_up_edge(edge_feats), edge_sh, edge_scalars)

        k_h = split_heads(key, self.irreps_in, self.num_heads)
        q_h = split_heads(query, self.irreps_in, self.num_heads)
        v_h = split_heads(value, self.irreps_in, self.num_heads)
        logits = (q_h * k_h).sum(dim=-1)                                  # (E, H)
        logits = self.cutoff(edge_len)[:, None] * logits / math.sqrt(self.h_irreps.dim)
        w = edge_softmax(logits, dst_idx, num_nodes, edge_mask)
        agg = segment_sum(w[:, :, None] * v_h, dst_idx, num_nodes)
        out = self.residual(merge_heads(agg, self.h_irreps))
        if self.skip is not None:
            out = out + self.skip(node_feats_own)
        return out

    def forward(self, node_feats, edge_feats, edge_sh, edge_scalars, edge_len, edge_index,
                edge_mask):
        src, dst = edge_index[0], edge_index[1]
        return self.gathered_call(node_feats, lambda rows: rows[src], lambda rows: rows[dst],
                                  edge_feats, edge_sh, edge_scalars, edge_len, dst, edge_mask)
