"""The representation networks, counterpart of
``hamgnn_tpu/models/representation.py``.

``HamGNNConvE3``: one-hot / charge-doped embedding -> edge SH -> RBF x
cutoff -> pair-interaction edge embedding -> chemical embedding ->
num_layers x (ConvBlockE3 [-> CorrProductBlock] -> PairInteractionBlock).
``HamGNNTransformer``: the same front end, then num_layers x
(AttentionBlockE3 -> CorrProductBlock -> PairInteractionBlock).  Both are
written once, against a ``GraphView`` (``models/view.py``): ``forward(graph)``
is ``forward_view(as_view(graph))``, and the halo edge partition calls
``forward_view`` with its collectives injected.  Under the partition each
ConvE3 layer runs an interior pass on owned source rows and a boundary pass on
the rows received from the peers (``nn/blocks.py``).  Padded edges get edge
length 1 so no 0-length vector reaches the radial basis.
``use_gradient_checkpointing`` (ConvE3 only, as in JAX) recomputes each
layer's ``ConvBlockE3.gathered_call``, ``CorrProductBlock``,
``PairInteractionBlock.lift`` and ``PairInteractionBlock.gathered_call`` in
the backward (the calls the JAX model wraps in ``flax.linen.remat``); the
exchanges run outside them, so the recompute issues no collective.
``ElectronConfigurationEmbedding`` lies on no model path; it is ported as a
public module.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.graph import Graph
from ..e3.irreps import Irreps
from ..e3.linear import Linear
from ..e3.spherical import spherical_harmonics
from ..e3.zonal_tp import FRAME_MEMO
from ..nn.attention import AttentionBlockE3
from ..nn.blocks import (ConvBlockE3, CorrProductBlock, PairInteractionBlock,
                         PairInteractionEmbeddingBlock)
from ..nn.electron_configurations import electron_configurations
from ..nn.mlp import FullyConnectedNet
from ..nn.radial import RBF_REGISTRY, cosine_cutoff, polynomial_envelope
from .view import as_view


class ChargeDopedOneHot(nn.Module):
    """One-hot(z) with an optional Gaussian-smeared doping-charge residual."""

    def __init__(self, num_types: int, apply_charge_doping: bool = False,
                 num_charge_attr_feas: int = 8):
        super().__init__()
        self.num_types = num_types
        self.apply_charge_doping = apply_charge_doping
        self.n = num_charge_attr_feas
        if apply_charge_doping:
            n = num_charge_attr_feas
            self.FullyConnectedNet_0 = FullyConnectedNet((n, n, n, num_types), "silu")

    def forward(self, z, doping_charge_per_node=None, dtype=torch.float32):
        types = torch.arange(self.num_types, device=z.device)
        one_hot = (z[:, None] == types).to(dtype)
        if not self.apply_charge_doping:
            return one_hot
        cmin, cmax = -8.0, 8.0
        n = self.n
        width = (cmax - cmin) / (n - 1) if n > 1 else 1.0
        centers = torch.linspace(cmin, cmax, n, device=z.device)
        gamma = 1.0 / width**2

        def smear(q):
            d = torch.clamp(q, cmin, cmax)[..., None] - centers
            return torch.exp(-gamma * d * d)

        mlp = self.FullyConnectedNet_0
        q = doping_charge_per_node
        return one_hot + mlp(smear(q)) - mlp(smear(torch.zeros_like(q)))


def _front_end(net: nn.Module, num_types, irreps_edge_sh, irreps_node_features,
               num_layers, num_radial, rbf_func, cutoff, cutoff_func, radial_mlp, use_kan,
               apply_charge_doping, num_charge_attr_feas) -> None:
    """The modules and settings both representation networks share:
    ``atomic_embedding``, the radial basis (flax's ``<class>_0``),
    ``pair_embedding`` and ``chemical_embedding``."""
    net.irreps_sh = Irreps(irreps_edge_sh)
    net.irreps_feat = Irreps(irreps_node_features)
    irreps_onehot = Irreps(f"{num_types}x0e")
    net.sh_ls = [ir.l for _, ir in net.irreps_sh]
    net.num_layers = num_layers
    net.cutoff = cutoff
    net.cutoff_func = cutoff_func
    net.atomic_embedding = ChargeDopedOneHot(num_types, apply_charge_doping,
                                             num_charge_attr_feas)
    rbf = RBF_REGISTRY[rbf_func](num_radial, cutoff)
    net.rbf_name = f"{type(rbf).__name__}_0"
    net.add_module(net.rbf_name, rbf)
    net.pair_embedding = PairInteractionEmbeddingBlock(
        irreps_onehot, net.irreps_feat, net.irreps_sh, num_radial, radial_mlp=radial_mlp,
        use_kan=use_kan)
    net.chemical_embedding = Linear(irreps_onehot, net.irreps_feat)


def _embed(net: nn.Module, view):
    """(node_attrs, edge_len, edge_sh, edge_scalars, edge_feats, node_feats)
    of a GraphView through the front end ``_front_end`` built on ``net``.
    The embedding is a function of (z, doping) per atom, so the edge
    endpoints' rows need no exchange."""
    dtype = net.chemical_embedding.w.dtype
    emb = net.atomic_embedding
    doping = emb.apply_charge_doping
    node_attrs = emb(view.z, view.doping_own if doping else None, dtype)
    onehot_src = emb(view.z_src, view.doping_src if doping else None, dtype)
    onehot_dst = emb(view.z_dst, view.doping_dst if doping else None, dtype)

    edge_vec = view.edge_vec
    edge_len = torch.sqrt(torch.sum(edge_vec * edge_vec, dim=-1))
    edge_len = torch.where(view.edge_mask, edge_len, torch.ones_like(edge_len))
    edge_sh = spherical_harmonics(net.sh_ls, edge_vec, normalize=True)
    rbf = getattr(net, net.rbf_name)(edge_len)
    cut = (polynomial_envelope(edge_len, net.cutoff)
           if net.cutoff_func.lower().startswith("pol")
           else cosine_cutoff(edge_len, net.cutoff))
    edge_scalars = rbf * cut[:, None]
    edge_feats = net.pair_embedding(onehot_src, onehot_dst, edge_sh, edge_scalars)
    node_feats = net.chemical_embedding(node_attrs)
    return node_attrs, edge_len, edge_sh, edge_scalars, edge_feats, node_feats


def _rows_at(recv, pos):
    """A thunk of the received rows at ``pos``: ``recv`` is the thunk of an
    exchange in flight (``GraphView.halo_start``); bound here, not in the
    layer loop, so a checkpointed layer's recompute reads its own exchange."""
    return lambda: recv()[pos]


class HamGNNConvE3(nn.Module):
    """Representation network producing {node_attr, edge_attr} features."""

    def __init__(self, num_types: int = 96,
                 irreps_edge_sh: str = "0e + 1o + 2e + 3o + 4e + 5o",
                 irreps_node_features: str = "64x0e+32x1o+16x2e",
                 num_layers: int = 3, num_radial: int = 64, rbf_func: str = "bessel",
                 cutoff: float = 26.0, cutoff_func: str = "cos",
                 radial_mlp: Sequence[int] = (64, 64), use_corr_prod: bool = False,
                 correlation: int = 2, num_hidden_features: int = 16,
                 use_kan: bool = False, lite_mode: bool = False,
                 apply_charge_doping: bool = False, num_charge_attr_feas: int = 8,
                 legacy_edge_update: bool = False,
                 use_gradient_checkpointing: bool = False):
        super().__init__()
        self.use_gradient_checkpointing = use_gradient_checkpointing
        self.use_corr_prod = use_corr_prod
        radial_mlp = tuple(radial_mlp)
        _front_end(self, num_types, irreps_edge_sh, irreps_node_features, num_layers,
                   num_radial, rbf_func, cutoff, cutoff_func, radial_mlp, use_kan,
                   apply_charge_doping, num_charge_attr_feas)
        for i in range(num_layers):
            self.add_module(f"conv_{i}", ConvBlockE3(
                self.irreps_feat, self.irreps_feat, self.irreps_sh, num_radial,
                radial_mlp=radial_mlp, use_skip_connections=True, use_kan=use_kan,
                lite_mode=lite_mode))
            if use_corr_prod:
                self.add_module(f"corr_{i}", CorrProductBlock(
                    self.irreps_feat, num_hidden_features, correlation, num_types))
            self.add_module(f"pair_{i}", PairInteractionBlock(
                self.irreps_feat, self.irreps_feat, self.irreps_sh, num_radial,
                radial_mlp=radial_mlp,
                use_skip_connections=(i > 0) if legacy_edge_update else True,
                use_kan=use_kan, lite_mode=lite_mode,
                legacy_edge_update=legacy_edge_update))

    def forward(self, graph: Graph):
        return self.forward_view(as_view(graph))

    @FRAME_MEMO.one_forward()  # the pipelines below run on this call's edge_sh
    def forward_view(self, view):
        node_attrs, edge_len, edge_sh, edge_scalars, edge_feats, node_feats = \
            _embed(self, view)
        remat = self.use_gradient_checkpointing and torch.is_grad_enabled()

        def call(fn, *args):
            # the model draws no random numbers: no RNG state to keep for the
            # recompute, and none read or set inside a captured step
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False) \
                if remat else fn(*args)

        overlap = view.boundary_pos is not None
        if overlap:
            # the overlap split: the interior pass reads owned source rows,
            # the boundary pass the rows the exchange received.  Each exchange
            # starts before its interior pass; the boundary tuple carries a
            # thunk that waits for the rows, which gathered_call calls after
            # the interior contraction
            b_pos, b_mask, halo_pos = view.boundary_pos, view.boundary_mask, view.src_halo_pos
            sh_b, scal_b, dst_b = edge_sh[b_pos], edge_scalars[b_pos], view.dst_index[b_pos]
        for i in range(self.num_layers):
            conv = getattr(self, f"conv_{i}")
            pair = getattr(self, f"pair_{i}")
            if overlap:
                src_b = _rows_at(view.halo_start(node_feats), halo_pos)
            dst_rows = view.gather_dst(node_feats)
            if overlap:
                boundary = (src_b, dst_rows[b_pos], edge_feats[b_pos], sh_b, scal_b, dst_b,
                            b_mask)
                node_feats = call(conv.gathered_call, node_feats,
                                  view.gather_src_interior(node_feats), dst_rows,
                                  edge_feats, edge_sh, edge_scalars, view.dst_index,
                                  view.interior_mask, boundary)
            else:
                node_feats = call(conv.gathered_call, node_feats,
                                  view.gather_src(node_feats), dst_rows, edge_feats,
                                  edge_sh, edge_scalars, view.dst_index, view.edge_mask)
            if self.use_corr_prod:
                node_feats = call(getattr(self, f"corr_{i}"), node_feats, node_attrs)
            up_src, up_dst = call(pair.lift, node_feats)
            if overlap:
                src_b = _rows_at(view.halo_start(up_src), halo_pos)
            up_dst_rows = view.gather_dst(up_dst)
            if overlap:
                boundary = (src_b, up_dst_rows[b_pos], edge_feats[b_pos], sh_b, scal_b, b_pos,
                            b_mask)
                edge_feats = call(pair.gathered_call, view.gather_src_interior(up_src),
                                  up_dst_rows, edge_feats, edge_sh, edge_scalars, boundary)
            else:
                edge_feats = call(pair.gathered_call, view.gather_src(up_src), up_dst_rows,
                                  edge_feats, edge_sh, edge_scalars)
        return {"node_attr": node_feats, "edge_attr": edge_feats}


class HamGNNTransformer(nn.Module):
    """Attention representation network: the ConvE3 front end, then per layer
    AttentionBlockE3 -> CorrProductBlock -> PairInteractionBlock (the
    correlation block always on; no lite mode and no checkpointing, as in
    JAX)."""

    def __init__(self, num_types: int = 96,
                 irreps_edge_sh: str = "0e + 1o + 2e + 3o + 4e + 5o",
                 irreps_node_features: str = "64x0e+32x1o+16x2e",
                 num_layers: int = 3, num_radial: int = 64, rbf_func: str = "bessel",
                 cutoff: float = 26.0, cutoff_func: str = "cos",
                 radial_mlp: Sequence[int] = (64, 64), num_heads: int = 4,
                 correlation: int = 2, num_hidden_features: int = 16,
                 use_kan: bool = False, apply_charge_doping: bool = False,
                 num_charge_attr_feas: int = 8):
        super().__init__()
        radial_mlp = tuple(radial_mlp)
        _front_end(self, num_types, irreps_edge_sh, irreps_node_features, num_layers,
                   num_radial, rbf_func, cutoff, cutoff_func, radial_mlp, use_kan,
                   apply_charge_doping, num_charge_attr_feas)
        for i in range(num_layers):
            self.add_module(f"orb_transformer_{i}", AttentionBlockE3(
                self.irreps_feat, self.irreps_feat, self.irreps_sh, num_radial,
                num_heads=num_heads, max_radius=cutoff, radial_mlp=radial_mlp,
                use_kan=use_kan))
            self.add_module(f"corr_{i}", CorrProductBlock(
                self.irreps_feat, num_hidden_features, correlation, num_types))
            self.add_module(f"pair_{i}", PairInteractionBlock(
                self.irreps_feat, self.irreps_feat, self.irreps_sh, num_radial,
                radial_mlp=radial_mlp, use_kan=use_kan))

    def forward(self, graph: Graph):
        return self.forward_view(as_view(graph))

    @FRAME_MEMO.one_forward()  # every pipeline below runs on this call's one edge_sh
    def forward_view(self, view):
        """The attention softmax and aggregation segment over the view's
        local destination index, which the destination-owned partition keeps
        on one rank."""
        node_attrs, edge_len, edge_sh, edge_scalars, edge_feats, node_feats = \
            _embed(self, view)
        for i in range(self.num_layers):
            node_feats = getattr(self, f"orb_transformer_{i}").gathered_call(
                node_feats, view.gather_src, view.gather_dst, edge_feats,
                edge_sh, edge_scalars, edge_len, view.dst_index, view.edge_mask)
            node_feats = getattr(self, f"corr_{i}")(node_feats, node_attrs)
            pair = getattr(self, f"pair_{i}")
            up_src, up_dst = pair.lift(node_feats)
            edge_feats = pair.gathered_call(view.gather_src(up_src), view.gather_dst(up_dst),
                                            edge_feats, edge_sh, edge_scalars)
        return {"node_attr": node_feats, "edge_attr": edge_feats}


class ElectronConfigurationEmbedding(nn.Module):
    """Z -> features: a learned per-element table plus a linear map of the
    scaled electron configuration.  ``element_embedding`` is drawn from
    U(0, 2 sqrt 3) and shifted by -sqrt 3 at apply time; ``config_linear`` is
    orthogonal."""

    def __init__(self, num_features: int, zmax: int = 87):
        super().__init__()
        table = torch.as_tensor(electron_configurations, dtype=torch.float32)
        self.register_buffer("table", table, persistent=False)
        self.element_embedding = nn.Parameter(torch.zeros(zmax, num_features))
        self.config_linear = nn.Parameter(torch.zeros(table.shape[1], num_features))

    def draw_parameters(self, gen: torch.Generator) -> None:
        self.element_embedding.copy_(
            torch.rand(self.element_embedding.shape, generator=gen) * (2 * 3 ** 0.5))
        nn.init.orthogonal_(self.config_linear, generator=gen)

    def forward(self, z):
        emb = (self.element_embedding - 3 ** 0.5) + self.table @ self.config_linear
        return emb[z]
