"""The ConvE3 representation network: a frozen copy of
``hamgnn_tpu_torch/models/representation.py`` (``HamGNNConvE3``), one device
only, without gradient checkpointing or the correlation product.

One-hot / charge-doped embedding -> edge SH -> RBF x cutoff ->
pair-interaction edge embedding -> chemical embedding -> num_layers x
(ConvBlockE3 -> PairInteractionBlock).  Padded edges get edge length 1 so no
0-length vector reaches the radial basis.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .graph import Graph
from .irreps import Irreps
from .linear import Linear
from .spherical import spherical_harmonics
from .blocks import ConvBlockE3, PairInteractionBlock, PairInteractionEmbeddingBlock
from .mlp import FullyConnectedNet
from .radial import RBF_REGISTRY, cosine_cutoff, polynomial_envelope
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


class HamGNNConvE3(nn.Module):
    """Representation network producing {node_attr, edge_attr} features."""

    def __init__(self, num_types: int = 96,
                 irreps_edge_sh: str = "0e + 1o + 2e + 3o + 4e + 5o",
                 irreps_node_features: str = "64x0e+32x1o+16x2e",
                 num_layers: int = 3, num_radial: int = 64, rbf_func: str = "bessel",
                 cutoff: float = 26.0, cutoff_func: str = "cos",
                 radial_mlp: Sequence[int] = (64, 64), use_kan: bool = False,
                 lite_mode: bool = False, apply_charge_doping: bool = False,
                 num_charge_attr_feas: int = 8):
        super().__init__()
        radial_mlp = tuple(radial_mlp)
        _front_end(self, num_types, irreps_edge_sh, irreps_node_features, num_layers,
                   num_radial, rbf_func, cutoff, cutoff_func, radial_mlp, use_kan,
                   apply_charge_doping, num_charge_attr_feas)
        for i in range(num_layers):
            self.add_module(f"conv_{i}", ConvBlockE3(
                self.irreps_feat, self.irreps_feat, self.irreps_sh, num_radial,
                radial_mlp=radial_mlp, use_skip_connections=True, use_kan=use_kan,
                lite_mode=lite_mode))
            self.add_module(f"pair_{i}", PairInteractionBlock(
                self.irreps_feat, self.irreps_feat, self.irreps_sh, num_radial,
                radial_mlp=radial_mlp, use_skip_connections=True, use_kan=use_kan,
                lite_mode=lite_mode))

    def forward(self, graph: Graph):
        view = as_view(graph)
        node_attrs, edge_len, edge_sh, edge_scalars, edge_feats, node_feats = \
            _embed(self, view)
        for i in range(self.num_layers):
            conv = getattr(self, f"conv_{i}")
            pair = getattr(self, f"pair_{i}")
            node_feats = conv.gathered_call(
                node_feats, view.gather_src(node_feats), view.gather_dst(node_feats),
                edge_feats, edge_sh, edge_scalars, view.dst_index, view.edge_mask)
            up_src, up_dst = pair.lift(node_feats)
            edge_feats = pair.gathered_call(view.gather_src(up_src), view.gather_dst(up_dst),
                                            edge_feats, edge_sh, edge_scalars)
        return {"node_attr": node_feats, "edge_attr": edge_feats}
