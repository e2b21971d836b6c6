"""HamGNNConvE3, the E(3)-equivariant representation network, counterpart of
``hamgnn_tpu/models/representation.py`` (dense single-device view).

one-hot / charge-doped embedding -> edge SH -> RBF x cutoff -> pair-interaction
edge embedding -> chemical embedding -> num_layers x (ConvBlockE3 ->
PairInteractionBlock).  Padded edges get edge length 1 so no 0-length vector
reaches the radial basis.  ``use_gradient_checkpointing`` recomputes each
layer's ``ConvBlockE3.gathered_call``, ``PairInteractionBlock.lift`` and
``PairInteractionBlock.gathered_call`` in the backward (the calls the JAX
model wraps in ``flax.linen.remat``).
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
from ..nn.blocks import ConvBlockE3, PairInteractionBlock, PairInteractionEmbeddingBlock
from ..nn.mlp import FullyConnectedNet
from ..nn.radial import RBF_REGISTRY, cosine_cutoff, polynomial_envelope


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

    def forward(self, z, doping_charge_per_node=None):
        types = torch.arange(self.num_types, device=z.device)
        one_hot = (z[:, None] == types).to(torch.float32)
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


class HamGNNConvE3(nn.Module):
    """Representation network producing {node_attr, edge_attr} features."""

    def __init__(self, num_types: int = 96,
                 irreps_edge_sh: str = "0e + 1o + 2e + 3o + 4e + 5o",
                 irreps_node_features: str = "64x0e+32x1o+16x2e",
                 num_layers: int = 3, num_radial: int = 64, rbf_func: str = "bessel",
                 cutoff: float = 26.0, cutoff_func: str = "cos",
                 radial_mlp: Sequence[int] = (64, 64), lite_mode: bool = False,
                 apply_charge_doping: bool = False, num_charge_attr_feas: int = 8,
                 legacy_edge_update: bool = False,
                 use_gradient_checkpointing: bool = False):
        super().__init__()
        self.use_gradient_checkpointing = use_gradient_checkpointing
        self.irreps_sh = Irreps(irreps_edge_sh)
        self.irreps_feat = Irreps(irreps_node_features)
        irreps_onehot = Irreps(f"{num_types}x0e")
        self.sh_ls = [ir.l for _, ir in self.irreps_sh]
        self.num_layers = num_layers
        self.cutoff = cutoff
        self.cutoff_func = cutoff_func
        radial_mlp = tuple(radial_mlp)

        self.atomic_embedding = ChargeDopedOneHot(
            num_types, apply_charge_doping, num_charge_attr_feas)
        rbf = RBF_REGISTRY[rbf_func](num_radial, cutoff)
        self.rbf_name = f"{type(rbf).__name__}_0"
        self.add_module(self.rbf_name, rbf)
        self.pair_embedding = PairInteractionEmbeddingBlock(
            irreps_onehot, self.irreps_feat, self.irreps_sh, num_radial,
            radial_mlp=radial_mlp)
        self.chemical_embedding = Linear(irreps_onehot, self.irreps_feat)
        for i in range(num_layers):
            self.add_module(f"conv_{i}", ConvBlockE3(
                self.irreps_feat, self.irreps_feat, self.irreps_sh, num_radial,
                radial_mlp=radial_mlp, use_skip_connections=True,
                lite_mode=lite_mode))
            self.add_module(f"pair_{i}", PairInteractionBlock(
                self.irreps_feat, self.irreps_feat, self.irreps_sh, num_radial,
                radial_mlp=radial_mlp,
                use_skip_connections=(i > 0) if legacy_edge_update else True,
                lite_mode=lite_mode, legacy_edge_update=legacy_edge_update))

    @FRAME_MEMO.one_forward()  # every pipeline below runs on this call's one edge_sh
    def forward(self, graph: Graph):
        src, dst = graph.edge_index[0], graph.edge_index[1]
        doping = None
        if self.atomic_embedding.apply_charge_doping:
            doping = graph.doping_charge[graph.batch]
        node_attrs = self.atomic_embedding(graph.z, doping)
        onehot_src = self.atomic_embedding(
            graph.z[src], None if doping is None else doping[src])
        onehot_dst = self.atomic_embedding(
            graph.z[dst], None if doping is None else doping[dst])

        edge_vec = graph.edge_vectors()
        edge_len = torch.sqrt(torch.sum(edge_vec * edge_vec, dim=-1))
        edge_len = torch.where(graph.edge_mask, edge_len, torch.ones_like(edge_len))
        edge_sh = spherical_harmonics(self.sh_ls, edge_vec, normalize=True)
        rbf = getattr(self, self.rbf_name)(edge_len)
        cut = (polynomial_envelope(edge_len, self.cutoff)
               if self.cutoff_func.lower().startswith("pol")
               else cosine_cutoff(edge_len, self.cutoff))
        edge_scalars = rbf * cut[:, None]

        edge_feats = self.pair_embedding(onehot_src, onehot_dst, edge_sh, edge_scalars)
        node_feats = self.chemical_embedding(node_attrs)
        remat = self.use_gradient_checkpointing and torch.is_grad_enabled()

        def call(fn, *args):
            # the model draws no random numbers: no RNG state to keep for the
            # recompute, and none read or set inside a captured step
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False) \
                if remat else fn(*args)

        for i in range(self.num_layers):
            conv = getattr(self, f"conv_{i}")
            pair = getattr(self, f"pair_{i}")
            node_feats = call(conv.gathered_call,
                              node_feats, node_feats[src], node_feats[dst], edge_feats,
                              edge_sh, edge_scalars, dst, graph.edge_mask)
            up_src, up_dst = call(pair.lift, node_feats)
            edge_feats = call(pair.gathered_call, up_src[src], up_dst[dst], edge_feats,
                              edge_sh, edge_scalars)
        return {"node_attr": node_feats, "edge_attr": edge_feats}
