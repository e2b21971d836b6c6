"""Combined model (representation + output head) and loss/metric computation,
counterpart of ``hamgnn_tpu/models/model.py``."""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch import nn

from ..data.graph import Graph
from ..train.losses import get_metric
from .view import GraphView


class HamGNNModel(nn.Module):
    def __init__(self, representation: nn.Module, output: nn.Module):
        super().__init__()
        self.representation = representation
        self.output = output

    def forward(self, graph: Graph, k_vecs=None) -> Dict[str, torch.Tensor]:
        """``k_vecs`` (B, nk, 3) Cartesian: the k-points of the band branch,
        for a head built with ``calculate_band_energy``.  Modules that speak
        GraphView run on one dense view of ``graph``."""
        kw = {} if k_vecs is None else {"k_vecs": k_vecs}
        if hasattr(self.representation, "forward_view") \
                and hasattr(self.output, "forward_view"):
            return self.forward_view(GraphView.dense(graph), **kw)
        return self.output(graph, self.representation(graph), **kw)

    def forward_view(self, view: GraphView, k_vecs=None) -> Dict[str, torch.Tensor]:
        """The forward over a GraphView: the halo edge partition calls it with
        its collectives injected, with the same parameters and arithmetic as
        ``forward``.  The magnetic head has none, and raises."""
        if not hasattr(self.output, "forward_view"):
            raise NotImplementedError(
                f"{type(self.output).__name__} has no GraphView forward")
        feats = self.representation.forward_view(view)
        return self.output.forward_view(view, feats, k_vecs=k_vecs)


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Draw every random weight from a ``torch.Generator`` seeded with
    ``seed``, module by module in ``named_parameters`` order.  A module with
    a ``draw_parameters(gen)`` method draws its own (the KAN layers' uniform
    weights, the electron embedding's) or keeps fixed initial values
    (``E3LayerNorm``'s ones); elsewhere the Linear ``w`` and the MLP and
    contraction ``w<i>`` parameters are drawn N(0, 1), as in the reference,
    and every other parameter keeps its fixed initial value."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            draw = getattr(module, "draw_parameters", None)
            if draw is not None:
                draw(gen)
                continue
            for leaf, p in module.named_parameters(recurse=False):
                if leaf == "w" or (leaf[0] == "w" and leaf[1:].isdigit()):
                    p.copy_(torch.randn(p.shape, generator=gen))
    return model


def _stack_pred_target(name: str, preds: Dict, graph):
    """Map a loss name to (pred rows, target rows, row mask); ``graph`` is a
    Graph or a GraphView (both carry the target and mask fields)."""
    nm = name.lower()
    if nm in ("hamiltonian", "overlap", "hamiltonian_real", "hamiltonian_imag"):
        # the SOC head's spinor rows: real against Hon/Hoff, imag against iHon/iHoff
        t_on, t_off = {"hamiltonian": (graph.Hon, graph.Hoff),
                       "overlap": (graph.Son, graph.Soff),
                       "hamiltonian_real": (graph.Hon, graph.Hoff),
                       "hamiltonian_imag": (graph.iHon, graph.iHoff)}[nm]
        pred = torch.cat([preds[f"{nm}_on"], preds[f"{nm}_off"]], 0)
        target = torch.cat([t_on, t_off], 0)
        mask = torch.cat([graph.node_mask, graph.edge_mask], 0)[:, None]
        return (pred.reshape(pred.shape[0], -1), target.reshape(target.shape[0], -1),
                mask)
    if nm == "band_energy":
        pred, target = preds["band_energy"], preds["band_energy_ref"]
        if "band_mask" in preds:
            # per-species band_num_control: only the bands below the
            # per-crystal count are physical
            mask = torch.broadcast_to(preds["band_mask"], pred.shape)
        else:
            mask = torch.ones(pred.shape[:1] + (1,) * (pred.ndim - 1), dtype=pred.dtype,
                              device=pred.device)
        return pred, target, mask
    if nm == "band_gap":
        pred = preds["band_gap"]
        return pred, preds["band_gap_ref"], torch.ones_like(pred)
    # generic result-dict keys: the target is the graph field of that name,
    # else the prediction's "<name>_ref" counterpart
    by_lower = {k.lower(): k for k in preds}
    if nm in by_lower:
        key = by_lower[nm]
        pred = preds[key]
        target = getattr(graph, name, None)
        if target is None:
            target = getattr(graph, key, None)
        if target is None:
            target = preds.get(key + "_ref")
        if target is None:
            raise KeyError(f"loss target '{name}': no graph field or '_ref' "
                           f"prediction; available predictions: {sorted(preds)}")
        mask = torch.ones((pred.shape[0], 1), dtype=torch.float32, device=pred.device)
        return pred.reshape(pred.shape[0], -1), target.reshape(target.shape[0], -1), mask
    raise KeyError(f"unknown loss target {name} (available predictions: {sorted(preds)})")


def compute_losses(preds: Dict[str, torch.Tensor], graph,
                   losses: Sequence[Dict[str, Any]], psum=None) -> Tuple[torch.Tensor, Dict]:
    """Weighted total loss + per-component logs; Hamiltonian components are
    scaled by the sparsity ratio, as in the reference.  ``graph``: a Graph or
    a GraphView; under the partition pass ``psum=view.psum``, so the masked
    means are global."""
    kw = {} if psum is None else {"psum": psum}
    total = torch.zeros((), dtype=torch.float32, device=graph.z.device)
    logs = {}
    for spec in losses:
        fn = get_metric(spec["metric"])
        pname = spec["prediction"].lower()
        if spec.get("target") is not None:
            pred, target, mask = _stack_pred_target(pname, preds, graph)
        else:
            pred = preds[pname].reshape(preds[pname].shape[0], -1)
            target = torch.zeros_like(pred)
            mask = torch.ones((pred.shape[0], 1), dtype=torch.float32, device=pred.device)
        value = fn(pred, target, mask, **kw)
        if pname in ("hamiltonian", "hamiltonian_real", "hamiltonian_imag") \
                and "sparsity_ratio" in preds:
            value = value * preds["sparsity_ratio"]
        logs[f"{spec['metric']}_{pname}"] = value
        total = total + spec.get("loss_weight", 1.0) * value
    return total, logs


def compute_metrics(preds, graph, metrics: Sequence[Dict[str, Any]], psum=None):
    kw = {} if psum is None else {"psum": psum}
    out = {}
    for spec in metrics:
        fn = get_metric(spec["metric"])
        pname = spec["prediction"].lower()
        pred, target, mask = _stack_pred_target(pname, preds, graph)
        value = fn(pred, target, mask, **kw)
        if pname.startswith("hamiltonian") and "sparsity_ratio" in preds:
            value = value * preds["sparsity_ratio"]
        out[f"{spec['metric']}_{pname}"] = value
    return out
