"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``benchmark/reference``), computed on the same
inputs and weights once the window has closed.

Training: the first steps of the run (``reference_steps`` of the traffic),
as the program took them in set-up through ``Trainer.train_step``, against
the reference's own steps from the same weights on the same crystals:

* ``loss_gap``: the largest |L - L_ref| / |L_ref| over the steps;
* ``grad_gap``: the first gradient as the optimizer got it (its first moment
  after one step over (1 - b1)), by the worst leaf: | |g| - |g_ref| | over
  max(|g_ref|, the median leaf's |g_ref|);
* ``change_gap``: the parameters' change over the steps, by the worst leaf
  in the same way, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move by rounding alone).

Prediction: ``h_gap``, the widest gap of a sampled prediction's Hamiltonian
(real and imaginary parts apart) from the reference's, over the largest
magnitude of the reference's.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import numpy as np
import torch

# leaves whose reference gradient norm is below this share of the median
# leaf's are left out of change_gap
ROUNDING_LEAF = 1e-3


def hamiltonian_keys(config: Dict) -> List[str]:
    """The prediction keys a configuration's head gives the Hamiltonian under."""
    if config["model"]["output_nets"]["HamGNN_out"].get("soc_switch", False):
        return ["hamiltonian_real_on", "hamiltonian_real_off",
                "hamiltonian_imag_on", "hamiltonian_imag_off"]
    return ["hamiltonian_on", "hamiltonian_off"]


def leaf_norms(flat: torch.Tensor, leaves: Sequence) -> Dict[str, float]:
    out, ofs = {}, 0
    flat = flat.detach().double().cpu()
    for name, shape in leaves:
        k = int(np.prod(shape))
        out[name] = float(torch.linalg.vector_norm(flat[ofs : ofs + k]))
        ofs += k
    return out


def program_train_record(losses, mu1, theta0, theta_n, leaves, a1: float) -> Dict:
    """The program's first steps as the comparison reads them."""
    return {"losses": list(losses), "grad": leaf_norms(mu1.double() / a1, leaves),
            "change": leaf_norms(theta_n.double() - theta0.double(), leaves)}


def _set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def reference_model(config: Dict, weights: Dict[str, torch.Tensor], device):
    from reference.build import build_model

    model = build_model(copy.deepcopy(config["model"])).to(device)
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise KeyError("the reference's parameters are not the program's: "
                       f"{sorted(set(params) ^ set(weights))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    return model


def reference_train_record(config: Dict, weights, steps: Sequence[Sequence[Dict]], device,
                           tf32: bool = False) -> Dict:
    """The reference's own steps from ``weights`` on ``steps`` (each a list
    of crystals; one crystal a step here), in float32 with TF32 off, or on
    with ``tf32`` (the control)."""
    from reference.graph import graph_from_crystal
    from reference.model import compute_losses
    from reference.optim import Amsgrad, flatten_parameters

    if any(len(batch) != 1 for batch in steps):
        raise NotImplementedError("the reference takes one crystal a step")
    model_cfg = config["model"]
    opt_cfg = model_cfg["optim_params"]
    _set_tf32(tf32)
    try:
        model = reference_model(config, weights, device)
        leaves = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
        flat, grad = flatten_parameters(model)
        opt = Amsgrad(flat.numel(), device, opt_cfg["gradient_clip_val"])
        theta0 = flat.detach().clone()
        losses, g1 = [], None
        for s, (crystal,) in enumerate(steps):
            graph = graph_from_crystal(crystal, device)
            grad.zero_()
            total, _ = compute_losses(model(graph), graph, model_cfg["losses_metrics"]["losses"])
            total.backward()
            if s == 0:
                g1 = grad.detach().clone()
            opt.step(flat, grad, float(opt_cfg["lr"]), loss=total.detach())
            losses.append(float(total.detach()))
            del graph, total
        return {"losses": losses, "grad": leaf_norms(g1, leaves),
                "change": leaf_norms(flat.detach() - theta0, leaves)}
    finally:
        _set_tf32(False)


def _worst_leaf(p: Dict[str, float], r: Dict[str, float], names) -> float:
    names = list(names)
    med = float(np.median([r[n] for n in names]))
    return max(abs(p[n] - r[n]) / max(r[n], med) for n in names)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    names = list(ref["grad"])
    med_g = float(np.median([ref["grad"][n] for n in names]))
    moving = [n for n in names if ref["grad"][n] >= ROUNDING_LEAF * med_g]
    return {"loss_gap": loss_gap, "grad_gap": _worst_leaf(prog["grad"], ref["grad"], names),
            "change_gap": _worst_leaf(prog["change"], ref["change"], moving)}


def reference_predictions(config: Dict, weights, crystals: Dict[int, Dict], device,
                          tf32: bool = False) -> Dict[int, Dict[str, torch.Tensor]]:
    """The reference's Hamiltonian of each crystal, on the host."""
    from reference.graph import graph_from_crystal

    keys = hamiltonian_keys(config)
    _set_tf32(tf32)
    try:
        model = reference_model(config, weights, device)
        out = {}
        with torch.no_grad():
            for j, crystal in crystals.items():
                preds = model(graph_from_crystal(crystal, device))
                out[j] = {k: preds[k].to("cpu", copy=True) for k in keys}
        return out
    finally:
        _set_tf32(False)


def h_gap(pred: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """Widest gap of one crystal's Hamiltonian, each part (real, imaginary)
    over its own largest reference magnitude; ``pred``'s rows past the
    reference's are padding."""
    gaps = []
    for part in sorted({k.rsplit("_", 1)[0] for k in ref}):
        scale = max(float(ref[f"{part}_{w}"].abs().max()) for w in ("on", "off"))
        diff = max(float((pred[f"{part}_{w}"][: ref[f"{part}_{w}"].shape[0]].double()
                          - ref[f"{part}_{w}"].double()).abs().max()) for w in ("on", "off"))
        gaps.append(diff / scale)
    return max(gaps)


def predict_numbers(kept: Dict[int, Dict], ref: Dict[int, Dict]) -> Dict[str, float]:
    return {"h_gap": max(h_gap(kept[j], ref[j]) for j in kept)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN is over it)."""
    missing = set(numbers) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return all(numbers[k] <= limits[k] for k in numbers)
