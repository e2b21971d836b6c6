"""The reference model of a configuration file's ``model`` section (the
reference schema: ``representation_nets.HamGNN_pre``,
``output_nets.HamGNN_out``, ``losses_metrics``), as the program's CLI builds
it: ConvE3, then the OpenMX non-SOC head or, with ``soc_switch``, the SOC
head."""

from __future__ import annotations

from typing import Dict

from .model import HamGNNModel
from .output import HamGNNPlusPlusOut
from .representation import HamGNNConvE3
from .soc import HamGNNSOCOut

SUPPORTED_NET = "hamgnnpre"


def build_model(model_cfg: Dict) -> HamGNNModel:
    net = model_cfg.get("setup", {}).get("GNN_Net", "HamGNNpre")
    if net.lower() != SUPPORTED_NET:
        raise NotImplementedError(f"the reference has ConvE3 only, not {net}")
    pre = model_cfg["representation_nets"]["HamGNN_pre"]
    out = model_cfg["output_nets"]["HamGNN_out"]
    for key in ("use_corr_prod", "spin_constrained", "calculate_band_energy", "use_kan"):
        if pre.get(key, False) or out.get(key, False):
            raise NotImplementedError(f"the reference has no {key}")
    rep = HamGNNConvE3(
        num_types=pre["num_types"], irreps_edge_sh=pre["irreps_edge_sh"],
        irreps_node_features=pre["irreps_node_features"], num_layers=pre["num_layers"],
        num_radial=pre["num_radial"], rbf_func=pre["rbf_func"].lower(), cutoff=pre["cutoff"],
        cutoff_func=pre.get("cutoff_func", "cos"), radial_mlp=tuple(pre["radial_MLP"]),
        lite_mode=pre.get("lite_mode", False),
        apply_charge_doping=pre.get("apply_charge_doping", False),
        num_charge_attr_feas=pre.get("num_charge_attr_feas", 8))
    feats = pre["irreps_node_features"]
    if out.get("soc_switch", False):
        ham_type = out["ham_type"].lower()
        head = HamGNNSOCOut(
            irreps_in_node=feats, irreps_in_edge=feats, nao_max=out["nao_max"],
            ham_type=ham_type,
            soc_basis="su2" if ham_type != "openmx" else out.get("soc_basis", "so3"),
            add_H0=out["add_H0"], add_H_nonsoc=out.get("add_H_nonsoc", False),
            symmetrize=out["symmetrize"], zero_point_shift=out.get("zero_point_shift", True),
            nonlinearity_type=out.get("nonlinearity_type", "gate"))
    else:
        head = HamGNNPlusPlusOut(
            irreps_in_node=feats, irreps_in_edge=feats, nao_max=out["nao_max"],
            ham_type=out["ham_type"].lower(), ham_only=out["ham_only"],
            symmetrize=out["symmetrize"], add_H0=out["add_H0"],
            zero_point_shift=out.get("zero_point_shift", True),
            nonlinearity_type=out.get("nonlinearity_type", "gate"))
    return HamGNNModel(rep, head)
