"""Configuration: reference-schema YAML over hard-coded defaults.

A copy of ``hamgnn_tpu/train/config.py`` (same sections, same defaults,
recursively merged with the user YAML), so one config file drives both
packages.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import Any, Dict, Optional

import yaml

CONFIG_DEFAULT: Dict[str, Any] = {
    "setup": {
        "GNN_Net": "HamGNNpre",
        "ignore_warnings": True,
        "checkpoint_path": "./",
        "load_from_checkpoint": False,
        "resume": False,
        "num_gpus": 1,
        "precision": 32,
        "property": "hamiltonian",
        "stage": "fit",
        "use_gradient_checkpointing": False,
        # multi-chip strategy (this framework's extension of the reference's
        # automatic DDP selection, main.py:300-323): none | dp | halo.
        # dp replicates crystals over the mesh; halo additionally splits each
        # crystal's edge set n_graph ways (shard_map all_to_all per layer).
        "parallel": {
            "mode": "none",
            "n_data": 0,       # 0 = infer from the device count
            "n_graph": 0,      # 0 = infer from the device count
            "edge_quantum": 64,
        },
    },
    "profiler_params": {"train_dir": "./", "progress_bar_refresh_rat": 1},
    "representation_nets": {
        "HamGNN_pre": {
            "cutoff": 26.0,
            "cutoff_func": "cos",
            "radius_type": "openmx",
            "radius_scale": 1.01,
            "edge_sh_normalization": "component",
            "edge_sh_normalize": True,
            "irreps_edge_sh": "0e + 1o + 2e + 3o + 4e + 5o",
            "irreps_node_features": "64x0e+64x0o+32x1o+16x1e+12x2o+25x2e+18x3o+9x3e+4x4o+9x4e+4x5o+4x5e+2x6e",
            "num_layers": 3,
            "num_radial": 64,
            "num_types": 96,
            "rbf_func": "bessel",
            "set_features": True,
            "radial_MLP": [64, 64],
            "use_corr_prod": False,
            "correlation": 2,
            "num_hidden_features": 16,
            "use_kan": False,
            "build_internal_graph": False,
            "use_gradient_checkpointing": False,
            "lite_mode": False,
            "apply_charge_doping": False,
            "num_charge_attr_feas": 8,
        }
    },
    "output_nets": {
        "output_module": "HamGNN_out",
        "HamGNN_out": {
            "ham_only": True,
            "ham_type": "openmx",
            "nao_max": 26,
            "add_H0": True,
            "add_H_nonsoc": False,
            "symmetrize": True,
            "calculate_band_energy": False,
            "num_k": 5,
            "band_num_control": 8,
            "k_path": None,
            "soc_switch": False,
            "soc_basis": "so3",
            "nonlinearity_type": "gate",
            "spin_constrained": False,
            "collinear_spin": False,
            "minMagneticMoment": 0.5,
            "zero_point_shift": True,
            "get_nonzero_mask_tensor": False,
        },
    },
    "optim_params": {
        "lr": 0.01,
        "lr_decay": 0.5,
        "lr_patience": 5,
        "gradient_clip_val": 0.0,
        "stop_patience": 30,
        "min_epochs": 100,
        "max_epochs": 3000,
    },
    "losses_metrics": {
        "losses": [{"metric": "mae", "prediction": "hamiltonian",
                    "target": "hamiltonian", "loss_weight": 27.211}],
        "metrics": [{"metric": "mae", "prediction": "hamiltonian",
                     "target": "hamiltonian"}],
    },
    "dataset_params": {
        "batch_size": 1,
        "split_file": None,
        "test_ratio": 0.2,
        "train_ratio": 0.6,
        "val_ratio": 0.2,
        "graph_data_path": "./",
    },
}


def recursive_update(base: Dict, update: Dict) -> Dict:
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            base[k] = recursive_update(base[k], v)
        else:
            base[k] = v
    return base


class NS(SimpleNamespace):
    """Attribute-dict (EasyDict equivalent) with .get support."""

    def get(self, key, default=None):
        return getattr(self, key, default)

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key):
        return hasattr(self, key)


def _to_ns(obj):
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            # a mapping keyed by numbers (band_num_control: {6: 2, 14: 4}) has
            # no attribute form: it stays a dict
            return {k: _to_ns(v) for k, v in obj.items()}
        return NS(**{k: _to_ns(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_ns(v) for v in obj]
    return obj


def load_config(config_file_path: Optional[str] = None, overrides: Optional[Dict] = None):
    cfg = copy.deepcopy(CONFIG_DEFAULT)
    if config_file_path is not None:
        with open(config_file_path, encoding="utf-8") as f:
            user = yaml.safe_load(f) or {}
        cfg = recursive_update(cfg, user)
    if overrides:
        cfg = recursive_update(cfg, overrides)
    return _to_ns(cfg)


def config_to_dict(cfg) -> Dict:
    if isinstance(cfg, NS):
        return {k: config_to_dict(v) for k, v in vars(cfg).items()}
    if isinstance(cfg, list):
        return [config_to_dict(v) for v in cfg]
    return cfg
