"""Uni-HamGNN: the universal two-stage Hamiltonian predictor, counterpart of
``hamgnn_tpu/tools/uni_hamgnn.py``.

    python -m hamgnn_tpu_torch.tools.uni_hamgnn --config Input.yaml [--device cpu]

A non-SOC model predicts the spatial Hamiltonian; a SOC model with
``add_H_nonsoc`` takes that prediction and adds the spin-orbit structure (the
reference's Uni-HamiltonianPredictor.py).  A predictor package is a
directory, not a pickled live object: ``nonsoc.yaml`` and ``soc.yaml`` (and
``compat.yaml`` for a package converted from the reference's pickles,
``interfaces/uni_pickle.py``), with the parameters in the port's form,
``nonsoc_params.npz`` / ``soc_params.npz`` (the flattened flax tree, keys
``params/<module>/.../<leaf>``), which the card machine reads without
``tensorstore``.  ``load`` also reads the JAX package's ``nonsoc_params/`` /
``soc_params/`` orbax directories (``interfaces/orbax_reader.py``).

Both stages run on the card (``cuda`` unless ``device="cpu"``): the native
models through the packed TP kernels (B1, or B3 under
``HAMGNN_TP_ENGINE=zonal``), the compat models through the plain uvw einsums
of ``interfaces/e3nn_compat.py``.  As the JAX tool jits each stage, and so
compiles one program per bucket shape of ``GraphDataModule(test_mode=True)``,
each stage on the card is a CUDA graph per shape key (``train/captured.py``),
captured at its key's first prediction and replayed after it; the SOC
stage's upstream prediction is copied into static inputs of its key.  The
two stages have a capture cache each (a non-SOC and a SOC graph of one
structure share a key) and one memory pool; each prediction is copied out
of its graph, so it is fresh tensors, as eager and as JAX.  ``capture=False``
runs the stages eagerly under ``torch.no_grad()``, as the CPU always does.

The CLI takes the reference's keys: ``model_pkl_path`` (a package directory;
``model_package_path`` too), ``non_soc_data_dir`` and ``soc_data_dir``
(graph_data.npz files), ``output_dir``, ``calculate_mae``; it writes
``prediction_hamiltonian.npy`` (the SOC stage's real rows where it runs) and
prints the masked MAE against the stored targets.
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Optional

import numpy as np
import torch
import yaml

from .. import resolve_device
from ..cli import build_model
from ..data.dataset import GraphDataModule, load_graph_npz
from ..models.output import concatenate_by_crystal
from ..train.captured import CapturedSteps
from ..train.config import config_to_dict, load_config

_SOC_OVERRIDES = {"output_nets": {"HamGNN_out": {
    "add_H_nonsoc": True, "zero_point_shift": False}}}


def _compat_representation(config):
    from ..interfaces.e3nn_compat import HamGNNConvE3Compat

    pre = config.representation_nets.HamGNN_pre
    return HamGNNConvE3Compat(
        num_types=pre.num_types, irreps_edge_sh=pre.irreps_edge_sh,
        irreps_node_features=pre.irreps_node_features,
        num_layers=pre.num_layers, num_radial=pre.num_radial,
        rbf_func=pre.rbf_func.lower(), cutoff=pre.cutoff,
        radial_mlp=tuple(pre.radial_MLP))


def _build_compat_model(config):
    """Reference-parametrization model for packages converted from the
    published predictor pickles: e3nn-compat representation + the native
    Hamiltonian head."""
    from ..models.model import HamGNNModel
    from ..models.output import HamGNNPlusPlusOut

    pre = config.representation_nets.HamGNN_pre
    out_cfg = config.output_nets.HamGNN_out
    head = HamGNNPlusPlusOut(
        irreps_in_node=pre.irreps_node_features,
        irreps_in_edge=pre.irreps_node_features,
        nao_max=out_cfg.nao_max, ham_type=out_cfg.ham_type.lower(),
        ham_only=True, add_H0=out_cfg.add_H0,
        zero_point_shift=out_cfg.get("zero_point_shift", True))
    return HamGNNModel(_compat_representation(config), head)


def _build_compat_soc_model(config):
    """e3nn-compat representation + SOC head (add_H_nonsoc two-stage mode)."""
    from ..models.model import HamGNNModel
    from ..models.soc import HamGNNSOCOut

    pre = config.representation_nets.HamGNN_pre
    out_cfg = config.output_nets.HamGNN_out
    head = HamGNNSOCOut(
        irreps_in_node=pre.irreps_node_features,
        irreps_in_edge=pre.irreps_node_features,
        nao_max=out_cfg.nao_max, ham_type=out_cfg.ham_type.lower(),
        soc_basis=out_cfg.get("soc_basis", "so3"),
        add_H0=out_cfg.add_H0, add_H_nonsoc=True, symmetrize=True,
        zero_point_shift=False)
    return HamGNNModel(_compat_representation(config), head)


def _load_config(config, overrides=None):
    """A config file path, or a loaded config (taken as it is, with
    ``overrides`` on top)."""
    if isinstance(config, str):
        return load_config(config, overrides=overrides)
    cfg = config_to_dict(config)
    return load_config(None, overrides=cfg if not overrides else
                       _merge(cfg, overrides))


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(a[k], v) if isinstance(v, dict) and isinstance(a.get(k), dict) else v
    return out


def _stage_params(package_dir: str, stage: str):
    """The flattened parameters of ``stage`` (``nonsoc`` / ``soc``): the
    port's ``<stage>_params.npz``, else the JAX package's orbax directory."""
    npz = os.path.join(package_dir, f"{stage}_params.npz")
    if os.path.isfile(npz):
        with np.load(npz) as f:
            return {k: f[k] for k in f.files}
    from ..interfaces.orbax_reader import checkpoint_params

    return checkpoint_params(os.path.join(package_dir, f"{stage}_params"))


def nonsoc_stage(model, graph):
    """The non-SOC stage's body: the body of JAX's
    ``jax.jit(model_nonsoc.apply)``."""
    return model(graph)


def soc_stage(model, graph_soc, h_nonsoc_on, h_nonsoc_off):
    """The SOC stage's body, the upstream prediction's rows as its inputs:
    the body of JAX's jitted ``run``."""
    return model.output(graph_soc, model.representation(graph_soc),
                        h_nonsoc=(h_nonsoc_on, h_nonsoc_off))


def _fresh(out):
    """A replay's outputs copied out of its graph's buffers."""
    return {k: v.clone() for k, v in out.items()}


class HamiltonianPredictor:
    """Bundles a non-SOC model and an optional SOC model (add_H_nonsoc).

    ``config_nonsoc`` / ``config_soc``: config file paths or loaded configs.
    The models' weights are what they were built with (zeros) until
    ``load`` fills them, or the caller does (``models.model.init_weights``,
    ``interfaces.jax_params.load_flax_params``).

    ``capture``: replay each stage as a CUDA graph per shape key (default:
    on the card); False runs the stages eagerly.  Either way a prediction
    is fresh tensors: a replay's outputs are copied out of its graph, whose
    buffers the next replay of any stage or key may reuse (the graphs share
    one pool).  A replay reads the parameters in place; the
    ``HAMGNN_TP_ENGINE`` switches are those of its key's first prediction."""

    def __init__(self, config_nonsoc, config_soc=None, soc_switch: bool = False,
                 compat: bool = False, device=None, capture: Optional[bool] = None):
        self.device = resolve_device(device)
        self.soc_enabled = soc_switch
        self.compat = compat
        self.config_nonsoc = _load_config(config_nonsoc)
        self.model_nonsoc = (_build_compat_model(self.config_nonsoc) if compat
                             else build_model(self.config_nonsoc)).to(self.device).eval()
        self.config_soc = self.model_soc = None
        if soc_switch:
            self.config_soc = _load_config(config_soc, _SOC_OVERRIDES)
            self.model_soc = (_build_compat_soc_model(self.config_soc) if compat
                              else build_model(self.config_soc)).to(self.device).eval()
        if capture is None:
            capture = self.device.type == "cuda"
        elif capture and self.device.type != "cuda":
            raise ValueError(f"a captured prediction needs the card, not {self.device}")
        # the stage bodies hold their model, not the predictor: a dropped
        # predictor frees its graphs' pool without a garbage collection
        self.nonsoc_stage = functools.partial(nonsoc_stage, self.model_nonsoc)
        self.soc_stage = (functools.partial(soc_stage, self.model_soc) if soc_switch
                          else None)
        self.captured_nonsoc = self.captured_soc = None
        if capture:
            self.captured_nonsoc = CapturedSteps(self.device, None, self.nonsoc_stage)
            if soc_switch:
                self.captured_soc = CapturedSteps(self.device, None, self.soc_stage,
                                                  pool=self.captured_nonsoc.pool)

    # -- persistence -----------------------------------------------------

    def save(self, package_dir: str) -> None:
        from ..interfaces.torch_ckpt import flatten_params

        os.makedirs(package_dir, exist_ok=True)
        stages = [("nonsoc", self.config_nonsoc, self.model_nonsoc)]
        if self.soc_enabled:
            stages.append(("soc", self.config_soc, self.model_soc))
        for stage, config, model in stages:
            with open(os.path.join(package_dir, f"{stage}.yaml"), "w") as f:
                yaml.safe_dump(config_to_dict(config), f)
            np.savez(os.path.join(package_dir, f"{stage}_params.npz"),
                     **flatten_params(model, prefix="params/"))
        if self.compat:
            with open(os.path.join(package_dir, "compat.yaml"), "w") as f:
                yaml.safe_dump({"execution_path": "e3nn_compat"}, f)

    @classmethod
    def load(cls, package_dir: str, device=None,
             capture: Optional[bool] = None) -> "HamiltonianPredictor":
        from ..interfaces.jax_params import load_flax_params

        soc = os.path.exists(os.path.join(package_dir, "soc.yaml"))
        compat = os.path.exists(os.path.join(package_dir, "compat.yaml"))
        pred = cls(os.path.join(package_dir, "nonsoc.yaml"),
                   os.path.join(package_dir, "soc.yaml") if soc else None,
                   soc_switch=soc, compat=compat, device=device, capture=capture)
        load_flax_params(pred.model_nonsoc, _stage_params(package_dir, "nonsoc"))
        if soc:
            load_flax_params(pred.model_soc, _stage_params(package_dir, "soc"))
        return pred

    # -- prediction ------------------------------------------------------

    @torch.no_grad()
    def predict_nonsoc(self, graph):
        if self.captured_nonsoc is None:
            return self.nonsoc_stage(graph)
        return _fresh(self.captured_nonsoc.forward(graph))

    @torch.no_grad()
    def predict_soc(self, graph_soc, h_nonsoc_on, h_nonsoc_off):
        if self.captured_soc is None:
            return self.soc_stage(graph_soc, h_nonsoc_on, h_nonsoc_off)
        return _fresh(self.captured_soc.forward(graph_soc, h_nonsoc_on=h_nonsoc_on,
                                                h_nonsoc_off=h_nonsoc_off))


def masked_mae(pred, target, mask):
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    m = host(mask) > 0
    return float(np.abs(host(pred)[m] - host(target)[m]).mean())


def main(argv=None):
    parser = argparse.ArgumentParser(description="Uni-HamGNN inference")
    parser.add_argument("--config", default="Input.yaml", type=str)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    with open(args.config, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)

    pkg = cfg.get("model_package_path") or cfg.get("model_pkl_path")
    out_dir = cfg.get("output_dir", "./")
    os.makedirs(out_dir, exist_ok=True)
    predictor = HamiltonianPredictor.load(pkg, device=args.device)
    dev = predictor.device

    data = GraphDataModule(load_graph_npz(cfg["non_soc_data_dir"]), batch_size=1,
                           test_mode=True, device=dev)
    batches = list(data.test_batches())
    soc_batches: list = [None] * len(batches)
    if predictor.soc_enabled and cfg.get("soc_data_dir"):
        soc_data = GraphDataModule(load_graph_npz(cfg["soc_data_dir"]), batch_size=1,
                                   test_mode=True, device=dev)
        soc_batches = list(soc_data.test_batches())

    rows_out = []
    maes = []
    for g, g_soc in zip(batches, soc_batches):
        preds = predictor.predict_nonsoc(g)
        if g_soc is not None:
            preds = predictor.predict_soc(g_soc, preds["hamiltonian_on"],
                                          preds["hamiltonian_off"])
            g, on_key, off_key = g_soc, "hamiltonian_real_on", "hamiltonian_real_off"
        else:
            on_key, off_key = "hamiltonian_on", "hamiltonian_off"
        on = preds[on_key].cpu().numpy()
        rows_out.append(concatenate_by_crystal(g, on, preds[off_key].cpu().numpy()))
        if cfg.get("calculate_mae") and g.Hon is not None:
            maes.append(masked_mae(on, g.Hon, preds["mask_on"]))

    np.save(os.path.join(out_dir, "prediction_hamiltonian.npy"),
            np.concatenate(rows_out, axis=0))
    if maes:
        print(f"masked MAE: {np.mean(maes):.3e} Hartree")


if __name__ == "__main__":
    main()
