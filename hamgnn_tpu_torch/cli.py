"""Command-line entry point of the port:
``python -m hamgnn_tpu_torch.cli --config config.yaml [--device cpu]``.

Counterpart of ``hamgnn_tpu/cli.py``: load the YAML over the defaults, build
the dataset and the model (``setup.GNN_Net: HamGNNTransformer`` the attention
network, else ConvE3, with ``use_corr_prod`` and ``use_kan`` as the
representation keys say), then

* ``setup.stage: fit``: train with ``train.trainer.Trainer`` (metrics.jsonl
  and ``best.pt`` in ``profiler_params.train_dir``), warm-started from
  ``setup.checkpoint_path`` when ``setup.load_from_checkpoint`` is set (the
  learning rate restarts at ``optim_params.lr`` unless ``setup.resume``),
  then a final test pass;
* ``setup.parallel.mode: dp`` or ``halo`` (``n_data``, ``n_graph``,
  ``edge_quantum``, as the JAX CLI reads them): the same stages through
  ``parallel.halo_trainer.HaloTrainer`` over ``torch.distributed``, one
  process per card (``torchrun --nproc_per_node <cards> -m
  hamgnn_tpu_torch.cli --config ...``; without a launcher, one process);
  rank 0 alone writes files and prints how the steps ran (on the card under
  NCCL replayed from CUDA graphs, over gloo eagerly);
* ``setup.stage: test``: load weights from ``setup.checkpoint_path`` (a
  trainer checkpoint, the port's ``torch.save`` state dict, an ``.npz`` of
  the flattened flax tree, or an orbax directory of the JAX trainer) and run
  the test batches;

and save ``prediction_hamiltonian.npy`` / ``target_hamiltonian.npy`` in the
reference's interleaved layout (with the SOC head, ``output_nets.HamGNN_out.
soc_switch``, or the non-collinear magnetic head,
``prediction_hamiltonian_{real,imag}.npy`` and
``target_hamiltonian_{real,imag}.npy``; the collinear magnetic head's rows are
(rows, 2, nao^2)), and a prediction-against-target scatter plot.
``output_nets.HamGNN_out.spin_constrained`` builds the magnetic head
(``collinear_spin``, ``soc_switch``, ``use_learned_weight``,
``minMagneticMoment``).  ``dataset_params.data_format: lmdb``, or ``auto``
with a ``graph_data_path`` ending in ``.lmdb``, reads the graphs on demand
from an LMDB store.  A ``checkpoint_path`` ``<p>`` that does not exist reads
``<p>.pt`` where that exists: the reference's trainer saves ``best``, this
port's ``best.pt``.  With ``output_nets.HamGNN_out.
calculate_band_energy`` the head also solves the bands (``num_k``,
``k_path``, ``band_num_control``, ``export_reciprocal_values``), so
``band_energy`` / ``band_gap`` can sit under ``losses_metrics``; they reach
``metrics.jsonl`` and the printed test metrics, and no band file is written
(``tools/band_cal.py`` computes band structures from the predictions).
"""

from __future__ import annotations

import argparse
import os
import warnings
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .models.model import HamGNNModel, init_weights
from .models.output import HamGNNPlusPlusOut, concatenate_by_crystal
from .models.representation import HamGNNConvE3, HamGNNTransformer
from .models.soc import HamGNNSOCOut
from .models.spin import HamGNNMagneticOut
from .train.config import NS, config_to_dict, load_config
from .train.trainer import Trainer, load_params


def build_model(config) -> HamGNNModel:
    """Representation + output modules from a reference-schema config."""
    pre = config.representation_nets.HamGNN_pre
    out = config.output_nets.HamGNN_out
    common = dict(
        num_types=pre.num_types,
        irreps_edge_sh=pre.irreps_edge_sh,
        irreps_node_features=pre.irreps_node_features,
        num_layers=pre.num_layers,
        num_radial=pre.num_radial,
        rbf_func=pre.rbf_func.lower(),
        cutoff=pre.cutoff,
        cutoff_func=pre.get("cutoff_func", "cos"),
        radial_mlp=tuple(pre.radial_MLP),
        correlation=pre.get("correlation", 2),
        num_hidden_features=pre.get("num_hidden_features", 16),
        use_kan=pre.get("use_kan", False),
        apply_charge_doping=pre.get("apply_charge_doping", False),
        num_charge_attr_feas=pre.get("num_charge_attr_feas", 8),
    )
    if config.setup.get("GNN_Net", "HamGNNpre").lower() == "hamgnntransformer":
        rep = HamGNNTransformer(num_heads=pre.get("num_heads", 4), **common)
    else:
        rep = HamGNNConvE3(
            use_corr_prod=pre.get("use_corr_prod", False),
            lite_mode=pre.get("lite_mode", False),
            legacy_edge_update=pre.get("legacy_edge_update", False),
            use_gradient_checkpointing=bool(
                pre.get("use_gradient_checkpointing", False)
                or config.setup.get("use_gradient_checkpointing", False)),
            **common)
    bnc = out.get("band_num_control", 8)
    if not isinstance(bnc, int) or isinstance(bnc, bool):
        bnc = 8  # the magnetic and SOC heads take an int window only
    if out.get("spin_constrained", False):
        head = HamGNNMagneticOut(
            irreps_in_node=pre.irreps_node_features,
            irreps_in_edge=pre.irreps_node_features,
            nao_max=out.nao_max,
            ham_type=out.ham_type.lower(),
            soc_switch=out.get("soc_switch", False),
            collinear_spin=out.get("collinear_spin", False),
            use_learned_weight=out.get("use_learned_weight", True),
            min_magnetic_moment=out.get("minMagneticMoment", 0.5),
            add_H0=out.add_H0,
            symmetrize=out.symmetrize,
            nonlinearity_type=out.get("nonlinearity_type", "gate"),
            calculate_band_energy=out.get("calculate_band_energy", False),
            num_k=out.get("num_k", 5),
            band_num_control=bnc,
            k_path=_freeze_k_path(out.get("k_path", None)),
            export_reciprocal_values=out.get("export_reciprocal_values", False),
        )
        return HamGNNModel(rep, head)
    if out.get("soc_switch", False):
        ham_type = out.ham_type.lower()
        head = HamGNNSOCOut(
            irreps_in_node=pre.irreps_node_features,
            irreps_in_edge=pre.irreps_node_features,
            nao_max=out.nao_max,
            ham_type=ham_type,
            # the su2 codec is the only SOC basis outside openmx
            soc_basis="su2" if ham_type != "openmx" else out.get("soc_basis", "so3"),
            add_H0=out.add_H0,
            add_H_nonsoc=out.get("add_H_nonsoc", False),
            symmetrize=out.symmetrize,
            zero_point_shift=out.get("zero_point_shift", True),
            nonlinearity_type=out.get("nonlinearity_type", "gate"),
            calculate_band_energy=out.get("calculate_band_energy", False),
            num_k=out.get("num_k", 5),
            band_num_control=bnc,
            k_path=_freeze_k_path(out.get("k_path", None)),
        )
        return HamGNNModel(rep, head)
    head = HamGNNPlusPlusOut(
        irreps_in_node=pre.irreps_node_features,
        irreps_in_edge=pre.irreps_node_features,
        nao_max=out.nao_max,
        ham_type=out.ham_type.lower(),
        ham_only=out.ham_only,
        symmetrize=out.symmetrize,
        add_H0=out.add_H0,
        zero_point_shift=out.get("zero_point_shift", True),
        nonlinearity_type=out.get("nonlinearity_type", "gate"),
        calculate_band_energy=out.get("calculate_band_energy", False),
        num_k=out.get("num_k", 5),
        k_path=_freeze_k_path(out.get("k_path", None)),
        export_reciprocal_values=out.get("export_reciprocal_values", False),
        **_band_control_kwargs(out),
    )
    return HamGNNModel(rep, head)


def _band_control_kwargs(out) -> dict:
    """Map the reference's int or dict ``band_num_control`` onto the head's
    static-shape attributes.

    int -> a window of that many bands either side of half filling.
    dict {Z: count} -> per-species counts; the head exports the lowest
    ``max_bands`` (config key, default 32) bands plus a per-crystal mask.
    Any other value (a float fraction, say) means "no truncation" in the
    reference; static shapes need a fixed window, so this warns and takes a
    +/-``max_bands`` window around half filling.
    """
    bnc = out.get("band_num_control", 8)
    if bnc is None or isinstance(bnc, bool):  # bool is an int subclass: unset
        bnc = 8
    if isinstance(bnc, int):
        return {"band_num_control": bnc}
    max_bands = int(out.get("max_bands", 32))
    if isinstance(bnc, (dict, NS)):
        # the loader turns a mapping with string keys ("6": 2) into an NS
        items = bnc.items() if isinstance(bnc, dict) else vars(bnc).items()
        counts = tuple(sorted((int(z), int(n)) for z, n in items))
        return {"band_num_control": max_bands, "band_species_counts": counts}
    warnings.warn(
        f"band_num_control={bnc!r}: only an int or a per-species dict is "
        f"supported. The reference treats this as no truncation (all bands); "
        f"static shapes need a fixed window, so a +/-{max_bands}-band window "
        f"around half filling is taken instead (set max_bands to widen it)",
        stacklevel=2)
    return {"band_num_control": max_bands}


def _freeze_k_path(spec):
    """YAML k_path -> head attribute: 'auto', a tuple of reduced nodes, or None."""
    if spec is None or isinstance(spec, str):
        return spec
    return tuple(tuple(float(v) for v in node) for node in spec)


def audit_config(config) -> None:
    """Warn on each reference config knob that the port does not honour or
    handles otherwise, rather than ignore it without a word (the
    reference's ``audit_config``)."""
    setup = config.setup
    pre = config.representation_nets.HamGNN_pre
    out = config.output_nets.HamGNN_out
    ds = config.dataset_params

    if int(setup.get("precision", 32)) == 64:
        warnings.warn(
            "setup.precision=64: the port computes in fp32 (its TP kernels in fp32, their "
            "products as 3xTF32 on the tensor cores); proceeding in fp32.", stacklevel=2)
    if pre.get("edge_sh_normalization", "component") != "component" or \
            not pre.get("edge_sh_normalize", True):
        warnings.warn(
            "edge_sh_normalization: the port computes the reference default only "
            "('component', normalized edge vectors); other settings are ignored.",
            stacklevel=2)
    if pre.get("build_internal_graph", False):
        warnings.warn(
            "build_internal_graph=true: the port uses the edges stored with the graphs "
            "and builds none inside the forward.", stacklevel=2)
    for key, why in [
        ("include_triplet", "the port has no triplet export"),
        ("return_forces", "the port has no force head"),
        ("create_graph", "the port's trainer builds the autograd graph its step needs"),
        ("get_nonzero_mask_tensor", "the heads always export their masks "
         "(mask_on, mask_off)"),
    ]:
        if out.get(key, False):
            warnings.warn(f"output_nets.{key}=true is not honoured: {why}.", stacklevel=2)
    if not out.get("calculate_sparsity", True):
        warnings.warn(
            "calculate_sparsity=false is not honoured: the heads always compute the "
            "sparsity ratio on the device and scale the Hamiltonian losses by it.",
            stacklevel=2)
    if ds.get("num_workers", 4) not in (0, 4) or ds.get("preload", 0):
        warnings.warn(
            "dataset_params.num_workers/preload are torch DataLoader knobs: the port "
            "loads the npz graphs up front, without worker processes.", stacklevel=2)


def prepare_dataset(config, device=None):
    """The config's graphs split into a ``GraphDataModule`` whose batches
    live on ``device`` (cuda unless the caller asks for the CPU): an npz read
    into memory, or an LMDB store (``data_format: lmdb``, or ``auto`` with a
    ``.lmdb`` path) read on demand."""
    from .data.dataset import GraphDataModule, LmdbGraphStore, load_graph_npz
    from .models.basis import get_basis_set, validate_elements_in_basis_def

    path = config.dataset_params.graph_data_path
    fmt = str(config.dataset_params.get("data_format", "auto")).lower()
    lmdb = fmt == "lmdb" or (fmt == "auto" and path.lower().endswith(".lmdb"))
    if lmdb:
        graphs = LmdbGraphStore(path)
    else:
        if not os.path.isfile(path):
            path = os.path.join(path, "graph_data.npz")
        graphs = load_graph_npz(path)
    out = config.output_nets.HamGNN_out
    basis = get_basis_set(out.ham_type.lower(), out.nao_max)
    # one pass over the graphs (a store reads each once), keeping only z
    validate_elements_in_basis_def(
        np.unique(np.concatenate([np.asarray(g["z"]) for g in graphs])), basis)
    return GraphDataModule(
        graphs,
        batch_size=config.dataset_params.batch_size,
        train_ratio=config.dataset_params.train_ratio,
        val_ratio=config.dataset_params.val_ratio,
        test_ratio=config.dataset_params.test_ratio,
        split_file=config.dataset_params.split_file,
        test_mode=(config.setup.stage == "test"),
        device=resolve_device(device),
    )


def load_weights(model: HamGNNModel, path: str) -> None:
    """``path``: an orbax directory the JAX package wrote (a trainer
    checkpoint such as ``<train_dir>/best``, read through ``tensorstore``),
    an ``.npz`` of the flattened flax tree, a ``torch.save`` state dict of
    this model, or a trainer checkpoint (its parameters)."""
    if os.path.isdir(path):
        from .interfaces.jax_params import load_flax_params
        from .interfaces.orbax_reader import checkpoint_params

        load_flax_params(model, checkpoint_params(path))
        return
    if path.endswith(".npz"):
        from .interfaces.jax_params import load_flax_npz

        load_flax_npz(model, path)
    else:
        state = torch.load(path, map_location="cpu")
        if "params" in state and "opt_state" in state:
            load_params(model, state["params"])
        else:
            model.load_state_dict(state, strict=True)


def resolve_checkpoint(path: Optional[str]) -> Optional[str]:
    """``path``, or ``path + ".pt"`` where ``path`` does not exist and that
    does: the shipped two-stage configs name the reference's ``best``, the
    port's trainer writes ``best.pt``.  A path missing in both forms is
    returned as it is (and skipped, as in the reference)."""
    if path and not os.path.exists(path) and os.path.exists(path + ".pt"):
        return path + ".pt"
    return path


def _dump_resolved_config(config) -> None:
    import yaml

    from .version import version_string

    out_dir = config.profiler_params.train_dir
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config_resolved.yaml"), "w") as f:
        f.write(f"# {version_string()}\n")
        yaml.safe_dump(config_to_dict(config), f, sort_keys=False)


def train_and_evaluate(config, device=None) -> dict:
    stage = config.setup.stage
    if stage not in ("fit", "test"):
        raise ValueError(f"setup.stage must be 'fit' or 'test', not {stage!r}")
    par = config.setup.get("parallel", None)
    mode = str(par.get("mode", "none") if par is not None else "none").lower()
    if mode not in ("none", "dp", "halo"):
        raise ValueError(f"setup.parallel.mode must be none, dp or halo, not {mode!r}")
    if mode == "none":
        return _train_and_evaluate(config, mode, resolve_device(device))
    import torch.distributed as dist

    from .parallel.multihost import ensure_process_group, local_device

    dev = local_device(device)
    created = ensure_process_group(dev)
    try:
        return _train_and_evaluate(config, mode, dev)
    finally:
        if created:
            dist.destroy_process_group()


def _train_and_evaluate(config, mode, dev) -> dict:
    from .parallel.multihost import is_primary

    stage = config.setup.stage
    primary = is_primary()
    audit_config(config)
    model = build_model(config)
    data = prepare_dataset(config, dev)
    if primary:
        _dump_resolved_config(config)
    init_weights(model, 666)
    opt = config.optim_params
    trainer_kwargs = dict(
        losses=[config_to_dict(l) for l in config.losses_metrics.losses],
        metrics=[config_to_dict(m) for m in config.losses_metrics.metrics],
        lr=opt.lr, lr_decay=opt.lr_decay, lr_patience=opt.lr_patience,
        gradient_clip_val=opt.gradient_clip_val, stop_patience=opt.stop_patience,
        min_epochs=opt.min_epochs, max_epochs=opt.max_epochs,
        train_dir=config.profiler_params.train_dir, device=dev)
    if mode == "none":
        trainer = Trainer(model, **trainer_kwargs)
    else:
        trainer, data = _parallel_trainer(config.setup.parallel, mode, model, data,
                                          trainer_kwargs)
    ckpt = resolve_checkpoint(config.setup.checkpoint_path)
    if stage == "test":
        if ckpt and os.path.exists(ckpt):
            load_weights(model, ckpt)
    elif config.setup.get("load_from_checkpoint") and ckpt and os.path.exists(ckpt):
        trainer.load_checkpoint(ckpt)
        if not config.setup.get("resume", False):
            # warm start: a fresh LR schedule at the configured rate;
            # `resume: true` keeps the checkpointed LR
            trainer.sched.lr = float(opt.lr)
    if stage == "fit":
        trainer.fit(data)
    _, logs, preds_all = trainer.eval_epoch(data.test_batches(), collect=True)
    if primary:
        _save_predictions(config, preds_all)
        if mode != "none":
            print(f"{mode} steps: " + _steps_report(trainer))
        print("test metrics:", logs)
    return logs


def _steps_report(trainer) -> str:
    """How a multi-device trainer ran its steps: eagerly, or the CUDA graphs
    it captured (the halo or dp steps', the export's one-device eval's)."""
    if trainer.parallel_steps is None:
        return "eager"
    return (f"{trainer.parallel_steps.captures} CUDA graph(s) captured, "
            f"{trainer.captured.captures} for the one-device export")


def _parallel_trainer(par, mode, model, data, trainer_kwargs):
    """The ``dp`` / ``halo`` trainer and its data adapter, with the JAX CLI's
    defaults: the world size in place of the device count, and with a band
    head one crystal a step on all the ranks."""
    import torch.distributed as dist

    from .parallel.halo_trainer import HaloDataAdapter, HaloTrainer

    n_dev = dist.get_world_size()
    n_graph = int(par.get("n_graph", 0) or 0)
    n_data = int(par.get("n_data", 0) or 0)
    if mode == "dp":
        n_graph = n_graph or 1
        n_data = n_data or max(1, n_dev // n_graph)
    else:
        n_graph = n_graph or max(1, n_dev // max(n_data, 1))
        n_data = n_data or max(1, n_dev // n_graph)
    edge_q = int(par.get("edge_quantum", 64) or 64)
    if getattr(model.output, "calculate_band_energy", False) and n_data != 1:
        # band losses solve the whole crystal on gathered rows: one crystal a step
        n_graph = max(n_graph * n_data, n_graph)
        n_data = 1
    trainer = HaloTrainer(model, n_data=n_data, n_graph=n_graph, edge_quantum=edge_q,
                          **trainer_kwargs)
    adapter = HaloDataAdapter(data, n_data=n_data, n_graph=n_graph, edge_quantum=edge_q,
                              band_mode=trainer._band_mode)
    return trainer, adapter


def _save_predictions(config, preds_all) -> None:
    """prediction/target .npy in the reference's interleaved layout: the SOC
    head's real and imaginary spinor rows as two files each, else
    ``hamiltonian``'s, with its scatter plot."""
    from .utils.visualization import scatter_plot

    out_dir = config.profiler_params.train_dir
    os.makedirs(out_dir, exist_ok=True)

    def save(name, rows):
        arr = np.concatenate(rows, axis=0)
        np.save(os.path.join(out_dir, name), arr)
        return arr

    if any("hamiltonian_real_on" in p for _, p in preds_all):
        for part, (t_on, t_off) in (("real", ("Hon", "Hoff")), ("imag", ("iHon", "iHoff"))):
            save(f"prediction_hamiltonian_{part}.npy", [concatenate_by_crystal(
                g, p[f"hamiltonian_{part}_on"], p[f"hamiltonian_{part}_off"])
                for g, p in preds_all])
            save(f"target_hamiltonian_{part}.npy", [concatenate_by_crystal(
                g, getattr(g, t_on).cpu().numpy(), getattr(g, t_off).cpu().numpy())
                for g, _p in preds_all])
        return
    if preds_all:
        pred = save("prediction_hamiltonian.npy", [concatenate_by_crystal(
            g, p["hamiltonian_on"], p["hamiltonian_off"]) for g, p in preds_all])
        target = save("target_hamiltonian.npy", [concatenate_by_crystal(
            g, g.Hon.cpu().numpy(), g.Hoff.cpu().numpy()) for g, _p in preds_all])
        scatter_plot(pred, target, os.path.join(out_dir, "hamiltonian_scatter.png"))


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description="HamGNN, PyTorch/CUDA port")
    parser.add_argument("--config", "-c", default="config_default.yaml")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args, _ = parser.parse_known_args(argv)
    from .version import print_banner

    print_banner()
    config = load_config(args.config)
    np.random.seed(666)
    train_and_evaluate(config, device=args.device)


if __name__ == "__main__":
    main()
