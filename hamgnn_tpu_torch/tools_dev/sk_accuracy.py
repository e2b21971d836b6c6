"""The accuracy runs of the shipped examples through the port alone: each
example's chain as its ``examples/<name>/README.md`` runs it with the JAX
package, here with ``hamgnn_tpu_torch``, held to the JAX package's recorded
result (``docs/performance.md``).

    python -m hamgnn_tpu_torch.tools_dev.sk_accuracy [--example NAME] [--out DIR]
        [--max-epochs N] [--resume] [--seed S] [--init-seed I] [--band-ft]
        [--device cpu]
        [--n-si A --n-c B --n-sic C | --n N]

``--example`` (default ``sk``; ``--soc`` is ``--example sk_soc``), and the JAX
script each one mirrors:

- ``sk``: ``examples/sk``, ``tools_dev/band_acceptance.py``;
- ``sk_soc``: ``examples/sk_soc``, ``tools_dev/soc_band_acceptance.py``;
- ``sk_siesta``: ``examples/sk_siesta`` (``.HSX`` containers packed by
  ``tools.graph_data_gen_siesta`` through the native ``hsx_reader``),
  ``tools_dev/band_acceptance.py --ham-type siesta --nao 19``;
- ``sk_abacus``: ``examples/sk_abacus`` (CSR containers packed by
  ``tools.graph_data_gen_abacus`` through the native ``csr_reader``),
  ``tools_dev/band_acceptance.py --ham-type abacus --nao 27``;
- ``sk_lmdb``: ``examples/sk_lmdb`` (``tools.graph_data_gen``, then
  ``tools.npz_to_lmdb``; the lmdb-lite layout where the ``lmdb`` module is
  missing, as the README documents), the test MAE;
- ``sk_collinear``: ``examples/sk_collinear`` (``config_band_test.yaml``, then
  ``tools.band_cal`` with ``band_cal.yaml`` per spin channel against the
  teacher's); on the pristine set the MAE and mean |splitting| of
  ``tools_dev/collinear_diag.py`` step 3, and the MAE's spatial / splitting
  parts by the port's own definition (``sk_examples.spin_decomposition``);
- ``sk_ncl``, ``sk_spinsoc``: ``examples/sk_ncl``, ``examples/sk_spinsoc``,
  the test MAE, real and imaginary (the JAX package never trained
  ``sk_spinsoc``).

The steps (``tools_dev/sk_examples.py`` holds each example's data, packing,
acceptance and marks):

1. make the seeded teacher data (``tools.sk_dataset``, the README's sizes by
   default, seed 7);
2. pack it with the format's ``graph_data_gen`` tool and the example's YAMLs
   (the training set and, where the example has one, the pristine band set);
3. train with ``examples/<name>/config.yaml`` under the config's own
   stopping rule, from the weights the CLI draws (seed 666) or, with
   ``--init-seed``, from another draw (a warm start from a fresh trainer's
   checkpoint, ``<out>/init.pt``);
4. the example's acceptance step from ``<train_dir>/best``;
5. with ``--band-ft`` (``sk`` only), the secondary (band-energy) training of
   the reference's two-stage workflow: ``examples/sk/config_band_ft.yaml``
   on the training set of step 2, warm-started from ``<train_dir>/best.pt``
   at the config's fresh learning rate, its band steps captured on the card,
   under its own stopping rule (``max_epochs`` capped by ``--max-epochs``)
   into ``<out>/band_ft``; its epochs, test metrics and seconds an epoch go
   into the result under ``band_ft``.

Everything is written under ``--out`` (default
``chiprun_out/sk_accuracy[_<name>]``): the data, rewritten copies of the
example YAMLs (paths moved under ``--out``, ``max_epochs`` from
``--max-epochs``), the training directory and the predictions.  The data and
the test set's prediction arrays are removed at the end, so that the
directory holds the checkpoint, the logs, the band-set predictions and
``result.json``.  ``--resume`` makes the data again (bit for bit from its
seed) and continues the training from ``<out>/train/best.pt`` with its
optimizer state and learning rate (``setup.resume``), appending to
``metrics.jsonl``; the epochs already run are taken off ``min_epochs`` and
``max_epochs``, and the patience counters restart.  The model runs on the
card unless ``--device cpu``; the data tools run on the host.  Prints one
JSON line: the example, the test MAE (of the final parameters, and of
``best``) and the best and last validation MAE (Ha), the epochs run, seconds per epoch, the acceptance step's numbers, each mark
against its limit beside the JAX result, each test crystal's MAE at
``best`` with its atom count (``test_mae_per_crystal``), the TP kernels' launches over the
run (host counters: on the card, the eager passes that warm up and capture
each step; replays are not counted there) and in one training step from
``best.pt`` (on the card one replay of the captured step, read by the
profiler; on the CPU an eager step), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import yaml

from .sk_examples import (EXAMPLES, GLOB_KEY, band_deviation, judge, spin_band_deviation,
                          spin_decomposition, teacher_argv)

ROOT = Path(__file__).resolve().parents[2]


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no GPU"


def _rewrite(src: Path, dst: Path, paths: dict, **sections) -> str:
    """``src`` with each key of ``paths`` (dotted: section.key) set to the
    given value (removed where it is None) and ``sections`` merged in,
    written to ``dst``."""
    cfg = yaml.safe_load(src.read_text())
    for dotted, value in paths.items():
        node = cfg
        *parents, leaf = dotted.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        if value is None:
            node.pop(leaf, None)
        else:
            node[leaf] = value
    for section, keys in sections.items():
        cfg.setdefault(section, {}).update(keys)
    dst.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(dst)


def _records(path: Path) -> list:
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def tp_launches() -> dict:
    """The host launch counters of the TP kernels and their variants."""
    from ..e3 import tp_kernel

    return {n: k.launches for n, k in {**tp_kernel.KERNELS, **tp_kernel.VARIANTS}.items()}


def step_launches(config_path: str, device, train_dir: Path) -> dict:
    """The TP launches of one training step of the chain: its config's
    trainer from ``<train_dir>/best.pt``, on its first training batch.  On
    the card the step is captured (warm-up, capture, replay) and one replay
    is read by the profiler, the most of three traces (a kernel's count, or
    its device kernels' where they differ); on the CPU the eager step is read
    by the host counters."""
    from .. import cli, resolve_device
    from ..e3.tp_kernel import KERNELS
    from ..train.config import config_to_dict, load_config
    from ..utils.profiling import device_launches

    cfg = load_config(config_path)
    dev = resolve_device(device)
    data = cli.prepare_dataset(cfg, dev)
    batch = next(iter(data.train_batches(np.random.default_rng(0))))
    trainer = cli.Trainer(cli.build_model(cfg),
                          losses=[config_to_dict(s) for s in cfg.losses_metrics.losses],
                          metrics=[], lr=cfg.optim_params.lr,
                          gradient_clip_val=cfg.optim_params.gradient_clip_val, device=dev,
                          train_dir=str(train_dir / "launch_step"))
    trainer.load_checkpoint(str(train_dir / "best.pt"))
    if trainer.captured is None:
        before = tp_launches()
        float(trainer.train_step(batch)[0])
        counts = {n: c - before[n] for n, c in tp_launches().items() if c - before[n]}
    else:
        float(trainer.train_step(batch)[0])
        names = [dk for k in KERNELS.values() for dk in k.device_kernels]
        # a long trace can drop a kernel's record but never adds one: the
        # most of three traces
        reads = [device_launches(lambda: trainer.train_step(batch), names) for _ in range(3)]
        read = {dk: max(r[dk] for r in reads) for dk in names}
        counts = {}
        for n, k in KERNELS.items():
            seen = {dk: read[dk] for dk in k.device_kernels}
            if any(seen.values()):
                one = set(seen.values())
                counts[n] = one.pop() if len(one) == 1 else seen
    shutil.rmtree(train_dir / "launch_step", ignore_errors=True)
    return counts


def per_crystal_test_mae(config_path: str, device, train_dir: Path) -> list:
    """The test split crystal by crystal at ``<train_dir>/best.pt``'s
    parameters: each crystal's index in the set, atom count and MAE (the
    mean of the config's MAE metrics, as ``test_mae_Ha``), each crystal a
    batch of its own through the eager eval step (a capture a crystal would
    cost more than it saves)."""
    from .. import cli, resolve_device
    from ..data.graph import pad_and_batch
    from ..train.config import config_to_dict, load_config

    cfg = load_config(config_path)
    dev = resolve_device(device)
    data = cli.prepare_dataset(cfg, dev)
    metrics = [config_to_dict(m) for m in cfg.losses_metrics.metrics]
    trainer = cli.Trainer(cli.build_model(cfg), losses=[config_to_dict(s) for s in
                                                        cfg.losses_metrics.losses],
                          metrics=metrics, device=dev, capture=False,
                          train_dir=str(train_dir / "per_crystal"))
    trainer.load_checkpoint(str(train_dir / "best.pt"))
    out = []
    for i in data.test_idx:
        crystal = data.graphs[i]
        mets = trainer.eval_step(pad_and_batch([crystal], device=dev))[2]
        maes = [float(v) for k, v in mets.items() if k.startswith("mae_")]
        out.append({"index": int(i), "atoms": int(crystal["z"].shape[0]),
                    "mae_Ha": float(np.mean(maes))})
    shutil.rmtree(train_dir / "per_crystal", ignore_errors=True)
    return out


def initial_checkpoint(config_path: Path, seed: int, path: Path) -> Path:
    """A checkpoint of a fresh trainer of the config's model whose weights
    ``init_weights`` drew with ``seed`` (the CLI draws with 666), and whose
    optimizer state is the fresh one: the fit's warm start from it is a
    fresh start from another draw."""
    from .. import cli
    from ..models.model import init_weights
    from ..train.config import load_config

    model = init_weights(cli.build_model(load_config(str(config_path))), seed)
    cli.Trainer(model, losses=[], metrics=[], device="cpu",
                train_dir=str(path.parent / "init")).save_checkpoint(str(path))
    shutil.rmtree(path.parent / "init", ignore_errors=True)
    return path


def make_data(name: str, ex, args, data: Path, seconds: dict) -> dict:
    """Steps 1 and 2: the teacher's set under ``data`` (``<data>_band`` for
    the band set), packed; returns the graph paths the configs read
    (``train``, and ``band`` where the example has a band set)."""
    from ..tools import sk_dataset

    sizes = ((args.n_si, args.n_c, args.n_sic) if ex.data == "container" else (args.n,))
    sizes = tuple(s if s is not None else d for s, d in zip(sizes, ex.sizes))
    t0 = time.perf_counter()
    sk_dataset.run(teacher_argv(ex, data, sizes, args.seed))
    seconds["teacher"] = time.perf_counter() - t0
    band = Path(str(data) + "_band")
    if ex.pack_tool is None:  # the spin sets are written as graph_data.npz
        return {"train": data, **({"band": band} if ex.band_set else {})}
    t0 = time.perf_counter()
    tool = importlib.import_module(f"..tools.{ex.pack_tool}", __package__)
    example, out = ROOT / "examples" / name, data.parent
    graphs = {}
    for key, yml in zip(("train", "band"), ex.packs):
        graphs[key] = out / f"{key}_graph"
        scf = (data / "struct_*") if key == "train" else (band / "pristine_*")
        tool.main(["--config", _rewrite(
            example / yml, out / yml,
            {"graph_data_save_path": str(graphs[key]), GLOB_KEY[ex.pack_tool]: str(scf)})]
            + (["--native"] if ex.native else []))
    if ex.lmdb:
        from ..tools.npz_to_lmdb import convert

        store = graphs["train"] / "graph_data.lmdb"
        convert(str(graphs["train"] / "graph_data.npz"), str(store))
        graphs["train"] = store
    seconds["pack"] = time.perf_counter() - t0
    return graphs


def accept(name: str, ex, args, out: Path, graphs: dict, train_dir: Path, nao: int) -> dict:
    """Step 4: the example's acceptance numbers."""
    from .. import cli
    from ..tools import band_cal
    from ..train.config import load_config

    if ex.acceptance == "mae":
        return {}
    example, pred_dir = ROOT / "examples" / name, out / "band_pred"
    band_cfg = _rewrite(
        example / "config_band_test.yaml", out / "config_band_test.yaml",
        {"dataset_params.graph_data_path": str(graphs["band"]),
         "profiler_params.train_dir": str(pred_dir),
         "setup.checkpoint_path": str(train_dir / "best")})
    cli.train_and_evaluate(load_config(band_cfg), device=args.device)
    band_npz = graphs["band"] / "graph_data.npz"
    if ex.acceptance == "bands":
        bands = band_deviation(str(band_npz), str(pred_dir), ex.ham_type, nao, ex.soc,
                               nk=ex.nk)
        return {"band_dev_max_meV": bands["band_dev_max_meV"],
                "band_dev_mean_meV": bands["band_dev_mean_meV"],
                "bands": bands["per_structure"]}
    # collinear: band_cal.yaml per spin channel, on the prediction and on the
    # teacher's stacks; then the MAE and its spatial and splitting parts
    from ..data.dataset import load_graph_npz

    for tag, ham in (("bands", str(pred_dir / "prediction_hamiltonian.npy")),
                     ("bands_ref", None)):
        band_cal.main(["--config", _rewrite(
            example / "band_cal.yaml", out / f"band_cal_{tag}.yaml",
            {"graph_data_path": str(band_npz), "hamiltonian_path": ham,
             "save_dir": str(out / tag)})])
    spin = spin_band_deviation(str(out / "bands"), str(out / "bands_ref"),
                               len(load_graph_npz(str(band_npz))))
    decomposition = spin_decomposition(np.load(pred_dir / "prediction_hamiltonian.npy"),
                                       np.load(pred_dir / "target_hamiltonian.npy"))
    print(f"[decomposition] {json.dumps(decomposition)}", flush=True)
    return {"band_dev_max_meV": max(s["band_dev_max_meV"] for s in spin.values()),
            "band_dev_mean_meV": float(np.mean([s["band_dev_mean_meV"]
                                                for s in spin.values()])),
            "spin_bands": spin, "decomposition": decomposition}


def band_finetune(args, out: Path, graphs: dict, train_dir: Path) -> dict:
    """Step 5: ``examples/sk/config_band_ft.yaml`` warm-started from the run's
    ``best.pt``."""
    from .. import cli
    from ..train.config import load_config

    ft_dir = out / "band_ft"
    if (ft_dir / "metrics.jsonl").exists():
        (ft_dir / "metrics.jsonl").unlink()
    ft_src = ROOT / "examples" / "sk" / "config_band_ft.yaml"
    ft_max = int(yaml.safe_load(ft_src.read_text())["optim_params"]["max_epochs"])
    ft_cfg = _rewrite(
        ft_src, out / "config_band_ft.yaml",
        {"dataset_params.graph_data_path": str(graphs["train"]),
         "profiler_params.train_dir": str(ft_dir),
         "setup.checkpoint_path": str(train_dir / "best")},
        optim_params={"max_epochs": min(ft_max, args.max_epochs or ft_max)})
    ft_logs = cli.train_and_evaluate(load_config(ft_cfg), device=args.device)
    ft_records = _records(ft_dir / "metrics.jsonl")
    ft_val = [r["val/mae_band_energy"] for r in ft_records]
    band_ft = {
        "epochs": len(ft_records),
        "test_mae_band_energy_Ha": float(ft_logs["mae_band_energy"]),
        "test_mae_hamiltonian_Ha": float(ft_logs["mae_hamiltonian"]),
        "val_mae_band_energy_first_Ha": float(ft_val[0]) if ft_val else None,
        "val_mae_band_energy_best_Ha": float(min(ft_val)) if ft_val else None,
        "sec_per_epoch_median": float(np.median([r["sec"] for r in ft_records]))
        if ft_records else None,
        "nonfinite_steps": int(sum(r.get("nonfinite_steps", 0) for r in ft_records)),
    }
    print(f"[band_ft] {json.dumps(band_ft)}", flush=True)
    return band_ft


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="The shipped examples' accuracy runs through "
                                             "the port")
    ap.add_argument("--example", choices=sorted(EXAMPLES), default=None)
    ap.add_argument("--out", default=None,
                    help="output directory (default chiprun_out/sk_accuracy[_<example>])")
    ap.add_argument("--max-epochs", type=int, default=None,
                    help="cap on the epochs (default: the config's max_epochs)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from <out>/train/best.pt")
    ap.add_argument("--soc", action="store_true", help="--example sk_soc")
    ap.add_argument("--band-ft", action="store_true",
                    help="then fine-tune on bands with examples/sk/config_band_ft.yaml")
    ap.add_argument("--n-si", type=int, default=None)
    ap.add_argument("--n-c", type=int, default=None)
    ap.add_argument("--n-sic", type=int, default=None)
    ap.add_argument("--n", type=int, default=None, help="structures of a spin set")
    ap.add_argument("--seed", type=int, default=7, help="the teacher's seed")
    ap.add_argument("--init-seed", type=int, default=None,
                    help="draw the initial weights with this seed (default: the CLI's 666)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .. import cli
    from ..train.config import load_config

    name = args.example or ("sk_soc" if args.soc else "sk")
    if args.soc and name != "sk_soc":
        raise SystemExit(f"--soc is --example sk_soc, not {name}")
    if args.init_seed is not None and args.resume:
        raise SystemExit("--init-seed starts a fresh run: not with --resume")
    if args.band_ft and name != "sk":
        raise SystemExit("--band-ft fine-tunes the sk model: --example sk")
    ex = EXAMPLES[name]
    example = ROOT / "examples" / name
    out = Path(args.out or ROOT / "chiprun_out" /
               ("sk_accuracy" if name == "sk" else f"sk_accuracy_{name}")).resolve()
    out.mkdir(parents=True, exist_ok=True)
    data, train_dir = out / "datasets" / name, out / "train"
    seconds = {}
    launches0 = tp_launches()

    graphs = make_data(name, ex, args, data, seconds)

    cfg = yaml.safe_load((example / "config.yaml").read_text())
    opt = dict(cfg.get("optim_params", {}))
    max_epochs = args.max_epochs or int(opt.get("max_epochs", 3000))
    done = _records(train_dir / "metrics.jsonl") if args.resume else []
    if not args.resume and (train_dir / "metrics.jsonl").exists():
        (train_dir / "metrics.jsonl").unlink()  # a fresh run starts a fresh log
    setup = {"resume": True, "load_from_checkpoint": True} if args.resume else {}
    start = train_dir / "best"
    if args.init_seed is not None:  # a warm start from the fresh trainer's draw
        start = initial_checkpoint(example / "config.yaml", args.init_seed, out / "init.pt")
        setup = {"load_from_checkpoint": True}
    fit_cfg = _rewrite(
        example / "config.yaml", out / "config.yaml",
        {"dataset_params.graph_data_path": str(graphs["train"]),
         "profiler_params.train_dir": str(train_dir),
         "setup.checkpoint_path": str(start)},
        setup=setup,
        optim_params={"max_epochs": max(max_epochs - len(done), 1),
                      "min_epochs": max(int(opt.get("min_epochs", 100)) - len(done), 0)})
    t0 = time.perf_counter()
    test_logs = cli.train_and_evaluate(load_config(fit_cfg), device=args.device)
    seconds["fit"] = time.perf_counter() - t0
    records = _records(train_dir / "metrics.jsonl")
    # the test split again at <train_dir>/best's parameters (a fit of 0 epochs
    # from it); the JAX package reports the final parameters', as test_mae_Ha
    best_logs = cli.train_and_evaluate(load_config(_rewrite(
        Path(fit_cfg), out / "config_test_best.yaml",
        {"profiler_params.train_dir": str(out / "test_best"),
         "setup.checkpoint_path": str(train_dir / "best"),
         "setup.load_from_checkpoint": True, "setup.resume": None},
        optim_params={"max_epochs": 0, "min_epochs": 0})), device=args.device)
    shutil.rmtree(out / "test_best")

    t0 = time.perf_counter()
    accepted = accept(name, ex, args, out, graphs, train_dir,
                      int(cfg["output_nets"]["HamGNN_out"]["nao_max"]))
    seconds["acceptance"] = time.perf_counter() - t0

    band_ft = None
    if args.band_ft:
        t0 = time.perf_counter()
        band_ft = band_finetune(args, out, graphs, train_dir)
        seconds["band_ft"] = time.perf_counter() - t0
    run_launches = {n: c - launches0[n] for n, c in tp_launches().items() if c - launches0[n]}
    per_step = step_launches(fit_cfg, args.device, train_dir)
    per_crystal = per_crystal_test_mae(fit_cfg, args.device, train_dir)

    # the configs' metrics are MAEs in Ha (the mean of the real and the
    # imaginary parts' where there are both)
    mae_keys = [k for k in test_logs if k.startswith("mae_")]
    val = [float(np.mean([r[f"val/{k}"] for k in mae_keys])) for r in records]
    best = int(np.argmin(val)) if val else -1
    epoch_s = [r["sec"] for r in records]
    result = {
        "example": name,
        "soc": ex.soc,
        "test_mae_Ha": float(np.mean([test_logs[k] for k in mae_keys])),
        "test_metrics": {k: float(v) for k, v in test_logs.items()},
        "best_val_mae_Ha": float(val[best]) if val else None,
        "best_val_metrics": ({k: float(records[best][f"val/{k}"]) for k in mae_keys}
                             if val else None),
        "best_val_epoch": best,
        "val_mae_last_Ha": float(val[-1]) if val else None,
        "test_mae_best_Ha": float(np.mean([best_logs[k] for k in mae_keys])),
        "test_mae_per_crystal": per_crystal,
        "epochs": len(records),
        "sec_per_epoch_median": float(np.median(epoch_s)) if epoch_s else None,
        "sec_first_epoch": float(epoch_s[0]) if epoch_s else None,
        "band_dev_max_meV": None,
        "band_dev_mean_meV": None,
        "bands": [],
        **accepted,
        "seconds": seconds,
        "resumed": args.resume,
        "seed": args.seed,
        "init_seed": 666 if args.init_seed is None else args.init_seed,
        "band_ft": band_ft,
        "tp_launches_run": run_launches,
        "tp_launches_per_step": per_step,
        "jax": ex.jax,
        "card": _card(),
    }
    if ex.lmdb:
        result["store"] = ("lmdb" if importlib.util.find_spec("lmdb") is not None
                           else "lmdb-lite")
    result["marks"] = judge(ex, result)
    (out / "result.json").write_text(json.dumps(result, indent=1))
    shutil.rmtree(out / "datasets")
    for path in train_dir.glob("*.npy"):  # the test set's predictions and targets
        path.unlink()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
