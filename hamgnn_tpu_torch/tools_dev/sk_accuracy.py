"""The SK accuracy run through the port alone: the four steps of
``examples/sk/README.md`` with ``hamgnn_tpu_torch`` (the counterpart of
``tools_dev/band_acceptance.py``, and with ``--soc`` of
``tools_dev/soc_band_acceptance.py``).

    python -m hamgnn_tpu_torch.tools_dev.sk_accuracy [--out chiprun_out/sk_accuracy]
        [--max-epochs N] [--resume] [--soc] [--band-ft] [--device cpu]

1. make the seeded teacher data (``tools.sk_dataset --band-set``, 150 Si,
   150 C and 100 SiC structures by default);
2. pack it twice with ``tools.graph_data_gen``: the training set and the
   pristine band set;
3. train with ``examples/sk/config.yaml`` (``examples/sk_soc`` with
   ``--soc``) under the config's own stopping rule;
4. predict the pristine band set from ``<train_dir>/best`` and compare its
   bands with the teacher's within +-5 eV of E_F (60 k-points along each
   crystal's auto path, 48 with ``--soc``, as the JAX package's scripts);
5. with ``--band-ft``, the secondary (band-energy) training of the
   reference's two-stage workflow: ``examples/sk/config_band_ft.yaml`` on the
   training set of step 2, warm-started from ``<train_dir>/best.pt`` at the
   config's fresh learning rate, its band steps captured on the card, under
   its own stopping rule (``max_epochs`` capped by ``--max-epochs``) into
   ``<out>/band_ft``; its epochs, test metrics and
   seconds an epoch go into the result under ``band_ft``.

Everything is written under ``--out``: the data, rewritten copies of the
example YAMLs (paths moved under ``--out``, ``max_epochs`` from
``--max-epochs``), the training directory and the band predictions.  The
data (~1 GB at the defaults, regenerated bit for bit from seed 7) is removed
at the end, so that the directory holds the checkpoint, the logs, the
predictions and ``result.json`` (~45 MB; ~70 MB with ``--soc``).
``--resume`` makes the data again and continues the training from
``<out>/train/best.pt`` with its optimizer state and learning rate
(``setup.resume``), appending to ``metrics.jsonl``; the epochs already run are
taken off ``min_epochs`` and ``max_epochs``, and the patience counters
restart.  The model runs on the card unless ``--device cpu``; the data tools
run on the host.  Prints one JSON line: the test MAE and the best validation
MAE (Ha), the epochs run, seconds per epoch, the band deviations (meV) and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import yaml

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
    given path and ``sections`` merged in, written to ``dst``."""
    cfg = yaml.safe_load(src.read_text())
    for dotted, value in paths.items():
        node = cfg
        *parents, leaf = dotted.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    for section, keys in sections.items():
        cfg.setdefault(section, {}).update(keys)
    dst.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(dst)


def _records(path: Path) -> list:
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def band_deviation(graph_path: str, pred_dir: str, nao: int, soc: bool, window: float,
                   nk: int) -> dict:
    """Bands of the predicted and the teacher Hamiltonians of each crystal of
    ``graph_path`` along its auto k-path; deviations within ``window`` eV of
    the teacher's E_F, in meV."""
    from ..data.dataset import load_graph_npz
    from ..models.basis import get_basis_set
    from ..physics.kpoints import auto_k_path
    from ..tools.band_cal import band_structure_for_crystal

    basis = get_basis_set("openmx", nao)
    graphs = load_graph_npz(graph_path)
    if soc:
        hr = np.load(os.path.join(pred_dir, "prediction_hamiltonian_real.npy"))
        hi = np.load(os.path.join(pred_dir, "prediction_hamiltonian_imag.npy"))
    else:
        hr, hi = np.load(os.path.join(pred_dir, "prediction_hamiltonian.npy")), None
    devs, per = [], []
    ofs = 0
    for idx, c in enumerate(graphs):
        n, e = len(c["z"]), np.asarray(c["edge_index"]).shape[1]
        rows = slice(ofs, ofs + n + e)
        ofs += n + e
        nodes, _labels = auto_k_path(np.asarray(c["cell"], float).reshape(3, 3))
        t_r = np.concatenate([np.asarray(c["Hon"]), np.asarray(c["Hoff"])])
        kw_p = kw_t = {}
        if soc:
            kw_p = dict(soc=True, ih_rows=hi[rows])
            kw_t = dict(soc=True, ih_rows=np.concatenate([np.asarray(c["iHon"]),
                                                          np.asarray(c["iHoff"])]))
        rp = band_structure_for_crystal(c, hr[rows], nao, basis, nk, nodes, **kw_p)
        rr = band_structure_for_crystal(c, t_r, nao, basis, nk, nodes, **kw_t)
        win = np.abs(rr["bands"] - rr["fermi"]) < window
        dev = np.abs(rp["bands"] - rr["bands"])[win]
        devs.append(dev.ravel())
        per.append({"n_atoms": n, "max_meV": float(dev.max() * 1e3),
                    "mean_meV": float(dev.mean() * 1e3), "gap_ref_eV": float(rr["gap"]),
                    "gap_pred_eV": float(rp["gap"])})
        print(f"[bands {idx}] n={n} max|dE|={dev.max() * 1e3:.3f} meV "
              f"mean={dev.mean() * 1e3:.3f} meV gap_ref={rr['gap']:.4f} "
              f"gap_pred={rp['gap']:.4f} eV", flush=True)
    dev = np.concatenate(devs)
    return {"band_dev_max_meV": float(dev.max() * 1e3),
            "band_dev_mean_meV": float(dev.mean() * 1e3), "per_structure": per}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="SK accuracy run through the port")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sk_accuracy"))
    ap.add_argument("--max-epochs", type=int, default=None,
                    help="cap on the epochs (default: the config's max_epochs)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from <out>/train/best.pt")
    ap.add_argument("--soc", action="store_true", help="the SOC set and examples/sk_soc")
    ap.add_argument("--band-ft", action="store_true",
                    help="then fine-tune on bands with examples/sk/config_band_ft.yaml")
    ap.add_argument("--n-si", type=int, default=150)
    ap.add_argument("--n-c", type=int, default=150)
    ap.add_argument("--n-sic", type=int, default=100)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .. import cli
    from ..tools import graph_data_gen, sk_dataset
    from ..train.config import load_config

    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    example = ROOT / "examples" / ("sk_soc" if args.soc else "sk")
    data, train_dir, pred_dir = out / "datasets" / "sk", out / "train", out / "band_pred"
    seconds = {}

    t0 = time.perf_counter()
    sk_dataset.main(["--out", str(data), "--band-set", "--seed", "7", "--n-si", str(args.n_si),
                     "--n-c", str(args.n_c), "--n-sic", str(args.n_sic)]
                    + (["--soc"] if args.soc else []))
    seconds["teacher"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    graphs = {}
    for name, yml, scf in (("train", "graph_data_gen.yaml", data / "struct_*"),
                           ("band", "graph_data_gen_band.yaml",
                            Path(str(data) + "_band") / "pristine_*")):
        graphs[name] = out / "datasets" / f"{name}_graph"
        graph_data_gen.main(["--config", _rewrite(
            example / yml, out / yml,
            {"graph_data_save_path": str(graphs[name]), "scfout_paths": str(scf)})])
    seconds["pack"] = time.perf_counter() - t0

    cfg = yaml.safe_load((example / "config.yaml").read_text())
    opt = dict(cfg.get("optim_params", {}))
    max_epochs = args.max_epochs or int(opt.get("max_epochs", 3000))
    done = _records(train_dir / "metrics.jsonl") if args.resume else []
    if not args.resume and (train_dir / "metrics.jsonl").exists():
        (train_dir / "metrics.jsonl").unlink()  # a fresh run starts a fresh log
    setup = {"resume": True, "load_from_checkpoint": True} if args.resume else {}
    fit_cfg = _rewrite(
        example / "config.yaml", out / "config.yaml",
        {"dataset_params.graph_data_path": str(graphs["train"]),
         "profiler_params.train_dir": str(train_dir),
         "setup.checkpoint_path": str(train_dir / "best")},
        setup=setup,
        optim_params={"max_epochs": max(max_epochs - len(done), 1),
                      "min_epochs": max(int(opt.get("min_epochs", 100)) - len(done), 0)})
    t0 = time.perf_counter()
    test_logs = cli.train_and_evaluate(load_config(fit_cfg), device=args.device)
    seconds["fit"] = time.perf_counter() - t0
    records = _records(train_dir / "metrics.jsonl")

    band_cfg = _rewrite(
        example / "config_band_test.yaml", out / "config_band_test.yaml",
        {"dataset_params.graph_data_path": str(graphs["band"]),
         "profiler_params.train_dir": str(pred_dir),
         "setup.checkpoint_path": str(train_dir / "best")})
    t0 = time.perf_counter()
    cli.train_and_evaluate(load_config(band_cfg), device=args.device)
    bands = band_deviation(str(graphs["band"] / "graph_data.npz"), str(pred_dir),
                           int(cfg["output_nets"]["HamGNN_out"]["nao_max"]), args.soc,
                           window=5.0, nk=48 if args.soc else 60)
    seconds["bands"] = time.perf_counter() - t0

    band_ft = None
    if args.band_ft:
        if args.soc:
            raise SystemExit("--band-ft fine-tunes the non-SOC model: no --soc")
        ft_dir = out / "band_ft"
        if (ft_dir / "metrics.jsonl").exists():
            (ft_dir / "metrics.jsonl").unlink()
        ft_src = example / "config_band_ft.yaml"
        ft_max = int(yaml.safe_load(ft_src.read_text())["optim_params"]["max_epochs"])
        ft_cfg = _rewrite(
            ft_src, out / "config_band_ft.yaml",
            {"dataset_params.graph_data_path": str(graphs["train"]),
             "profiler_params.train_dir": str(ft_dir),
             "setup.checkpoint_path": str(train_dir / "best")},
            optim_params={"max_epochs": min(ft_max, args.max_epochs or ft_max)})
        t0 = time.perf_counter()
        ft_logs = cli.train_and_evaluate(load_config(ft_cfg), device=args.device)
        seconds["band_ft"] = time.perf_counter() - t0
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

    # the configs' metrics are MAEs in Ha (the mean of the real and the
    # imaginary parts' with --soc)
    mae_keys = [k for k in test_logs if k.startswith("mae_")]
    val = [float(np.mean([r[f"val/{k}"] for k in mae_keys])) for r in records]
    best = int(np.argmin(val)) if val else -1
    epoch_s = [r["sec"] for r in records]
    result = {
        "soc": args.soc,
        "test_mae_Ha": float(np.mean([test_logs[k] for k in mae_keys])),
        "test_metrics": {k: float(v) for k, v in test_logs.items()},
        "best_val_mae_Ha": float(val[best]) if val else None,
        "best_val_epoch": best,
        "epochs": len(records),
        "sec_per_epoch_median": float(np.median(epoch_s)) if epoch_s else None,
        "sec_first_epoch": float(epoch_s[0]) if epoch_s else None,
        "band_dev_max_meV": bands["band_dev_max_meV"],
        "band_dev_mean_meV": bands["band_dev_mean_meV"],
        "bands": bands["per_structure"],
        "seconds": seconds,
        "resumed": args.resume,
        "band_ft": band_ft,
        "card": _card(),
    }
    (out / "result.json").write_text(json.dumps(result, indent=1))
    shutil.rmtree(out / "datasets")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
