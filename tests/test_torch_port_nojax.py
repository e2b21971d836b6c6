"""The port imports no JAX and nothing of the JAX package.

In a subprocess where ``jax``, ``flax``, ``optax``, ``orbax`` and
``hamgnn_tpu`` cannot be imported, every module of ``hamgnn_tpu_torch``
imports (the trainer and optimizer, the probes, the band physics and the
tools included) and ``python -m hamgnn_tpu_torch.cli`` runs a ``stage: fit``
config and then a ``stage: test`` config from its ``best.pt`` on the CPU,
under the default engine and under ``HAMGNN_TP_ENGINE=zonal``; with a band
loss in the config, followed by ``tools.band_cal`` on the prediction and the
three probe entry points; with the SOC head (so3), testing from the
reference's ``<train_dir>/best`` name; with the non-collinear magnetic head
on an lmdb-lite store written by ``tools.npz_to_lmdb``; with the
Transformer representation (attention, correlation blocks, KAN generators).
The data tools (the SK teacher in every format, the three ``graph_data_gen``)
run with JAX blocked too, and their output trains, predicts and gives bands; so do
the Uni-HamGNN CLI, ``band_cal_parallel``, the CLI under ``setup.parallel.mode``
``halo`` and ``dp`` (one process over gloo), the magnetism workflows and the
wavefunction cube.
``chip_smoke.py`` must fail, printing no result, where no GPU is available.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "hamgnn_tpu_torch"
BLOCKED = ("jax", "flax", "optax", "orbax", "hamgnn_tpu")

SCRIPT = r"""
import sys
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, {root!r})
import importlib, pkgutil, runpy
import numpy as np
import yaml
import hamgnn_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(hamgnn_tpu_torch.__path__, "hamgnn_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
from hamgnn_tpu_torch.data.dataset import save_graph_npz
from hamgnn_tpu_torch.data.synthetic import (add_random_hamiltonian_targets,
                                             add_random_soc_targets, add_random_spin_targets,
                                             make_crystal)
work = {work!r}
soc = {soc!r}
spin = {spin!r}
transformer = {transformer!r}
rng = np.random.default_rng(0)
crystals = [add_random_hamiltonian_targets(rng, make_crystal(rng, n_atoms=4, cutoff=4.0))
            for _ in range(3)]
if soc:
    crystals = [add_random_soc_targets(rng, c) for c in crystals]
if spin:
    crystals = [add_random_spin_targets(rng, c, "noncollinear") for c in crystals]
save_graph_npz(work + "/graph_data.npz", crystals)
data_path = work
if spin:
    from hamgnn_tpu_torch.tools.npz_to_lmdb import convert
    data_path = work + "/graph_data.lmdb"
    assert convert(work + "/graph_data.npz", data_path) == 3
cfg = {{
    "setup": {{"stage": "fit"}},
    "dataset_params": {{"graph_data_path": data_path, "batch_size": 1, "train_ratio": 1 / 3,
                        "val_ratio": 1 / 3, "test_ratio": 1 / 3}},
    "optim_params": {{"min_epochs": 0, "max_epochs": 1}},
    "profiler_params": {{"train_dir": work + "/fit"}},
    "representation_nets": {{"HamGNN_pre": {{
        "irreps_node_features": "4x0e+2x1o", "irreps_edge_sh": "0e+1o+2e",
        "num_layers": 1, "num_radial": 4, "cutoff": 4.0, "radial_MLP": [4],
        "num_types": 16}}}},
    "output_nets": {{"HamGNN_out": {{"nao_max": 14}}}},
}}
band = {band!r}
if band:
    cfg["output_nets"]["HamGNN_out"].update(
        calculate_band_energy=True, num_k=2, band_num_control=2, k_path="auto")
    cfg["losses_metrics"] = {{"losses": [
        {{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
          "loss_weight": 27.211}},
        {{"metric": "mae", "prediction": "band_energy", "target": "band_energy",
          "loss_weight": 0.27211}}], "metrics": []}}
if spin:
    cfg["output_nets"]["HamGNN_out"].update(spin_constrained=True, use_learned_weight=False)
if transformer:
    cfg["setup"]["GNN_Net"] = "HamGNNTransformer"
    cfg["representation_nets"]["HamGNN_pre"].update(num_heads=2, num_hidden_features=4,
                                                   use_kan=True)
if soc or spin:
    if soc:
        cfg["output_nets"]["HamGNN_out"].update(soc_switch=True, soc_basis="so3")
    cfg["losses_metrics"] = {{"losses": [
        {{"metric": "mae", "prediction": p, "target": p, "loss_weight": 27.211}}
        for p in ("hamiltonian_real", "hamiltonian_imag")], "metrics": []}}
for stage in ("fit", "test"):
    if stage == "test":
        # a SOC run reads the reference's name for the best weights
        cfg["setup"] = dict(cfg["setup"], stage="test",
                            checkpoint_path=work + ("/fit/best" if soc else "/fit/best.pt"))
        cfg["profiler_params"] = {{"train_dir": work + "/out"}}
    with open(work + "/config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    sys.argv = ["hamgnn_tpu_torch.cli", "--config", work + "/config.yaml", "--device", "cpu"]
    runpy.run_module("hamgnn_tpu_torch.cli", run_name="__main__")
assert open(work + "/fit/metrics.jsonl").read().count("train_loss") == 1
pred = np.load(work + ("/out/prediction_hamiltonian_real.npy" if soc or spin
                       else "/out/prediction_hamiltonian.npy"))
if soc or spin:
    assert np.isfinite(np.load(work + "/out/prediction_hamiltonian_imag.npy")).all()
if band:
    assert "val/mae_band_energy" in open(work + "/fit/metrics.jsonl").read()
    with open(work + "/band_cal.yaml", "w") as f:
        yaml.safe_dump({{"nao_max": 14, "graph_data_path": work + "/graph_data.npz",
                        "hamiltonian_path": work + "/out/prediction_hamiltonian.npy",
                        "nk": 5, "save_dir": work + "/bands", "auto_mode": True}}, f)
    sys.argv = ["band_cal", "--config", work + "/band_cal.yaml"]
    runpy.run_module("hamgnn_tpu_torch.tools.band_cal", run_name="__main__")
    assert np.isfinite(np.load(work + "/bands/structure_2_bands.npz")["bands"]).all()
    for name, extra in (("op_probe", []), ("op_probe2", []),
                        ("throughput_probe", ["--edges", "64"])):
        sys.argv = [name, "--device", "cpu"] + extra
        runpy.run_module("hamgnn_tpu_torch.tools_dev." + name, run_name="__main__")
for sub in ("tools_dev.op_probe", "tools_dev.op_probe2", "tools_dev.throughput_probe",
            "physics.band", "physics.kpoints", "tools.band_cal", "utils.profiling",
            "nn.attention", "nn.symmetric_contraction", "e3.tensor_product",
            "e3.normalization", "nn.electron_configurations"):
    assert "hamgnn_tpu_torch." + sub in mods, sub
assert not any(sys.modules.get(b) for b in {blocked!r})
from hamgnn_tpu_torch.e3 import zonal_tp
print("FRAME_BUILDS", zonal_tp.FRAME_MEMO.builds)
print("MODULES", len(mods), "PRED", pred.shape, bool(np.isfinite(pred).all()))
"""


def _run_script(tmp_path, engine, band=False, soc=False, spin=False, transformer=False):
    """Runs SCRIPT in a subprocess; returns (modules imported, Wigner-D
    frame builds, whether the predictions are finite)."""
    code = SCRIPT.format(blocked=BLOCKED, root=str(ROOT), work=str(tmp_path), band=band,
                         soc=soc, spin=spin, transformer=transformer)
    env = {k: v for k, v in os.environ.items() if k != "HAMGNN_TP_ENGINE"}
    if engine is not None:
        env["HAMGNN_TP_ENGINE"] = engine
    # tiny tensors: threads only contend with the other test workers
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    line = [l for l in lines if l.startswith("MODULES")][-1]
    builds = int([l for l in lines if l.startswith("FRAME_BUILDS")][-1].split()[1])
    return int(line.split()[1]), builds, line.endswith("True")


def test_port_modules_and_cli_run_without_jax(tmp_path):
    n_mods, builds, finite = _run_script(tmp_path, None)
    assert n_mods >= 22
    assert builds == 0  # the default engine builds no edge frames
    assert finite


def test_port_cli_trains_and_predicts_under_zonal_without_jax(tmp_path):
    """The same fit-then-test run with ``HAMGNN_TP_ENGINE=zonal``: the edge
    frames are built (once per forward), and nothing of JAX is imported."""
    n_mods, builds, finite = _run_script(tmp_path, "zonal")
    assert n_mods >= 22
    assert builds >= 3  # one train step, one validation pass, one test pass at least
    assert finite


def test_port_band_path_tools_and_probes_run_without_jax(tmp_path):
    """Fit and test with a band loss (``k_path: auto``), ``band_cal`` on the
    prediction and the probes' entry points, nothing of JAX importable."""
    n_mods, _builds, finite = _run_script(tmp_path, None, band=True)
    assert n_mods >= 32
    assert finite


def test_port_soc_fit_and_test_run_without_jax(tmp_path):
    """A SOC (so3) fit on the spinor targets, then ``stage: test`` from
    ``<train_dir>/best``, nothing of JAX importable."""
    n_mods, _builds, finite = _run_script(tmp_path, None, soc=True)
    assert n_mods >= 32
    assert finite


def test_port_magnetic_fit_and_test_from_a_store_run_without_jax(tmp_path):
    """A non-collinear magnetic fit on an lmdb-lite store written by the
    port's ``npz_to_lmdb``, then ``stage: test`` from ``best.pt``, nothing
    of JAX importable."""
    n_mods, _builds, finite = _run_script(tmp_path, None, spin=True)
    assert n_mods >= 34
    assert finite


def test_port_transformer_fit_and_test_run_without_jax(tmp_path):
    """A Transformer fit (attention, correlation blocks, KAN radial
    generators), then ``stage: test`` from ``best.pt``, nothing of JAX
    importable."""
    n_mods, _builds, finite = _run_script(tmp_path, None, transformer=True)
    assert n_mods >= 39
    assert finite


DATAGEN_SCRIPT = r"""
import sys
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, {root!r})
import runpy
import numpy as np
import yaml
work = {work!r}


def run(mod, *argv):
    sys.argv = [mod, *argv]
    runpy.run_module(mod, run_name="__main__")


sk = "hamgnn_tpu_torch.tools.sk_dataset"
small = ["--n-si", "1", "--n-c", "1", "--n-sic", "1"]
run(sk, "--out", work + "/openmx", "--band-set", *small)
run(sk, "--out", work + "/soc", "--soc", *small)
run(sk, "--out", work + "/siesta", "--format", "siesta", "--nao-max", "19", *small)
run(sk, "--out", work + "/abacus", "--format", "abacus", "--nao-max", "27", *small)
for kind in ("collinear", "noncollinear", "spinsoc"):
    run(sk, kind, "--out", work + "/" + kind, "--n", "2")
from hamgnn_tpu_torch.data.dataset import load_graph_npz
for kind in ("collinear", "noncollinear", "spinsoc"):
    assert len(load_graph_npz(work + "/" + kind + "/graph_data.npz")) == 2
gdg = "hamgnn_tpu_torch.tools.graph_data_gen"
packs = {{
    "openmx": (gdg, {{"nao_max": 14, "scfout_paths": work + "/openmx/struct_*"}}),
    "band": (gdg, {{"nao_max": 14, "scfout_paths": work + "/openmx_band/pristine_*"}}),
    "soc": (gdg, {{"nao_max": 14, "scfout_paths": work + "/soc/struct_*", "soc_switch": True}}),
    "siesta": (gdg + "_siesta", {{"nao_max": 19, "calc_paths": work + "/siesta/struct_*",
                                 "h0_hsx_file_name": "H0.HSX"}}),
    "abacus": (gdg + "_abacus", {{"nao_max": 27, "calc_paths": work + "/abacus/struct_*",
                                 "h0_file_name": "data-H0R-sparse_SPIN0.csr"}}),
}}
for name, (mod, cfg) in packs.items():
    cfg["graph_data_save_path"] = work + "/graph_" + name
    with open(work + "/gdg_" + name + ".yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    run(mod, "--config", work + "/gdg_" + name + ".yaml")
    graphs = load_graph_npz(work + "/graph_" + name + "/graph_data.npz")
    assert len(graphs) == 3 and "Hon0" in graphs[0], name
cfg = {{
    "setup": {{"stage": "fit"}},
    "dataset_params": {{"graph_data_path": work + "/graph_openmx", "batch_size": 1,
                        "train_ratio": 1 / 3, "val_ratio": 1 / 3, "test_ratio": 1 / 3}},
    "optim_params": {{"min_epochs": 0, "max_epochs": 1}},
    "profiler_params": {{"train_dir": work + "/fit"}},
    "representation_nets": {{"HamGNN_pre": {{
        "irreps_node_features": "4x0e+2x1o", "irreps_edge_sh": "0e+1o+2e",
        "num_layers": 1, "num_radial": 4, "cutoff": 6.0, "radial_MLP": [4]}}}},
    "output_nets": {{"HamGNN_out": {{"nao_max": 14, "add_H0": True}}}},
}}
for stage in ("fit", "test"):
    if stage == "test":
        cfg["setup"] = {{"stage": "test", "checkpoint_path": work + "/fit/best"}}
        cfg["dataset_params"]["graph_data_path"] = work + "/graph_band"
        cfg["profiler_params"] = {{"train_dir": work + "/pred"}}
    with open(work + "/config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    run("hamgnn_tpu_torch.cli", "--config", work + "/config.yaml", "--device", "cpu")
with open(work + "/band_cal.yaml", "w") as f:
    yaml.safe_dump({{"nao_max": 14, "graph_data_path": work + "/graph_band/graph_data.npz",
                    "hamiltonian_path": work + "/pred/prediction_hamiltonian.npy",
                    "nk": 4, "save_dir": work + "/bands", "auto_mode": True}}, f)
run("hamgnn_tpu_torch.tools.band_cal", "--config", work + "/band_cal.yaml")
assert np.isfinite(np.load(work + "/bands/structure_2_bands.npz")["bands"]).all()
assert not any(sys.modules.get(b) for b in {blocked!r})
print("DATAGEN OK")
"""


def test_port_data_tools_and_sk_pipeline_run_without_jax(tmp_path):
    """``tools.sk_dataset`` for every ``--format``, ``--soc``, ``collinear``,
    ``noncollinear`` and ``spinsoc``; ``graph_data_gen``, ``_siesta`` and
    ``_abacus`` on their output; then fit, test from ``<train_dir>/best`` and
    ``band_cal`` on the pristine band set, nothing of JAX importable."""
    code = DATAGEN_SCRIPT.format(blocked=BLOCKED, root=str(ROOT), work=str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "HAMGNN_TP_ENGINE"}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.splitlines()[-1] == "DATAGEN OK"


TOOLS_SCRIPT = r"""
import sys
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, {root!r})
import importlib, os, runpy
import numpy as np
import yaml
work = {work!r}
for mod in {new_modules!r}:
    importlib.import_module(mod)


def run(mod, *argv):
    sys.argv = [mod, *argv]
    runpy.run_module(mod, run_name="__main__")


def dump(name, cfg):
    with open(work + "/" + name, "w") as f:
        yaml.safe_dump(cfg, f)
    return work + "/" + name


from hamgnn_tpu_torch.data.dataset import load_graph_npz, save_graph_npz
from hamgnn_tpu_torch.data.synthetic import (add_random_hamiltonian_targets,
                                             add_random_soc_targets, make_crystal)
from hamgnn_tpu_torch.models.model import init_weights
from hamgnn_tpu_torch.tools.uni_hamgnn import HamiltonianPredictor
rng = np.random.default_rng(0)
plain = [add_random_hamiltonian_targets(rng, make_crystal(rng, n_atoms=3, cutoff=4.0))
         for _ in range(2)]
save_graph_npz(work + "/nonsoc.npz", plain)
save_graph_npz(work + "/soc.npz", [add_random_soc_targets(rng, dict(c)) for c in plain])

# the Uni-HamGNN CLI on a package in the port's form
model = {{"representation_nets": {{"HamGNN_pre": {{
    "irreps_node_features": "4x0e+2x1o", "irreps_edge_sh": "0e+1o+2e", "num_layers": 1,
    "num_radial": 4, "cutoff": 4.0, "radial_MLP": [4], "num_types": 16}}}}}}
pred = HamiltonianPredictor(
    dump("nonsoc.yaml", dict(model, output_nets={{"HamGNN_out": {{"nao_max": 14}}}})),
    dump("soc.yaml", dict(model, output_nets={{"HamGNN_out": {{
        "nao_max": 14, "soc_switch": True, "soc_basis": "so3"}}}})),
    soc_switch=True, device="cpu")
init_weights(pred.model_nonsoc, 0)
init_weights(pred.model_soc, 1)
pred.save(work + "/pkg")
run("hamgnn_tpu_torch.tools.uni_hamgnn", "--device", "cpu", "--config", dump("Input.yaml", {{
    "model_pkl_path": work + "/pkg", "non_soc_data_dir": work + "/nonsoc.npz",
    "soc_data_dir": work + "/soc.npz", "output_dir": work + "/uni", "calculate_mae": True}}))
rows = np.load(work + "/uni/prediction_hamiltonian.npy")
assert rows.shape == (sum(c["z"].shape[0] + c["edge_index"].shape[1] for c in plain), 784)
assert np.isfinite(rows).all()

# band_cal_parallel on the stored Hamiltonians
run("hamgnn_tpu_torch.tools.band_cal_parallel", "--device", "cpu", "--config",
    dump("bcp.yaml", {{"nao_max": 14, "graph_data_path": work + "/nonsoc.npz", "nk": 6,
                       "k_batch": 4, "save_dir": work + "/bands"}}))
assert np.isfinite(np.load(work + "/bands/bands_1.npz")["bands"]).all()

# the halo partition and data parallel through the CLI, one process over gloo,
# then a one-device test from the halo run's best.pt
par_cfg = dict(model, output_nets={{"HamGNN_out": {{"nao_max": 14}}}},
               dataset_params={{"graph_data_path": work + "/nonsoc.npz", "batch_size": 1,
                                "train_ratio": 0.5, "val_ratio": 0.5, "test_ratio": 0.0}},
               optim_params={{"min_epochs": 0, "max_epochs": 1}})
for mode in ("halo", "dp"):
    run("hamgnn_tpu_torch.cli", "--device", "cpu", "--config", dump(mode + ".yaml", dict(
        par_cfg, setup={{"stage": "fit", "parallel": {{"mode": mode}}}},
        profiler_params={{"train_dir": work + "/" + mode}})))
    assert open(work + "/" + mode + "/metrics.jsonl").read().count("train_loss") == 1
run("hamgnn_tpu_torch.cli", "--device", "cpu", "--config", dump("halo_test.yaml", dict(
    par_cfg, setup={{"stage": "test", "checkpoint_path": work + "/halo/best.pt"}},
    profiler_params={{"train_dir": work + "/halo_test"}})))
assert np.isfinite(np.load(work + "/halo_test/prediction_hamiltonian.npy")).all()

# magnetism: a collinear deck from a POSCAR, a non-collinear graph from scfout files
with open(work + "/POSCAR", "w") as f:
    f.write("Si2\n1.0\n3.8 0 0\n0 3.8 0\n0 0 3.8\nSi\n2\nDirect\n0 0 0\n0.25 0.25 0.25\n")
run("hamgnn_tpu_torch.tools.magnetism", "convert-collinear", "--config", dump("c.yaml", {{
    "inputs": {{"patterns": [work + "/POSCAR"]}}, "outputs": {{"directory": work + "/mag"}}}}))
assert "Atoms.SpeciesAndCoordinates" in open(work + "/mag/collinear_1.dat").read()
run("hamgnn_tpu_torch.tools.sk_dataset", "--out", work + "/scf", "--soc", "--n-si", "1",
    "--n-c", "1", "--n-sic", "0")
run("hamgnn_tpu_torch.tools.magnetism", "pack-graph-data", "--config", dump("p.yaml", {{
    "inputs": {{"patterns": [work + "/scf/struct_*"]}}, "outputs": {{"directory": work + "/mag"}},
    "pack_graph_data": {{"nao_max": 14, "collinear": False}}}}))
packed = load_graph_npz(work + "/mag/graph_data.npz")
assert len(packed) == 2 and packed[0]["Hon"].shape[1] == 784

# the wavefunction cube, Gaussian fallback
np.save(work + "/vecs.npy", rng.normal(size=(2, 13 * 3)))
run("hamgnn_tpu_torch.tools.wfn_export", "--config", dump("w.yaml", {{
    "graph_data_path": work + "/nonsoc.npz", "eigen_vecs_path": work + "/vecs.npy",
    "nao_max": 14, "band_index": 1, "grid": [4, 4, 4], "save_dir": work + "/wfn"}}))
assert open(work + "/wfn/band_1.cube").read().count("\n") > 10
assert not any(sys.modules.get(b) for b in {blocked!r})
print("TOOLS OK")
"""
NEW_MODULES = ("interfaces.orbax_reader", "interfaces.torch_ckpt", "interfaces.e3nn_compat",
               "interfaces.uni_pickle", "interfaces.pao", "tools.uni_hamgnn",
               "tools.band_cal_parallel", "tools.magnetism", "tools.wfn_export",
               "physics.matrix_operations", "utils.triplets", "models.view",
               "parallel.halo", "parallel.halo_model", "parallel.halo_trainer",
               "parallel.multihost", "parallel.sharding", "parallel.trainer")


def test_port_tools_run_without_jax(tmp_path):
    """The Uni-HamGNN CLI on a package in the port's form (two stages, CPU),
    ``band_cal_parallel``, ``magnetism convert-collinear`` and
    ``pack-graph-data`` (on the SK teacher's non-collinear scfout files) and
    the ``wfn_export`` cube, with every checkpoint-reader and tool module imported and
    nothing of JAX importable."""
    code = TOOLS_SCRIPT.format(blocked=BLOCKED, root=str(ROOT), work=str(tmp_path),
                               new_modules=["hamgnn_tpu_torch." + m for m in NEW_MODULES])
    env = {k: v for k, v in os.environ.items() if k != "HAMGNN_TP_ENGINE"}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.splitlines()[-1] == "TOOLS OK"


def test_source_import_check_covers_the_checkpoint_readers_and_tools():
    for mod in NEW_MODULES:
        rel = mod.replace(".", "/") + ".py"
        assert PKG / rel in set(PKG.rglob("*.py")), rel


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    for name in _imports(path):
        assert name.split(".")[0] not in BLOCKED, f"{path.name} imports {name}"


def test_source_import_check_covers_the_magnetic_head_and_the_store():
    for rel in ("models/spin.py", "data/dataset.py", "tools/npz_to_lmdb.py"):
        assert PKG / rel in set(PKG.rglob("*.py")), rel


def test_source_import_check_covers_the_band_solver():
    """The band branch's eigensolve and its probe, and the graphs cut around
    it."""
    for rel in ("physics/eigh.py", "tools_dev/eigh_probe.py", "train/captured.py",
                "utils/cuda_graphs.py"):
        assert PKG / rel in set(PKG.rglob("*.py")), rel


def test_source_import_check_covers_the_data_tools():
    for rel in ("tools/sk_dataset.py", "tools/graph_data_gen.py", "tools/graph_data_gen_siesta.py",
                "tools/graph_data_gen_abacus.py", "tools/poscar2openmx.py",
                "tools/poscar2abacus.py", "interfaces/openmx.py", "interfaces/siesta.py",
                "interfaces/abacus.py", "interfaces/scfout_writer.py",
                "interfaces/openmx_tables.py", "interfaces/native.py",
                "tools_dev/sk_accuracy.py", "tools_dev/sk_examples.py"):
        assert PKG / rel in set(PKG.rglob("*.py")), rel


def test_chip_smoke_fails_without_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    env = dict(os.environ)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, shutil.copy(ROOT / "chip_smoke.py", tmp_path))):
        r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                           timeout=120, cwd=str(cwd), env=env)
        assert r.returncode != 0
        for line in r.stdout.splitlines():
            with pytest.raises(ValueError):
                json.loads(line)
