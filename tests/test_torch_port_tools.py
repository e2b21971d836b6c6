"""The port's host tools and small physics modules against the JAX package's.

* ``tools/band_cal_parallel.py``: ``solve_bands_batched`` on the CPU against
  the JAX one (complex64 both, atol 5e-5 / rtol 1e-4) and scipy's float64
  ``eigh`` (atol 1e-4, as the JAX package's own test); the CLI's band files
  against the JAX CLI's; a mesh refused;
* ``tools/magnetism.py``: the spin utilities element-exact, the collinear
  and non-collinear decks and the XSF byte for byte, the packers
  element-exact, and the four workflows of both CLIs on the same inputs with
  the same files out;
* ``interfaces/pao.py``: ``parse_pao``, ``phi_f``, ``angular_f``,
  ``xyz_to_spherical`` and ``find_pao_file`` element-exact;
  ``data/neighborlist.py`` ``radii_for_z`` equal;
* ``tools/wfn_export.py``: the slot table, the wavefunction export and the
  cube file of both CLIs byte for byte, on the exact-PAO path and on the
  Gaussian fallback;
* ``physics/matrix_operations.py``: the expansion matrix exact for each basis,
  ``TensorExpansion`` / ``OverlapExpand`` at float32 rounding, ``TensorMerge``
  with the JAX weights carried across (both weight modes) at atol 5e-5 /
  rtol 1e-4;
* ``utils/triplets.py``: all seven arrays equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict
from test_openmx_interface import write_synthetic_scfout
from util_fixtures import add_random_hamiltonian_targets, make_crystal

from hamgnn_tpu.data import neighborlist as j_nl
from hamgnn_tpu.interfaces import pao as j_pao
from hamgnn_tpu.models.basis import get_basis_set as j_basis
from hamgnn_tpu.physics import matrix_operations as j_mo
from hamgnn_tpu.tools import band_cal_parallel as j_bcp
from hamgnn_tpu.tools import magnetism as j_mag
from hamgnn_tpu.tools import wfn_export as j_wfn
from hamgnn_tpu.utils import triplets as j_tri
from hamgnn_tpu_torch.data import neighborlist as t_nl
from hamgnn_tpu_torch.data.dataset import load_graph_npz, save_graph_npz
from hamgnn_tpu_torch.interfaces import pao as t_pao
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.models.basis import get_basis_set as t_basis
from hamgnn_tpu_torch.physics import matrix_operations as t_mo
from hamgnn_tpu_torch.tools import band_cal_parallel as t_bcp
from hamgnn_tpu_torch.tools import magnetism as t_mag
from hamgnn_tpu_torch.tools import wfn_export as t_wfn
from hamgnn_tpu_torch.tools.poscar2openmx import write_openmx_dat
from hamgnn_tpu_torch.utils import triplets as t_tri

TOL = dict(atol=5e-5, rtol=1e-4)


def _write_yaml(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _crystal(seed, n_atoms=3):
    rng = np.random.default_rng(seed)
    return add_random_hamiltonian_targets(rng, make_crystal(rng, n_atoms=n_atoms),
                                          nao_max=14)


# ---------------------------------------------------------------------------
# band_cal_parallel
# ---------------------------------------------------------------------------

def _pencils(seed, nk=7, n=12):
    rng = np.random.default_rng(seed)
    HK = rng.normal(size=(nk, n, n)) + 1j * rng.normal(size=(nk, n, n))
    HK = 0.5 * (HK + np.conj(np.transpose(HK, (0, 2, 1))))
    S0 = 0.1 * (rng.normal(size=(nk, n, n)) + 1j * rng.normal(size=(nk, n, n)))
    SK = np.eye(n) + 0.5 * (S0 + np.conj(np.transpose(S0, (0, 2, 1))))
    return HK, SK


def test_solve_bands_batched_matches_jax_and_scipy():
    import scipy.linalg

    HK, SK = _pencils(4)
    got = t_bcp.solve_bands_batched(HK, SK, k_batch=3, device="cpu")
    want_jax = j_bcp.solve_bands_batched(HK, SK, k_batch=3)
    want = np.stack([scipy.linalg.eigh(HK[k], SK[k], eigvals_only=True)
                     for k in range(len(HK))])
    assert got.shape == want.shape == (7, 12) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_jax, **TOL)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_solve_bands_batched_refuses_a_mesh():
    """The port splits the k batch over a torch.distributed process group
    (tests/test_torch_port_parallel.py); anything else in its place raises."""
    HK, SK = _pencils(5, nk=2, n=4)
    with pytest.raises(TypeError, match="process group"):
        t_bcp.solve_bands_batched(HK, SK, group=object(), device="cpu")


def test_band_cal_parallel_cli_matches_jax(tmp_path):
    crystals = [_crystal(3), _crystal(6, n_atoms=2)]
    save_graph_npz(str(tmp_path / "graph_data.npz"), crystals)
    rows = np.concatenate([np.concatenate([c["Hon"], c["Hoff"]]) for c in crystals])
    np.save(tmp_path / "ham.npy", 1.01 * rows)
    bands = {}
    for tag, main, extra in (("jax", j_bcp.main, []), ("port", t_bcp.main, ["--device", "cpu"])):
        cfg = {"nao_max": 14, "graph_data_path": str(tmp_path / "graph_data.npz"),
               "hamiltonian_path": str(tmp_path / "ham.npy"), "nk": 9, "k_batch": 4,
               "save_dir": str(tmp_path / tag),
               "k_path": [[0, 0, 0], [0.5, 0, 0], [0.5, 0.5, 0]]}
        main(["--config", _write_yaml(tmp_path / f"{tag}.yaml", cfg), *extra])
        bands[tag] = [np.load(tmp_path / tag / f"bands_{i}.npz") for i in range(2)]
    for j, t in zip(bands["jax"], bands["port"]):
        np.testing.assert_array_equal(t["k_dist"], j["k_dist"])
        np.testing.assert_array_equal(t["k_node"], j["k_node"])
        # eV: the complex64 solve's rounding times 27.2
        np.testing.assert_allclose(t["bands"], j["bands"], atol=27.3 * TOL["atol"],
                                   rtol=TOL["rtol"])


# ---------------------------------------------------------------------------
# magnetism
# ---------------------------------------------------------------------------

POSCAR = """Fe2 O1
1.0
3.1 0.0 0.0
0.1 3.2 0.0
0.0 0.2 3.3
Fe O
2 1
Direct
0.0 0.0 0.0
0.5 0.5 0.5
0.25 0.5 0.75
"""


def test_spin_utilities_match_jax(tmp_path):
    for spin in ([0.0, 0.0, 0.0], [0.3, -0.4, 1.2], [-1.0, 0.0, 0.0], [0.0, 0.0, -2.0]):
        assert t_mag.spin_to_spherical(np.asarray(spin)) == \
            j_mag.spin_to_spherical(np.asarray(spin))
    for mode in ("fm", "afm", "random"):
        np.testing.assert_array_equal(
            t_mag.generate_spin_vectors(5, mode, axis=(1, 1, 0), magnitude=2.0, seed=3),
            j_mag.generate_spin_vectors(5, mode, axis=(1, 1, 0), magnitude=2.0, seed=3))
    with pytest.raises(ValueError):
        t_mag.generate_spin_vectors(2, "nope")


def test_decks_and_xsf_match_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(0)
    cell = np.eye(3) * 3.1 + 0.1 * rng.normal(size=(3, 3))
    syms = ["Fe", "Fe", "O"]
    pos = rng.uniform(size=(3, 3)) @ cell
    spins = rng.normal(size=(3, 3))
    species = {"Fe": {"spin": [9.0, 7.0]}}
    atoms = {3: [3.5, 2.5]}
    for tag, mod in (("jax", j_mag), ("port", t_mag)):
        mod.write_collinear_dat(cell, syms, pos, "# head\n", str(tmp_path / f"{tag}_c.dat"),
                                species, atoms)
        mod.write_noncollinear_dat(cell, syms, pos, spins, "# head\n",
                                   str(tmp_path / f"{tag}_n.dat"), species, atoms)
        mod.write_xsf(cell, syms, pos, spins, str(tmp_path / f"{tag}.xsf"))
    for name in ("_c.dat", "_n.dat", ".xsf"):
        assert (tmp_path / f"port{name}").read_bytes() == (tmp_path / f"jax{name}").read_bytes()
    j, t = j_mag.read_xsf_spin(str(tmp_path / "jax.xsf")), \
        t_mag.read_xsf_spin(str(tmp_path / "jax.xsf"))
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1] == j[1]
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_array_equal(t[3], j[3])


def _scfout_dir(root, rng, spinp):
    os.makedirs(root, exist_ok=True)
    write_synthetic_scfout(os.path.join(root, "openmx.scfout"), rng, spinp=spinp, norb=5)
    cell = np.eye(3) * 4.0
    write_openmx_dat(cell, ["H", "H"], np.array([[0, 0, 0], [1.0, 1.0, 1.0]]), "",
                     os.path.join(root, "openmx.dat"))


def test_packers_match_jax(tmp_path):
    from hamgnn_tpu.interfaces.openmx import parse_scfout as j_parse
    from hamgnn_tpu_torch.interfaces.openmx import parse_scfout as t_parse

    rng = np.random.default_rng(0)
    spins = j_mag.generate_spin_vectors(2, "afm")
    for spinp, packer in ((1, "pack_collinear_graph"), (3, "pack_noncollinear_graph")):
        path = str(tmp_path / f"s{spinp}.scfout")
        write_synthetic_scfout(path, rng, spinp=spinp, norb=5)
        j = getattr(j_mag, packer)(j_parse(path), [1, 1], 14, scf0=j_parse(path),
                                   spin_vectors=spins)
        t = getattr(t_mag, packer)(t_parse(path), [1, 1], 14, scf0=t_parse(path),
                                   spin_vectors=spins)
        assert set(t) == set(j), packer
        for k in j:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]), err_msg=k)


def test_magnetism_cli_workflows_match_jax(tmp_path):
    (tmp_path / "POSCAR_a").write_text(POSCAR)
    (tmp_path / "POSCAR_b").write_text(POSCAR.replace("0.25 0.5 0.75", "0.3 0.6 0.7"))
    rng = np.random.default_rng(1)
    for i in range(2):
        _scfout_dir(str(tmp_path / "calc" / f"s{i}"), rng, spinp=1)
    for tag, main in (("jax", j_mag.main), ("port", t_mag.main)):
        out = str(tmp_path / tag)
        base = {"outputs": {"directory": out},
                "species": {"overrides": {"Fe": {"spin": [8.0, 6.0]}}},
                "atom_spins": {2: [7.0, 7.0]}}
        steps = [
            ("convert-collinear", {"inputs": {"patterns": [str(tmp_path / "POSCAR_*")]},
                                   "convert_collinear": {"template": "# t\n"}}),
            ("make-xsf-spin", {"inputs": {"patterns": [str(tmp_path / "POSCAR_*")]},
                               "make_xsf_spin": {"mode": "afm", "axis": [0, 1, 1]}}),
            ("convert-noncollinear", {"inputs": {"patterns": [out + "/spin_*.xsf"]},
                                      "convert_noncollinear": {"template": "# n\n"}}),
            ("pack-graph-data", {"inputs": {"patterns": [str(tmp_path / "calc" / "s*")]},
                                 "pack_graph_data": {"nao_max": 14, "collinear": True}}),
        ]
        for workflow, cfg in steps:
            main([workflow, "--config",
                  _write_yaml(tmp_path / f"{tag}_{workflow}.yaml", {**base, **cfg})])
    jax_files, port_files = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert sorted(port_files) == sorted(jax_files)
    assert len(jax_files) == 7  # 2 collinear decks, 2 XSF, 2 NC decks, 1 npz
    for name, data in jax_files.items():
        if name.endswith(".npz"):
            j = load_graph_npz(str(tmp_path / "jax" / name))
            t = load_graph_npz(str(tmp_path / "port" / name))
            assert len(t) == len(j) == 2
            for tc, jc in zip(t, j):
                assert set(tc) == set(jc)
                for k in jc:
                    np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
        else:
            assert port_files[name] == data, name


# ---------------------------------------------------------------------------
# PAO, radii, wavefunction export
# ---------------------------------------------------------------------------

def _write_pao(path, lmax=2, mul=3, mesh=32):
    """A synthetic .pao in the format wfn2cube's own test writes."""
    with open(path, "w") as f:
        f.write(f"PAO.Lmax  {lmax}\nPAO.Mul   {mul}\n")
        f.write(f"grid.num.output  {mesh}\n")
        for L in range(lmax + 1):
            f.write(f"<pseudo.atomic.orbitals.L={L}\n")
            for i in range(mesh):
                rv = 0.25 * (i + 1)
                vals = "  ".join(f"{np.exp(-rv / (1.0 + 0.5 * m + L)):.10f}"
                                 for m in range(mul))
                f.write(f"{rv * 1.8897:.6f}  {rv:.6f}  {vals}\n")
            f.write(f"pseudo.atomic.orbitals.L={L}>\n")


def test_pao_functions_match_jax(tmp_path):
    os.makedirs(tmp_path / "PAO")
    p = str(tmp_path / "PAO" / "Si7.0.pao")
    _write_pao(p)
    j, t = j_pao.parse_pao(p), t_pao.parse_pao(p)
    assert (t.name, t.lmax, t.mul, t.cutoff) == (j.name, j.lmax, j.mul, j.cutoff)
    np.testing.assert_array_equal(t.rv, j.rv)
    assert set(t.rwf) == set(j.rwf)
    for l in j.rwf:
        np.testing.assert_array_equal(t.rwf[l], j.rwf[l])
    rng = np.random.default_rng(0)
    r = np.concatenate([rng.uniform(0, 10, 200), [0.01, 0.1, j.rv[0], j.rv[-1], 20.0]])
    for l in range(3):
        np.testing.assert_array_equal(t_pao.phi_f(r, t.rwf[l][1], t.rv),
                                      j_pao.phi_f(r, j.rwf[l][1], j.rv))
    d = rng.normal(size=(50, 3))
    for a, b in zip(t_pao.xyz_to_spherical(d), j_pao.xyz_to_spherical(d)):
        np.testing.assert_array_equal(a, b)
    _, theta, phi = j_pao.xyz_to_spherical(d)
    for l in range(4):
        for m in range(2 * l + 1):
            np.testing.assert_array_equal(t_pao.angular_f(l, m, theta, phi),
                                          j_pao.angular_f(l, m, theta, phi))
    with pytest.raises(NotImplementedError):
        t_pao.angular_f(4, 0, theta, phi)
    assert t_pao.find_pao_file(str(tmp_path), "Si7.0-s2p2d1") == \
        j_pao.find_pao_file(str(tmp_path), "Si7.0-s2p2d1") == p
    assert t_pao.find_pao_file(str(tmp_path), "C6.0-s2p2") is None
    bad = tmp_path / "bad.pao"
    bad.write_text("PAO.Lmax 1\n")
    with pytest.raises(ValueError):
        t_pao.parse_pao(str(bad))


@pytest.mark.parametrize("radius_type", ["openmx", "abacus"])
def test_radii_for_z_match_jax(radius_type):
    z = np.array([1, 6, 8, 14, 26, 79, 83])
    np.testing.assert_array_equal(t_nl.radii_for_z(z, radius_type, 1.3),
                                  j_nl.radii_for_z(z, radius_type, 1.3))
    with pytest.raises(KeyError):
        t_nl.radii_for_z(np.array([0]), radius_type)


@pytest.mark.parametrize("path", ["pao", "gaussian"])
def test_wfn_export_cube_matches_jax(tmp_path, path):
    """The exact-PAO cube byte for byte.  The Gaussian fallback's angular
    part is a float32 spherical harmonic on both sides, evaluated by two
    implementations a rounding apart, so there the header is byte for byte
    and the densities (printed to 6 digits) agree to 1e-5 relative."""
    c = _crystal(3)
    save_graph_npz(str(tmp_path / "graph_data.npz"), [c])
    basis = j_basis("openmx", 14)
    n_orb = sum(len(basis.basis_def[int(z)]) for z in c["z"])
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(3, n_orb)) + 1j * rng.normal(size=(3, n_orb))
    np.save(tmp_path / "vecs.npy", vecs)
    cfg = {"graph_data_path": str(tmp_path / "graph_data.npz"),
           "eigen_vecs_path": str(tmp_path / "vecs.npy"), "nao_max": 14,
           "band_index": 2, "grid": [6, 5, 7]}
    if path == "pao":
        os.makedirs(tmp_path / "DFT" / "PAO")
        for name in ("Si7.0", "C6.0"):
            _write_pao(str(tmp_path / "DFT" / "PAO" / f"{name}.pao"))
        cfg.update(dft_data_path=str(tmp_path / "DFT"),
                   basis_names={6: "C6.0-s2p2d1", 14: "Si7.0-s2p2d1"})
    for tag, main in (("jax", j_wfn.main), ("port", t_wfn.main)):
        main(["--config", _write_yaml(tmp_path / f"{tag}.yaml",
                                      {**cfg, "save_dir": str(tmp_path / tag)})])
    got = (tmp_path / "port" / "band_2.cube").read_text().splitlines()
    want = (tmp_path / "jax" / "band_2.cube").read_text().splitlines()
    head = 6 + len(c["z"])
    assert ("exact-PAO" in got[1]) == (path == "pao")
    assert got[:head] == want[:head]
    if path == "pao":
        assert got == want
    else:
        values = [np.array(" ".join(lines[head:]).split(), float) for lines in (got, want)]
        assert values[0].size == 6 * 5 * 7
        np.testing.assert_allclose(values[0], values[1], rtol=1e-5, atol=0)
    assert t_wfn._slot_table(t_basis("openmx", 19)) == j_wfn._slot_table(j_basis("openmx", 19))


def test_density_on_grid_mixed_paths_match_jax(tmp_path):
    """One species exact, one on the Gaussian fallback, through
    ``density_on_grid`` directly: the same density up to the fallback's
    float32 harmonics."""
    _write_pao(str(tmp_path / "C6.0.pao"))
    c = _crystal(3)
    basis_j, basis_t = j_basis("openmx", 14), t_basis("openmx", 14)
    n_orb = sum(len(basis_j.basis_def[int(z)]) for z in c["z"])
    coeffs = np.random.default_rng(0).normal(size=n_orb)
    got = t_wfn.density_on_grid(c, coeffs, basis_t, 14, (5, 4, 6),
                                pao_by_z={6: t_pao.parse_pao(str(tmp_path / "C6.0.pao"))})
    want = j_wfn.density_on_grid(c, coeffs, basis_j, 14, (5, 4, 6),
                                 pao_by_z={6: j_pao.parse_pao(str(tmp_path / "C6.0.pao"))})
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7 * np.abs(want).max())


def test_export_wavefunctions_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "band.npz", wavefunction=rng.normal(size=(4, 5, 5)))
    np.savez(tmp_path / "bands_only.npz", bands=rng.normal(size=(4, 5)))
    for name in ("band", "bands_only"):
        j_wfn.export_wavefunctions(str(tmp_path / f"{name}.npz"), str(tmp_path / f"j_{name}"))
        t_wfn.export_wavefunctions(str(tmp_path / f"{name}.npz"), str(tmp_path / f"t_{name}"))
        assert (tmp_path / f"t_{name}" / "wavefunctions.npy").read_bytes() == \
            (tmp_path / f"j_{name}" / "wavefunctions.npy").read_bytes()


# ---------------------------------------------------------------------------
# matrix_operations, triplets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ham_type,nao", [("openmx", 14), ("openmx", 19), ("abacus", 13),
                                          ("siesta", 13)])
def test_tensor_expansion_matches_jax(ham_type, nao):
    M_j, ir_j = j_mo._expansion_spec(ham_type, nao)
    M_t, ir_t = t_mo._expansion_spec(ham_type, nao)
    np.testing.assert_array_equal(M_t, M_j)
    assert repr(ir_t) == repr(ir_j)
    rng = np.random.default_rng(0)
    blocks = rng.normal(size=(5, nao, nao)).astype(np.float32)
    exp = t_mo.TensorExpansion(ham_type, nao)
    np.testing.assert_allclose(exp(torch.as_tensor(blocks)).numpy(),
                               np.asarray(j_mo.TensorExpansion(ham_type, nao)(
                                   jnp.asarray(blocks))), **TOL)
    data = {"Son": torch.as_tensor(blocks[:2].reshape(2, -1)),
            "Soff": torch.as_tensor(blocks[2:].reshape(3, -1))}
    out = t_mo.OverlapExpand(ham_type, nao)(data)
    jout = j_mo.OverlapExpand(ham_type, nao)({k: jnp.asarray(v.numpy())
                                               for k, v in data.items()})
    for k in ("Son_expand", "Soff_expand"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), **TOL)


@pytest.mark.parametrize("internal_weights", [False, True])
def test_tensor_merge_matches_jax(internal_weights):
    irreps = ("3x0e+2x1o+2x2e+1x1e", "2x0e+1x1o+1x2e", "1x0e+2x1o")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 3 + 6 + 10 + 3)).astype(np.float32)
    jm = j_mo.TensorMerge(*irreps, internal_weights=internal_weights)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = t_mo.TensorMerge(*irreps, internal_weights=internal_weights)
    load_flax_params(tm, {"/".join(k): np.asarray(v)
                          for k, v in flatten_dict(params["params"]).items()})
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (4, (2 + 3 + 5) * (1 + 6))
    np.testing.assert_allclose(got, want, **TOL)
    assert t_mo.TensorMerge.expansion_path(*[t_mo.Irreps(i) for i in irreps]) == \
        j_mo.TensorMerge.expansion_path(*[j_mo.Irreps(i) for i in irreps])


def test_triplets_match_jax():
    c = _crystal(7, n_atoms=5)
    counts = []
    for ei, shift in ((c["edge_index"], c["cell_shift"]),
                      (np.zeros((2, 0), np.int64), np.zeros((0, 3), np.int64))):
        got = t_tri.triplets(ei, len(c["z"]), shift)
        want = j_tri.triplets(ei, len(c["z"]), shift)
        assert len(got) == len(want) == 7
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        counts.append(len(got[2]))
    assert counts[0] > 0 and counts[1] == 0
