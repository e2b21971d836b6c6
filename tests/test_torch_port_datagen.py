"""The port's data-preparation layer against ``hamgnn_tpu`` on the CPU.

The SK teacher, the OpenMX / SIESTA / ABACUS readers and writers, the three
``graph_data_gen`` tools, ``poscar2*`` and the native readers of
``hamgnn_tpu_torch`` are held against the JAX package on inputs made from
numpy seeds:

* writers: the same arrays give byte-identical files;
* readers and packers: on the same files (written by the JAX package's
  writers) every array is element-exact, with the same keys and dtypes;
* the teacher: its seeded draws, geometry and edges are exact; its H, S and H0
  blocks agree within ``BLOCK_TOL`` * max|block| (the JAX teacher evaluates
  its spherical harmonics in float32, the port's in float64; the gap each
  block key shows is printed under ``-s``); its equivariance holds to 1e-10;
* the spin sets: integer arrays exact, floats within ``BLOCK_TOL`` (the JAX
  teacher's Heisenberg terms are float32 too);
* the native readers (built with g++ into ``build/native``) are bit-identical
  to the Python parsers, and so are the ``graph_data.npz`` files packed
  through them.

The end-to-end chain (teacher -> ``graph_data_gen`` -> ``cli`` fit -> test ->
``band_cal``) runs at a narrow width on the CPU.  One torch thread: the
tensors are tiny.
"""

import gzip
import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch
import yaml

from hamgnn_tpu.interfaces import abacus as j_abacus
from hamgnn_tpu.interfaces import openmx as j_openmx
from hamgnn_tpu.interfaces import openmx_tables as j_tables
from hamgnn_tpu.interfaces import scfout_writer as j_writer
from hamgnn_tpu.interfaces import siesta as j_siesta
from hamgnn_tpu.tools import graph_data_gen as j_gdg
from hamgnn_tpu.tools import graph_data_gen_abacus as j_gdg_abacus
from hamgnn_tpu.tools import graph_data_gen_siesta as j_gdg_siesta
from hamgnn_tpu.tools import poscar2abacus as j_p2a
from hamgnn_tpu.tools import poscar2openmx as j_p2o
from hamgnn_tpu.tools import sk_dataset as j_sk
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.data.dataset import load_graph_npz
from hamgnn_tpu_torch.e3.wigner import wigner_D
from hamgnn_tpu_torch.interfaces import abacus as t_abacus
from hamgnn_tpu_torch.interfaces import native as t_native
from hamgnn_tpu_torch.interfaces import openmx as t_openmx
from hamgnn_tpu_torch.interfaces import openmx_tables as t_tables
from hamgnn_tpu_torch.interfaces import scfout_writer as t_writer
from hamgnn_tpu_torch.interfaces import siesta as t_siesta
from hamgnn_tpu_torch.tools import band_cal as t_band_cal
from hamgnn_tpu_torch.tools import graph_data_gen as t_gdg
from hamgnn_tpu_torch.tools import graph_data_gen_abacus as t_gdg_abacus
from hamgnn_tpu_torch.tools import graph_data_gen_siesta as t_gdg_siesta
from hamgnn_tpu_torch.tools import poscar2abacus as t_p2a
from hamgnn_tpu_torch.tools import poscar2openmx as t_p2o
from hamgnn_tpu_torch.tools import sk_dataset as t_sk

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
# |port - JAX| <= BLOCK_TOL * max|JAX| for the teacher's blocks: the JAX
# teacher's spherical harmonics and Heisenberg terms are float32
BLOCK_TOL = 1e-6
EQUIV_TOL = 1e-10
NATIVE_SKIP = "g++ is absent: the native readers cannot be built"
# set -> (sk_dataset flags, the graph_data_gen tool that packs it)
FORMATS = {
    "openmx": ([], "openmx"),
    "soc": (["--soc"], "openmx"),
    "siesta": (["--format", "siesta", "--nao-max", "19"], "siesta"),
    "abacus": (["--format", "abacus", "--nao-max", "27"], "abacus"),
}
GDG = {"openmx": (j_gdg, t_gdg), "siesta": (j_gdg_siesta, t_gdg_siesta),
       "abacus": (j_gdg_abacus, t_gdg_abacus)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gdg_config(fmt, soc, data_dir, out_dir, nao, runs="struct_*"):
    if fmt == "openmx":
        return {"nao_max": nao, "graph_data_save_path": str(out_dir),
                "scfout_paths": str(data_dir / runs), "dat_file_name": "openmx.dat",
                "scfout_file_name": "openmx.scfout", "soc_switch": soc,
                "doping_charge": 0.0}
    if fmt == "siesta":
        return {"nao_max": nao, "graph_data_save_path": str(out_dir),
                "calc_paths": str(data_dir / "struct_*"), "fdf_file_name": "input.fdf",
                "hsx_file_name": "siesta.HSX", "h0_hsx_file_name": "H0.HSX"}
    return {"nao_max": nao, "graph_data_save_path": str(out_dir),
            "calc_paths": str(data_dir / "struct_*"), "stru_file_name": "STRU",
            "hr_file_name": "data-HR-sparse_SPIN0.csr",
            "sr_file_name": "data-SR-sparse_SPIN0.csr",
            "h0_file_name": "data-H0R-sparse_SPIN0.csr", "soc_switch": soc}


NAO = {"openmx": 14, "soc": 14, "siesta": 19, "abacus": 27}


def run_gdg(mod, fmt, soc, data_dir, out_dir, nao, native=False, runs="struct_*"):
    """Run a graph_data_gen tool (``mod.main``) on the ``runs`` directories of
    ``data_dir``; returns the crystals of the graph_data.npz it wrote."""
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = out_dir / "gdg.yaml"
    cfg.write_text(yaml.safe_dump(_gdg_config(fmt, soc, data_dir, out_dir, nao, runs)))
    mod.main(["--config", str(cfg)] + (["--native"] if native else []))
    return load_graph_npz(str(out_dir / "graph_data.npz"))


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """One tiny SK set (1 Si, 1 C, 1 SiC) per format, made by each package's
    ``sk_dataset`` (openmx with ``--band-set``): {fmt: (jax dir, port dir)}."""
    root = tmp_path_factory.mktemp("sets")
    out = {}
    for fmt, (flags, _tool) in FORMATS.items():
        dirs = []
        for pkg, mod in (("jax", j_sk), ("port", t_sk)):
            d = root / pkg / fmt
            argv = ["--out", str(d), "--n-si", "1", "--n-c", "1", "--n-sic", "1"] + flags
            if fmt == "openmx":
                argv.append("--band-set")
            mod.main(argv)
            dirs.append(d)
        out[fmt] = tuple(dirs)
    return out


def assert_crystals_equal(a, b, bits=False):
    """Same number of crystals, keys, dtypes and shapes, and equal values
    (``bits``: equal bytes)."""
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert sorted(ca) == sorted(cb)
        for k in ca:
            x, y = np.asarray(ca[k]), np.asarray(cb[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            if bits:
                assert x.tobytes() == y.tobytes(), k
            else:
                np.testing.assert_array_equal(x, y, err_msg=k)


def assert_crystals_close(a, b):
    """Integer arrays exact; floats within BLOCK_TOL * max|ref| per key."""
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert sorted(ca) == sorted(cb)
        for k in ca:
            x, y = np.asarray(ca[k]), np.asarray(cb[k])
            assert x.shape == y.shape, k
            if np.issubdtype(x.dtype, np.integer):
                np.testing.assert_array_equal(x, y, err_msg=k)
            else:
                scale = max(float(np.abs(x).max(initial=0.0)), 1e-30)
                assert float(np.abs(x - y).max(initial=0.0)) <= BLOCK_TOL * scale, k


def assert_scfout_equal(a, b):
    for f in ("atomnum", "spinp_switch", "chemp", "valence_electrons"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("cell", "pos", "num_orbs", "edge_src", "edge_dst", "cell_shift", "nbr_shift"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    for f in ("Hon", "Hoff", "iHon", "iHoff", "Son", "Soff", "Lon", "Loff", "dSon", "dSoff"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is None:
            continue
        flat = lambda v: [np.asarray(b) for b in (  # noqa: E731
            v if f not in ("Hon", "Hoff", "iHon", "iHoff") else [m for s in v for m in s])]
        xs, ys = flat(x), flat(y)
        assert len(xs) == len(ys), f
        for p, q in zip(xs, ys):
            assert p.shape == q.shape and p.tobytes() == q.tobytes(), f


# ----------------------------------------------------------------------
# tables and writers
# ----------------------------------------------------------------------

def test_openmx_tables_equal_the_jax_copy():
    assert t_tables.spin_set == j_tables.spin_set
    assert t_tables.PAO_dict == j_tables.PAO_dict
    assert t_tables.PBE_dict == j_tables.PBE_dict


def _sic_blocks(seed=0, nao=14, ham_type="openmx"):
    teacher = t_sk.SKTeacher(ham_type=ham_type, nao_max=nao, seed=seed)
    cell, pos, z = t_sk.rattled(np.random.RandomState(seed),
                                t_sk._fcc_primitive(t_sk.A_SIC, 14, 6))
    return teacher, z, pos, cell, teacher.build(z, pos, cell)


@pytest.mark.parametrize("nspin", [1, 2, 4])
@pytest.mark.parametrize("ext", [True, False])
def test_write_scfout_bytes_equal_the_jax_writer(tmp_path, nspin, ext):
    """SpinP_switch 0, 1 and 3, with and without the D_OLP / OLP_L blocks."""
    _teacher, z, pos, cell, d = _sic_blocks()
    rng = np.random.default_rng(nspin)
    spin = lambda blocks: [[b * rng.uniform(0.5, 1.5) for b in blocks]  # noqa: E731
                           for _ in range(nspin)]
    kw = dict(cell=cell, pos=pos, num_orbs=d["num_orbs"], edge_src=d["edge_src"],
              edge_dst=d["edge_dst"], cell_shift=d["cell_shift"], Hon=spin(d["Hon"]),
              Hoff=spin(d["Hoff"]), Son=d["Son"], Soff=d["Soff"], chemp=-0.17,
              valence_electrons=8.0)
    if nspin == 4:
        kw.update(iHon=spin(d["Hon"])[:3], iHoff=spin(d["Hoff"])[:3])
    if ext:
        vec3 = lambda blocks: [rng.normal(size=b.shape + (3,)) for b in blocks]  # noqa: E731
        kw.update(Lon=vec3(d["Son"]), Loff=vec3(d["Soff"]), dSon=vec3(d["Son"]),
                  dSoff=vec3(d["Soff"]))
    j_writer.write_scfout(str(tmp_path / "j.scfout"), **kw)
    t_writer.write_scfout(str(tmp_path / "t.scfout"), **kw)
    assert (tmp_path / "j.scfout").read_bytes() == (tmp_path / "t.scfout").read_bytes()
    # and the port parses back what it wrote
    scf = t_openmx.parse_scfout(str(tmp_path / "t.scfout"))
    assert scf.spinp_switch == {1: 0, 2: 1, 4: 3}[nspin]
    np.testing.assert_array_equal(scf.Hoff[nspin - 1][3], kw["Hoff"][nspin - 1][3])


def test_write_hsx_fdf_stru_csr_bytes_equal_the_jax_writers(tmp_path):
    for ham_type, nao in (("siesta", 19), ("abacus", 27)):
        _teacher, z, pos, cell, d = _sic_blocks(1, nao, ham_type)
        common = dict(z=z, pos=pos, cell=cell, num_orbs=d["num_orbs"], edge_src=d["edge_src"],
                      edge_dst=d["edge_dst"], cell_shift=d["cell_shift"])
        for pkg, siesta, abacus in (("j", j_siesta, j_abacus), ("t", t_siesta, t_abacus)):
            out = tmp_path / ham_type / pkg
            out.mkdir(parents=True)
            if ham_type == "siesta":
                siesta.write_hsx(str(out / "siesta.HSX"), Hon=d["Hon"], Hoff=d["Hoff"],
                                 Son=d["Son"], Soff=d["Soff"], **common)
                siesta.write_fdf(str(out / "input.fdf"), z=z, pos=pos, cell=cell)
            else:
                abacus.write_stru(str(out / "STRU"), z=z, pos=pos, cell=cell)
                abacus.write_abacus_csr(str(out), H0on=d["H0on"], H0off=d["H0off"],
                                        Hon=d["Hon"], Hoff=d["Hoff"], Son=d["Son"],
                                        Soff=d["Soff"], **{k: v for k, v in common.items()
                                                            if k not in ("pos", "cell")})
        names = sorted(os.listdir(tmp_path / ham_type / "j"))
        assert names == sorted(os.listdir(tmp_path / ham_type / "t"))
        assert len(names) == (2 if ham_type == "siesta" else 4)
        for name in names:
            assert ((tmp_path / ham_type / "j" / name).read_bytes()
                    == (tmp_path / ham_type / "t" / name).read_bytes()), name


POSCAR = """SiC
1.0
  0.0 2.18 2.18
  2.18 0.0 2.18
  2.18 2.18 0.0
Si C
1 1
Direct
  0.0 0.0 0.0
  0.25 0.25 0.26
"""


@pytest.mark.parametrize("tool", ["poscar2openmx", "poscar2abacus", "poscar2siesta"])
def test_poscar_tools_write_the_jax_files(tmp_path, tool):
    (tmp_path / "POSCAR_1").write_text(POSCAR)
    for pkg, p2o, p2a in (("j", j_p2o, j_p2a), ("t", t_p2o, t_p2a)):
        cfg = {"system_name": "sic", "poscar_path": str(tmp_path / "POSCAR_*"),
               "filepath": str(tmp_path / pkg), "basic_command": "System.Name sic\n",
               "orb_dict": {"Si": "Si_gga_8au_100Ry_2s2p1d.orb"}, "template": "# head\n"}
        path = tmp_path / f"{pkg}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        if tool == "poscar2openmx":
            p2o.main(["--config", str(path)])
        elif tool == "poscar2abacus":
            p2a.main(["--config", str(path)])
        else:
            p2a.main_siesta(["--config", str(path)])
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 1
    assert (tmp_path / "j" / names[0]).read_bytes() == (tmp_path / "t" / names[0]).read_bytes()
    # write_openmx_dat directly, on the POSCAR reader's output
    cell, syms, pos = t_p2o.read_poscar(str(tmp_path / "POSCAR_1"))
    for w, name in ((j_p2o.write_openmx_dat, "j.dat"), (t_p2o.write_openmx_dat, "t.dat")):
        w(cell, syms, pos, "# deck\n", str(tmp_path / name))
    assert (tmp_path / "j.dat").read_bytes() == (tmp_path / "t.dat").read_bytes()


# ----------------------------------------------------------------------
# the teacher
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def teachers():
    return j_sk.SKTeacher(seed=3), t_sk.SKTeacher(seed=3)


def test_teacher_draws_equal_the_jax_teacher(teachers):
    tj, tp = teachers
    np.testing.assert_array_equal(tj.M, tp.M)
    assert tj.paths == tp.paths
    for name in ("h0", "dh", "s"):
        a, b = getattr(tj, name), getattr(tp, name)
        for k in ("A", "rho", "kappa"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=f"{name}.{k}")
        for z in (14, 6):
            np.testing.assert_array_equal(a.omega[z], b.omega[z])
            np.testing.assert_array_equal(a.species[z], b.species[z])
    sj, sp = j_sk.SOCTerms(tj.basis, seed=3), t_sk.SOCTerms(tp.basis, seed=3)
    np.testing.assert_array_equal(sj.L, sp.L)
    for z in (14, 6):
        np.testing.assert_array_equal(sj.ksi[z], sp.ksi[z])


@pytest.mark.parametrize("proto", ["si", "c", "sic"])
def test_teacher_geometry_exact_and_blocks_within_float32(teachers, proto):
    tj, tp = teachers
    a = {"si": (t_sk.A_SI, 14, 14), "c": (t_sk.A_C, 6, 6), "sic": (t_sk.A_SIC, 14, 6)}[proto]
    rng_j, rng_t = np.random.RandomState(5), np.random.RandomState(5)
    cj, pj, zj = j_sk.rattled(rng_j, j_sk._fcc_primitive(*a))
    ct, pt, zt = t_sk.rattled(rng_t, t_sk._fcc_primitive(*a))
    for x, y in ((cj, ct), (pj, pt), (zj, zt)):
        assert x.tobytes() == y.tobytes()
    dj, dt = tj.build(zj, pj, cj), tp.build(zt, pt, ct)
    for k in ("edge_src", "edge_dst", "cell_shift", "num_orbs", "valence"):
        np.testing.assert_array_equal(dj[k], dt[k], err_msg=k)
    for k in ("Hon", "Hoff", "H0on", "H0off", "Son", "Soff"):
        x = np.concatenate([b.ravel() for b in dj[k]])
        y = np.concatenate([b.ravel() for b in dt[k]])
        gap = np.abs(x - y).max() / np.abs(x).max()
        print(f"{proto} {k}: max|port - jax| / max|jax| = {gap:.3g}")  # the measured gap (-s)
        assert gap <= BLOCK_TOL, k
    assert t_sk.min_overlap_eig(dt, zt) == pytest.approx(j_sk.min_overlap_eig(dj, zj),
                                                         rel=1e-6)


def test_teacher_gaunt_selection_rule(teachers):
    _tj, tp = teachers
    for prm in (tp.h0, tp.dh, tp.s):
        for p, (_i, _j, l1, l2, L, _o) in enumerate(tp.paths):
            if (l1 + l2 + L) % 2 == 1:
                assert prm.A[p] == 0.0 and prm.kappa[p] == 0.0


def _block_D(teacher, R):
    """The rotation over the DFT-ordered nao orbital slots: per-slot Wigner-D
    conjugated with the basis' index_change permutation and minus_index signs."""
    from scipy.linalg import block_diag

    basis = teacher.basis
    D_int = block_diag(*[wigner_D(ir.l, R) for _, ir in basis.orbital_irreps])
    nao = teacher.nao
    P = np.zeros((nao, nao))
    perm = basis.index_change if basis.index_change is not None else np.arange(nao)
    for p, i in enumerate(perm):
        P[p, int(i)] = 1.0
    if basis.minus_index is not None:
        s = np.ones(nao)
        s[np.asarray(basis.minus_index, int)] = -1.0
        P = np.diag(s) @ P
    return P @ D_int @ P.T


def _rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def test_teacher_is_equivariant_to_1e10(teachers):
    """Off-site and on-site blocks rotate as D H D^T, and the off-site blocks
    take the orbitals' parities under inversion, to 1e-10 (the JAX teacher,
    in float32, holds to 3e-6)."""
    _tj, tp = teachers
    rng = np.random.default_rng(0)
    q = _rotation(1)
    D = _block_D(tp, q)
    vec = rng.normal(size=(6, 3))
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    r = np.full(6, 4.2)
    zi, zj = np.array([14, 14, 6, 6, 14, 6]), np.array([14, 6, 6, 14, 14, 6])
    H1 = tp.offsite(tp.dh, vec, r, zi, zj)
    H2 = tp.offsite(tp.dh, vec @ q.T, r, zi, zj)
    np.testing.assert_allclose(H2, np.einsum("ab,ebc,dc->ead", D, H1, D), rtol=0,
                               atol=EQUIV_TOL)
    par = np.concatenate([np.full(ir.dim, (-1.0) ** ir.l)
                          for _, ir in tp.basis.orbital_irreps])
    H3 = tp.offsite(tp.dh, -vec, r, zi, zj)
    np.testing.assert_allclose(H3, par[None, :, None] * H1 * par[None, None, :], rtol=0,
                               atol=EQUIV_TOL)
    z, src = np.array([14, 6]), np.array([0, 0, 1, 1, 1])
    v5 = vec[:5] * 1.0
    O1 = tp.onsite(tp.dh, z, src, v5, np.full(5, 3.8), zj[:5])
    O2 = tp.onsite(tp.dh, z, src, v5 @ q.T, np.full(5, 3.8), zj[:5])
    np.testing.assert_allclose(O2, np.einsum("ab,ebc,dc->ead", D, O1, D), rtol=0,
                               atol=EQUIV_TOL)


@pytest.mark.parametrize("kind", ["collinear", "noncollinear", "spinsoc"])
def test_spin_sets_match_the_jax_sets(tmp_path, kind):
    """The collinear, non-collinear and spin-constrained SOC sets (3
    crystals; collinear with its band set): integer arrays exact, floats
    within BLOCK_TOL * max|ref|."""
    argv = ["--n", "3"] + (["--band-set"] if kind == "collinear" else [])
    for pkg, sk in (("j", j_sk), ("t", t_sk)):
        run = {"collinear": sk.main_collinear, "noncollinear": sk.main_noncollinear,
               "spinsoc": lambda a: sk.main_noncollinear(a, soc=True)}[kind]
        run(["--out", str(tmp_path / pkg)] + argv)
    for sub in ["", "_band"] if kind == "collinear" else [""]:
        a = load_graph_npz(str(tmp_path / f"j{sub}" / "graph_data.npz"))
        b = load_graph_npz(str(tmp_path / f"t{sub}" / "graph_data.npz"))
        assert_crystals_close(a, b)
        assert {"spin_vec", "spin_length"} <= set(b[0])


# ----------------------------------------------------------------------
# the sets of each format, their readers, packers and CLIs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fmt", list(FORMATS))
def test_sk_dataset_writes_the_jax_files(sets, fmt):
    """``sk_dataset`` for each ``--format`` and ``--soc``: the same files,
    the text ones (.dat, FDF, STRU) byte-identical; the containers' blocks
    within the float32 tolerance (checked on the packed sets below)."""
    jd, td = sets[fmt]
    dirs = sorted(os.listdir(jd))
    assert dirs == sorted(os.listdir(td)) and len(dirs) == 3
    for d in dirs:
        names = sorted(os.listdir(jd / d))
        assert names == sorted(os.listdir(td / d))
        for name in names:
            if name in ("openmx.dat", "input.fdf", "STRU"):
                assert (jd / d / name).read_bytes() == (td / d / name).read_bytes(), name
    if fmt == "openmx":
        assert sorted(os.listdir(str(td) + "_band")) == [
            "pristine_c", "pristine_si", "pristine_sic"]


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_port_sets_pack_like_the_jax_sets(tmp_path, sets, fmt):
    """Each package's set packed by the port's tool: integer arrays exact,
    floats within the teacher tolerance."""
    jd, td = sets[fmt]
    tool = FORMATS[fmt][1]
    a = run_gdg(GDG[tool][1], tool, fmt == "soc", jd, tmp_path / "j", NAO[fmt])
    b = run_gdg(GDG[tool][1], tool, fmt == "soc", td, tmp_path / "t", NAO[fmt])
    assert_crystals_close(a, b)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_graph_data_gen_clis_match_the_jax_clis(tmp_path, sets, fmt):
    """On the JAX-written files, the port's graph_data_gen* write a
    graph_data.npz equal to the JAX tools' array for array."""
    jd, _td = sets[fmt]
    tool = FORMATS[fmt][1]
    j_mod, t_mod = GDG[tool]
    a = run_gdg(j_mod, tool, fmt == "soc", jd, tmp_path / "j", NAO[fmt])
    b = run_gdg(t_mod, tool, fmt == "soc", jd, tmp_path / "t", NAO[fmt])
    assert_crystals_equal(a, b)
    assert ("iHon" in b[0]) == (fmt == "soc")
    assert "Hon0" in b[0]


@pytest.mark.parametrize("soc", [False, True])
def test_parse_scfout_and_pack_crystal_match_jax(sets, soc):
    jd, _td = sets["soc" if soc else "openmx"]
    d = jd / "struct_0002"
    pair = []
    for openmx, gdg in ((j_openmx, j_gdg), (t_openmx, t_gdg)):
        scf = openmx.parse_scfout(str(d / "openmx.scfout"))
        scf0 = openmx.parse_scfout(str(d / "overlap.scfout"))
        z, _latt, _pos = gdg.read_openmx_dat(str(d / "openmx.dat"))
        pair.append((scf, openmx.pack_crystal(scf, z=z, nao_max=14, scf0=scf0, soc=soc)))
    assert_scfout_equal(pair[0][0], pair[1][0])
    assert_crystals_equal([pair[0][1]], [pair[1][1]])
    if soc:
        assert pair[1][0].Lon is not None and "Lon" in pair[1][1]


def _hsx_with_spins(src, dst, nspin):
    """The nspin-1 ``.HSX`` at ``src`` rewritten with ``nspin`` H channels,
    channel s scaled by (1 + 0.1 s)."""
    f = t_siesta.FortranFile(str(src))
    recs = []
    while f.ofs < len(f.buf):
        recs.append(f.record())
    no_u, no_s, _nspin, nh = np.frombuffer(recs[0], "<i4")
    head = 4 + int(no_u)  # header, gamma, indxuo, numh, listh rows
    h_rows = recs[head:head + no_u]
    w = t_siesta._FortranWriter()
    w.ints([no_u, no_s, nspin, nh])
    for r in recs[1:head]:
        w.record(r)
    for s in range(nspin):
        for r in h_rows:
            w.floats(np.frombuffer(r, "<f4") * np.float32(1 + 0.1 * s))
    for r in recs[head + no_u:]:
        w.record(r)
    dst.write_bytes(w.tobytes())


@pytest.mark.parametrize("nspin", [1, 2, 4])
def test_siesta_readers_and_packer_match_jax(tmp_path, sets, nspin):
    jd, _td = sets["siesta"]
    d = jd / "struct_0002"
    hsx_path = tmp_path / "siesta.HSX"
    _hsx_with_spins(d / "siesta.HSX", hsx_path, nspin)
    out = []
    for siesta in (j_siesta, t_siesta):
        fdf = siesta.parse_fdf(str(d / "input.fdf"))
        hsx = siesta.parse_hsx(str(hsx_path))
        g = siesta.hsx_to_graph(hsx, fdf)
        out.append((fdf, hsx, g, siesta.pack_crystal_siesta(g, fdf, 19)))
    (fa, ha, ga, ca), (fb, hb, gb, cb) = out
    for f in ("z", "pos", "cell"):
        np.testing.assert_array_equal(getattr(fa, f), getattr(fb, f))
    for f in ("indxuo", "numh", "listh", "hamilt", "sover", "xij", "species_no", "isa",
              "iaorb", "zval"):
        np.testing.assert_array_equal(getattr(ha, f), getattr(hb, f), err_msg=f)
    assert hb.nspin == nspin and len(gb["Hon"]) == nspin
    for k in ("edge_src", "edge_dst", "cell_shift", "nbr_shift", "num_orbs"):
        np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)
    assert_crystals_equal([ca], [cb])


def _write_soc_csr(path, stru_dir, teacher_data):
    """An ABACUS SOC ``data-HR-sparse_SPIN0.csr`` for a teacher crystal: each
    real H(R) spread over the interleaved spins as complex entries,
    ``kron(H, M)`` with a fixed complex 2 x 2 M, written in the "(re,im)"
    text form."""
    from scipy.sparse import csr_matrix

    d = teacher_data
    no = np.asarray(d["num_orbs"])
    indo = np.concatenate([[0], np.cumsum(no[:-1])])
    no_u = int(no.sum())
    mats = {}

    def put(cs, a, b, blk):
        m = mats.setdefault(cs, np.zeros((no_u, no_u)))
        m[indo[a]:indo[a] + no[a], indo[b]:indo[b] + no[b]] += blk / t_abacus.RY2HA

    for a, blk in enumerate(d["Hon"]):
        put((0, 0, 0), a, a, blk)
    for e, blk in enumerate(d["Hoff"]):
        put(tuple(int(v) for v in d["cell_shift"][e]), int(d["edge_src"][e]),
            int(d["edge_dst"][e]), blk)
    M = np.array([[1.0 + 0.1j, 0.05 + 0.02j], [0.05 - 0.02j, 0.9 - 0.1j]])
    lines = [f"Matrix Dimension of H(R): {2 * no_u}", f"Matrix number of H(R): {len(mats)}"]
    for cs in sorted(mats):
        m = csr_matrix(np.kron(mats[cs], M))
        m.eliminate_zeros()
        lines.append(f"{cs[0]} {cs[1]} {cs[2]} {m.nnz}")
        lines.append(" ".join(f"({v.real:.17e},{v.imag:.17e})" for v in m.data))
        lines.append(" ".join(map(str, m.indices)))
        lines.append(" ".join(map(str, m.indptr)))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def abacus_soc_set(tmp_path_factory):
    """Two ABACUS SOC run directories (STRU, complex H(R), real S(R)) made
    from the port's teacher."""
    root = tmp_path_factory.mktemp("abacus_soc")
    for i, seed in enumerate((2, 3)):
        _teacher, z, pos, cell, d = _sic_blocks(seed, 27, "abacus")
        run = root / f"struct_{i:04d}"
        run.mkdir()
        t_abacus.write_stru(str(run / "STRU"), z=z, pos=pos, cell=cell)
        t_abacus.write_abacus_csr(str(run), z=z, num_orbs=d["num_orbs"],
                                  edge_src=d["edge_src"], edge_dst=d["edge_dst"],
                                  cell_shift=d["cell_shift"], Hon=d["Hon"], Hoff=d["Hoff"],
                                  Son=d["Son"], Soff=d["Soff"])
        _write_soc_csr(run / "data-HR-sparse_SPIN0.csr", run, d)
    return root


@pytest.mark.parametrize("soc", [False, True])
def test_abacus_readers_and_packer_match_jax(sets, abacus_soc_set, soc):
    d = (abacus_soc_set if soc else sets["abacus"][0]) / "struct_0001"
    out = []
    for abacus in (j_abacus, t_abacus):
        stru = abacus.parse_stru(str(d / "STRU"))
        g = abacus.build_graph_from_csr(stru, str(d / "data-HR-sparse_SPIN0.csr"),
                                        str(d / "data-SR-sparse_SPIN0.csr"), soc=soc)
        out.append((stru, g, abacus.pack_crystal_abacus(g, stru, 27, soc=soc)))
    (sa, ga, ca), (sb, gb, cb) = out
    assert sa.species == sb.species and sa.num_orbitals == sb.num_orbitals
    for f in ("cell", "positions", "z"):
        np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
    for k in ("edge_src", "edge_dst", "cell_shift", "nbr_shift"):
        np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)
    assert len(gb["Hon"]) == (4 if soc else 1)
    for k in ("Hon", "Hoff"):
        for x, y in zip(ga[k], gb[k]):
            for p, q in zip(x, y):
                np.testing.assert_array_equal(p, q, err_msg=k)
    assert_crystals_equal([ca], [cb])
    assert ("iHon" in cb) == soc
    assert t_abacus.orbital_count_from_name("C_gga_7au_100Ry_2s2p1d.orb") == 13


def test_abacus_soc_cli_matches_the_jax_cli(tmp_path, abacus_soc_set):
    cfg = {"nao_max": 27, "calc_paths": str(abacus_soc_set / "struct_*"), "soc_switch": True}
    crystals = []
    for pkg, mod in (("j", j_gdg_abacus), ("t", t_gdg_abacus)):
        path = tmp_path / f"{pkg}.yaml"
        path.write_text(yaml.safe_dump(dict(cfg, graph_data_save_path=str(tmp_path / pkg))))
        mod.main(["--config", str(path)])
        crystals.append(load_graph_npz(str(tmp_path / pkg / "graph_data.npz")))
    assert_crystals_equal(*crystals)
    assert len(crystals[1]) == 2 and "iHoff" in crystals[1][0]


def test_graph_data_gen_skip_rules_match_jax(tmp_path, sets, capsys):
    """A missing .dat, a .std at max_SCF_skip SCF steps and an unreadable
    scfout are skipped by both tools, which pack the one good directory."""
    jd, _td = sets["openmx"]
    data = tmp_path / "data"
    shutil.copytree(jd, data)
    (data / "struct_0000" / "openmx.dat").unlink()
    (data / "struct_0001" / "openmx.std").write_text("MD= 1  SCF= 250\nEnpy  = -7.5\n")
    (data / "struct_0002" / "openmx.std").write_text("MD= 1  SCF=  12\nEnpy  = -7.25\n")
    bad = data / "struct_0003"
    shutil.copytree(data / "struct_0002", bad)
    raw = (bad / "openmx.scfout").read_bytes()
    (bad / "openmx.scfout").write_bytes(raw[:len(raw) // 3])
    outs, printed = [], []
    for pkg, mod in (("j", j_gdg), ("t", t_gdg)):
        cfg = _gdg_config("openmx", False, data, tmp_path / pkg, 14)
        cfg.update(std_file_name="openmx.std", max_SCF_skip=200)
        path = tmp_path / f"{pkg}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        mod.main(["--config", str(path)])
        printed.append([line for line in capsys.readouterr().out.splitlines()
                        if line.startswith("skip ")])
        outs.append(load_graph_npz(str(tmp_path / pkg / "graph_data.npz")))
    assert_crystals_equal(*outs)
    assert len(outs[1]) == 1
    kept = t_openmx.parse_scfout(str(data / "struct_0002" / "openmx.scfout"))
    np.testing.assert_array_equal(outs[1][0]["pos"], kept.pos)
    assert printed[0] == printed[1] and len(printed[1]) == 3


# ----------------------------------------------------------------------
# golden fixtures (the reference reader's JSON on committed scfout files)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["si2", "si2_soc"])
def test_parse_scfout_matches_the_golden_fixtures(name):
    scf = t_openmx.parse_scfout(os.path.join(FIXDIR, f"{name}.scfout"))
    with gzip.open(os.path.join(FIXDIR, f"{name}.HS.json.gz"), "rt") as f:
        ref = json.load(f)
    np.testing.assert_array_equal(np.asarray(ref["edge_index"]),
                                  np.stack([scf.edge_src, scf.edge_dst]))
    np.testing.assert_allclose(np.asarray(ref["pos"]).reshape(-1, 3), scf.pos, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ref["cell_shift"]).reshape(-1, 3), scf.cell_shift)
    np.testing.assert_allclose(np.asarray(ref["nbr_shift"]).reshape(-1, 3), scf.nbr_shift,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ref["inv_edge_idx"]),
                                  t_openmx.inverse_edges(scf.edge_src, scf.edge_dst,
                                                         scf.cell_shift))
    for key, got in (("Hon", scf.Hon), ("Hoff", scf.Hoff)):
        assert len(ref[key]) == len(got)
        for rows, blocks in zip(ref[key], got):
            for row, blk in zip(rows, blocks, strict=True):
                np.testing.assert_allclose(np.asarray(row).reshape(blk.shape), blk,
                                           rtol=2e-6, atol=1e-9)
    for key, got in (("Son", scf.Son), ("Soff", scf.Soff)):
        for row, blk in zip(ref[key], got, strict=True):
            np.testing.assert_allclose(np.asarray(row).reshape(blk.shape), blk, rtol=2e-6,
                                       atol=1e-9)
    if name == "si2_soc":
        # the reference reader prints OLP_L with 7 decimals
        for key, got in (("Lon", scf.Lon), ("Loff", scf.Loff)):
            for row, blk in zip(ref[key], got, strict=True):
                np.testing.assert_allclose(np.asarray(row).reshape(blk.shape), blk, atol=6e-8)


# ----------------------------------------------------------------------
# the native readers
# ----------------------------------------------------------------------

@pytest.fixture
def gxx():
    """Skips where no C++ compiler can build the native readers."""
    if shutil.which("g++") is None and not os.environ.get("CXX"):
        pytest.skip(NATIVE_SKIP)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_native_readers_are_bit_identical_to_the_python_parsers(tmp_path, sets, fmt, gxx):
    """The reader itself (ScfoutData, HSXData, the CSR stream), then the
    graph_data.npz packed through it, bit for bit."""
    jd, _td = sets[fmt]
    d = jd / "struct_0001"
    if fmt in ("openmx", "soc"):
        for name in ("openmx.scfout", "overlap.scfout"):
            nat = t_openmx.scfout_from_native(t_openmx.parse_scfout_native(
                str(d / name), str(tmp_path / "HS.json")))
            assert_scfout_equal(t_openmx.parse_scfout(str(d / name)), nat)
        std = t_openmx.scfout_from_native(t_openmx.parse_scfout_native(
            str(d / "openmx.scfout"), str(tmp_path / "HS.json"), with_postprocess_ext=False))
        py = t_openmx.parse_scfout(str(d / "openmx.scfout"), with_postprocess_ext=False)
        np.testing.assert_array_equal(std.Hoff[0][1], py.Hoff[0][1])
    elif fmt == "siesta":
        for nspin in (1, 4):
            path = tmp_path / f"s{nspin}.HSX"
            _hsx_with_spins(d / "siesta.HSX", path, nspin)
            py, nat = t_siesta.parse_hsx(str(path)), t_siesta.parse_hsx_native(str(path))
            assert (py.no_u, py.no_s, py.nspin) == (nat.no_u, nat.no_s, nat.nspin)
            for f in ("indxuo", "numh", "listh", "hamilt", "sover", "xij", "species_no",
                      "isa", "iaorb", "zval"):
                x, y = getattr(py, f), getattr(nat, f)
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    else:
        for name in ("data-HR-sparse_SPIN0.csr", "data-SR-sparse_SPIN0.csr"):
            py = list(t_abacus.read_csr_file(str(d / name)))
            nat = list(t_abacus.read_csr_native(str(d / name)))
            assert len(py) == len(nat) > 0
            for (s1, m1), (s2, m2) in zip(py, nat):
                np.testing.assert_array_equal(s1, s2)
                for f in ("data", "indices", "indptr"):
                    assert getattr(m1, f).tobytes() == getattr(m2, f).tobytes(), f
    tool = FORMATS[fmt][1]
    a = run_gdg(GDG[tool][1], tool, fmt == "soc", jd, tmp_path / "py", NAO[fmt])
    b = run_gdg(GDG[tool][1], tool, fmt == "soc", jd, tmp_path / "native", NAO[fmt],
                native=True)
    assert_crystals_equal(a, b, bits=True)


def test_native_csr_reader_reads_complex_soc_entries_bit_for_bit(abacus_soc_set, gxx):
    path = str(abacus_soc_set / "struct_0000" / "data-HR-sparse_SPIN0.csr")
    py = list(t_abacus.read_csr_file(path, soc=True))
    nat = list(t_abacus.read_csr_native(path, soc=True))
    assert len(py) == len(nat) > 1
    for (s1, m1), (s2, m2) in zip(py, nat):
        np.testing.assert_array_equal(s1, s2)
        assert m1.dtype == m2.dtype == np.complex128
        assert m1.data.tobytes() == m2.data.tobytes()


def test_a_failed_native_build_raises(tmp_path, monkeypatch, gxx):
    """A reader that does not compile raises; nothing falls back to Python."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setitem(t_native.SOURCES, "broken", bad)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken"):
        t_native.native_tool("broken")
    assert not (tmp_path / "build" / "broken").exists()


# ----------------------------------------------------------------------
# end to end
# ----------------------------------------------------------------------

def test_sk_pipeline_to_bands_on_the_cpu(tmp_path, sets):
    """The port's own chain: its teacher's openmx set -> graph_data_gen ->
    cli fit 1 epoch at a narrow width -> test from best.pt -> band_cal."""
    _jd, td = sets["openmx"]
    graphs = run_gdg(t_gdg, "openmx", False, td, tmp_path / "graph", 14)
    band_graphs = tmp_path / "band_graph"
    run_gdg(t_gdg, "openmx", False, type(td)(str(td) + "_band"), band_graphs, 14,
            runs="pristine_*")
    assert len(graphs) == 3 and "Hon0" in graphs[0]
    cfg = {
        "setup": {"stage": "fit"},
        "dataset_params": {"graph_data_path": str(tmp_path / "graph"), "batch_size": 1,
                           "train_ratio": 1 / 3, "val_ratio": 1 / 3, "test_ratio": 1 / 3},
        "optim_params": {"min_epochs": 0, "max_epochs": 1},
        "profiler_params": {"train_dir": str(tmp_path / "fit")},
        "representation_nets": {"HamGNN_pre": {
            "irreps_node_features": "4x0e+2x1o+2x2e", "irreps_edge_sh": "0e+1o+2e",
            "num_layers": 1, "num_radial": 4, "cutoff": 6.0, "radial_MLP": [4]}},
        "output_nets": {"HamGNN_out": {"nao_max": 14, "add_H0": True}},
    }
    (tmp_path / "fit.yaml").write_text(yaml.safe_dump(cfg))
    t_cli.main(["--config", str(tmp_path / "fit.yaml"), "--device", "cpu"])
    cfg["setup"] = {"stage": "test", "checkpoint_path": str(tmp_path / "fit" / "best")}
    cfg["dataset_params"]["graph_data_path"] = str(band_graphs)
    cfg["profiler_params"]["train_dir"] = str(tmp_path / "pred")
    (tmp_path / "test.yaml").write_text(yaml.safe_dump(cfg))
    t_cli.main(["--config", str(tmp_path / "test.yaml"), "--device", "cpu"])
    pred = np.load(tmp_path / "pred" / "prediction_hamiltonian.npy")
    assert pred.shape[1] == 14 * 14 and np.isfinite(pred).all()
    (tmp_path / "band.yaml").write_text(yaml.safe_dump({
        "nao_max": 14, "graph_data_path": str(band_graphs / "graph_data.npz"),
        "hamiltonian_path": str(tmp_path / "pred" / "prediction_hamiltonian.npy"),
        "nk": 5, "save_dir": str(tmp_path / "bands"), "auto_mode": True}))
    t_band_cal.main(["--config", str(tmp_path / "band.yaml")])
    bands = np.load(tmp_path / "bands" / "structure_1_bands.npz")["bands"]
    assert bands.shape[0] == 5 and np.isfinite(bands).all()


def test_scfout_header_is_little_endian_v3(sets):
    """The port's teacher writes the SCFOUT v3 header the reader expects."""
    _jd, td = sets["soc"]
    head = struct.unpack_from("<6i", (td / "struct_0000" / "openmx.scfout").read_bytes())
    assert head[0] == 2 and head[1] == 4 * 3 + 3


def test_sk_accuracy_runs_and_resumes_on_the_cpu(tmp_path, monkeypatch):
    """``tools_dev/sk_accuracy.py`` on 5 structures, 1 epoch, then
    ``--resume`` to 2, with the example configs narrowed (copies under a
    scratch root): one JSON result with the MAEs, the epochs and the band
    deviations; the made data removed, the checkpoint kept."""
    from hamgnn_tpu_torch.tools_dev import sk_accuracy

    root = tmp_path / "root"
    (root / "examples").mkdir(parents=True)
    shutil.copytree(sk_accuracy.ROOT / "examples" / "sk", root / "examples" / "sk")
    for name in ("config.yaml", "config_band_test.yaml"):
        path = root / "examples" / "sk" / name
        cfg = yaml.safe_load(path.read_text())
        cfg["representation_nets"]["HamGNN_pre"].update(
            irreps_node_features="4x0e+2x1o+2x2e", num_layers=1, num_radial=4, radial_MLP=[4])
        path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr(sk_accuracy, "ROOT", root)
    out = tmp_path / "out"
    argv = ["--out", str(out), "--n-si", "2", "--n-c", "2", "--n-sic", "1", "--device", "cpu"]
    first = sk_accuracy.main(argv + ["--max-epochs", "1"])
    again = sk_accuracy.main(argv + ["--max-epochs", "2", "--resume"])
    assert (first["epochs"], again["epochs"]) == (1, 2) and again["resumed"]
    for r in (first, again):
        assert np.isfinite(r["test_mae_Ha"]) and np.isfinite(r["best_val_mae_Ha"])
        assert len(r["bands"]) == 3 and np.isfinite(r["band_dev_max_meV"])
    assert json.loads((out / "result.json").read_text()) == again
    assert not (out / "datasets").exists() and (out / "train" / "best.pt").exists()
