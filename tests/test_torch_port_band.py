"""The port's band path against the JAX package's, on the CPU.

Same crystals (numpy, seeded), same ``k_vecs`` on both sides, fp32 with the
pad energy at 1e3.  Tolerances: ``band_energy`` / ``band_gap`` atol 5e-4 (the
fp32 eigensolvers of LAPACK and XLA on a spectrum that reaches 1e3);
``HK`` / ``SK`` / ``H_sym`` atol 5e-5 / rtol 1e-4 (as the model test);
wavefunctions up to a phase per band on non-degenerate bands
(|<psi_jax|S|psi_torch>| within 1e-3 of 1), never element-wise: phase and
order inside degenerate groups belong to the solver; parameter gradients of
the Hamiltonian + band loss within 1e-3 * max|ref| per tensor.  ``kpoints``
is a copy and must agree element for element.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict
from util_fixtures import add_random_hamiltonian_targets, make_crystal

from hamgnn_tpu.cli import build_model as j_build
from hamgnn_tpu.data.graph import pad_and_batch as j_pad
from hamgnn_tpu.models.basis import get_basis_set as j_basis
from hamgnn_tpu.models.model import compute_losses as j_losses
from hamgnn_tpu.models.output import HamGNNPlusPlusOut as JHead
from hamgnn_tpu.physics import band as j_band
from hamgnn_tpu.physics import kpoints as j_kp
from hamgnn_tpu.tools import band_cal as j_band_cal
from hamgnn_tpu.train.config import load_config as j_load_config
from hamgnn_tpu.train.trainer import init_params_on_cpu
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.data.dataset import save_graph_npz
from hamgnn_tpu_torch.data.graph import pad_and_batch as t_pad
from hamgnn_tpu_torch.data.synthetic import add_random_soc_targets
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.models.basis import get_basis_set as t_basis
from hamgnn_tpu_torch.models.model import compute_losses as t_losses
from hamgnn_tpu_torch.models.output import HamGNNPlusPlusOut as THead
from hamgnn_tpu_torch.physics import band as t_band
from hamgnn_tpu_torch.physics import eigh as t_eigh
from hamgnn_tpu_torch.physics import kpoints as t_kp
from hamgnn_tpu_torch.tools import band_cal as t_band_cal
from hamgnn_tpu_torch.train.config import load_config
from hamgnn_tpu_torch.train.trainer import Trainer

E_TOL = dict(atol=5e-4, rtol=0)
M_TOL = dict(atol=5e-5, rtol=1e-4)
FEAT = "8x0e+4x1o+2x2e"
BAND_CFG = {
    "representation_nets": {"HamGNN_pre": {
        "irreps_node_features": FEAT, "irreps_edge_sh": "0e+1o+2e",
        "num_layers": 1, "num_radial": 8, "cutoff": 4.0, "radial_MLP": [8],
        "num_types": 16}},
    "output_nets": {"HamGNN_out": {"nao_max": 14, "calculate_band_energy": True,
                                   "num_k": 3, "band_num_control": 2}},
}
LOSSES = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
           "loss_weight": 27.211},
          {"metric": "mae", "prediction": "band_energy", "target": "band_energy",
           "loss_weight": 0.27211}]


def _crystals(n=2, seed=0, n_atoms=3):
    rng = np.random.default_rng(seed)
    return [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=n_atoms + i, cutoff=4.0), nao_max=14)
        for i in range(n)]


def _graphs(crystals, bucket_multiple=8):
    """Both packages' padded batch; a small bucket keeps M = num_nodes, and
    with it the (M * nao)^2 matrices XLA's CPU eigh has to solve, small."""
    return (j_pad(crystals, bucket_multiple=bucket_multiple),
            t_pad(crystals, bucket_multiple=bucket_multiple))


def _k(graph, nk, seed=1):
    return j_kp.k_vecs_for_graph(graph, nk, None, rng=np.random.default_rng(seed))


def _np(t):
    return t.detach().numpy()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _flat(params):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params["params"]).items()}


def _assert_same_states(psi_t, psi_j, band, sk):
    """Rows of psi (nb, norb) agree up to a phase where the band is not
    degenerate with a neighbour: |<psi_j|S|psi_t>| = 1."""
    checked = 0
    for b in range(len(band)):
        gaps = [abs(band[b] - band[o]) for o in (b - 1, b + 1) if 0 <= o < len(band)]
        if min(gaps) < 1e-3:
            continue
        ov = abs(np.vdot(psi_j[b], sk @ psi_t[b]))
        assert abs(ov - 1.0) < 1e-3, (b, ov)
        checked += 1
    return checked


# ---------------------------------------------------------------------------
# kpoints: a copy, element-exact
# ---------------------------------------------------------------------------

LATTICES = {
    "cub": np.eye(3) * 4.0,
    "fcc": np.array([[0, .5, .5], [.5, 0, .5], [.5, .5, 0]]) * 5.43,
    "bcc": np.array([[-.5, .5, .5], [.5, -.5, .5], [.5, .5, -.5]]) * 3.0,
    "hex": np.array([[1, 0, 0], [-.5, np.sqrt(3) / 2, 0], [0, 0, 1.6]]) * 3.2,
    "tet": np.diag([3.0, 3.0, 5.0]),
    "orc": np.diag([3.0, 4.0, 5.0]),
    "mcl": np.array([[3.0, 0, 0], [0, 4.0, 0], [0, 1.0, 5.0]]),
    "tri": np.array([[3.0, 0.2, 0.1], [0.3, 4.0, 0.4], [0.5, 0.6, 5.0]]),
    "rhl": np.array([[1, .2, .2], [.2, 1, .2], [.2, .2, 1]]) * 4.0,
}


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_kpoints_match_exactly(name):
    lat = LATTICES[name]
    assert t_kp.classify_bravais(lat) == j_kp.classify_bravais(lat)
    nodes_t, labels_t = t_kp.auto_k_path(lat)
    nodes_j, labels_j = j_kp.auto_k_path(lat)
    assert labels_t == labels_j
    np.testing.assert_array_equal(np.asarray(nodes_t), np.asarray(nodes_j))
    for a, b in zip(t_kp.k_path(nodes_t, 17, lat), j_kp.k_path(nodes_j, 17, lat)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_kp.k_path_cartesian(nodes_t, 9, lat),
                                  j_kp.k_path_cartesian(nodes_j, 9, lat))
    np.testing.assert_array_equal(
        t_kp.random_k_cartesian(np.random.default_rng(5), 4, lat),
        j_kp.random_k_cartesian(np.random.default_rng(5), 4, lat))


@pytest.mark.parametrize("spec", [None, "auto", ((0, 0, 0), (0.5, 0, 0), (0.5, 0.5, 0))],
                         ids=["random", "auto", "path"])
def test_k_vecs_for_graph_matches(spec):
    jg, tg = _graphs(_crystals())
    a = t_kp.k_vecs_for_graph(tg, 4, spec, rng=np.random.default_rng(2))
    b = j_kp.k_vecs_for_graph(jg, 4, spec, rng=np.random.default_rng(2))
    assert a.dtype == np.float32 and a.shape == (2, 4, 3)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

def test_assemble_k_matrices_matches_and_repeats():
    jg, tg = _graphs(_crystals())
    k = _k(jg, 3)
    M = 5
    ref = np.asarray(j_band.assemble_k_matrices(jg, jg.Hon, jg.Hoff, jnp.asarray(k), 14, M))
    got = t_band.assemble_k_matrices(tg, tg.Hon, tg.Hoff, _t(k), 14, M)
    again = t_band.assemble_k_matrices(tg, tg.Hon, tg.Hoff, _t(k), 14, M)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (2, 3, M * 14, M * 14)
    np.testing.assert_allclose(_np(got), ref, **M_TOL)
    assert torch.equal(got, again)
    # several shifts per (src, dst) pair do occur: the sum over duplicates is exercised
    src, dst = _np(tg.edge_index)
    pairs = np.stack([src, dst])[:, _np(tg.edge_mask)]
    assert len(np.unique(pairs, axis=1).T) < pairs.shape[1]


def test_assembly_sums_duplicated_pairs_as_jax():
    """``assemble_k_matrices`` (``index_add_``) against the JAX package's on
    a batch where each (src, dst) pair of the first crystal occurs three
    times with different shifts, and against a float64 sum over the edges;
    gradients reach every row."""
    crystals = _crystals()
    c = dict(crystals[0])
    n_e = c["edge_index"].shape[1]
    c["edge_index"] = np.concatenate([c["edge_index"]] * 3, axis=1)
    c["nbr_shift"] = np.concatenate([c["nbr_shift"], c["nbr_shift"] + 1.5,
                                     c["nbr_shift"] - 0.5], axis=0)
    c["Hoff"] = np.random.default_rng(3).normal(size=(3 * n_e, 196)).astype(np.float32)
    for key in ("cell_shift", "Soff", "Hoff0"):
        if key in c:
            c[key] = np.concatenate([c[key]] * 3, axis=0)
    # each copy's inverse edges within the copy
    c["inv_edge_idx"] = np.concatenate([np.asarray(crystals[0]["inv_edge_idx"]) + r * n_e
                                        for r in range(3)])
    jg, tg = _graphs([c, crystals[1]])
    k = _k(jg, 2)
    M = 5
    ref = np.asarray(j_band.assemble_k_matrices(jg, jg.Hon, jg.Hoff, jnp.asarray(k), 14, M))
    h_off = tg.Hoff.clone().requires_grad_(True)
    got = t_band.assemble_k_matrices(tg, tg.Hon, h_off, _t(k), 14, M)
    np.testing.assert_allclose(_np(got), ref, **M_TOL)
    # the first crystal's off-site part, summed in float64 on the host
    e_idx = np.flatnonzero(_np(tg.edge_mask) & (_np(tg.batch)[_np(tg.edge_index[0])] == 0))
    host = np.zeros((2, M, M, 14, 14), complex)
    for e in e_idx:
        s_, d_ = _np(tg.edge_index[:, e])
        ph = np.exp(2j * np.pi * (k[0].astype(float) @ _np(tg.nbr_shift[e]).astype(float)))
        host[:, s_, d_] += ph[:, None, None] * _np(tg.Hoff[e]).reshape(14, 14)
    on = _np(tg.Hon)
    for i in np.flatnonzero(_np(tg.node_mask) & (_np(tg.batch) == 0)):
        host[:, i, i] += on[i].reshape(14, 14)
    host = host.transpose(0, 1, 3, 2, 4).reshape(2, M * 14, M * 14)
    np.testing.assert_allclose(_np(got[0]), host, atol=1e-4, rtol=1e-5)
    got.abs().sum().backward()
    assert bool((h_off.grad[_np(tg.edge_mask)].abs().sum(1) > 0).all())


def test_band_counts_per_crystal():
    jg, tg = _graphs(_crystals())
    counts = ((6, 2), (14, 4))
    table = t_band.species_count_table(counts)
    np.testing.assert_array_equal(_np(t_band.band_counts_per_crystal(tg, table)),
                                  np.asarray(j_band.band_counts_per_crystal(jg, counts)))


# ---------------------------------------------------------------------------
# band_energies_batched
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def solved():
    """Window mode with reciprocal export, and with H_sym, on both sides."""
    crystals = _crystals()
    jg, tg = _graphs(crystals)
    k = _k(jg, 2)
    M = 5
    jb, tb = j_basis("openmx", 14), t_basis("openmx", 14)
    j_out = j_band.band_energies_batched(
        jg, jg.Hon, jg.Hoff, jg.Son, jg.Soff, jnp.asarray(k), jb, num_bands=3,
        max_atoms=M, export_reciprocal=True, export_H_sym=True)
    t_out = t_band.band_energies_batched(
        tg, tg.Hon, tg.Hoff, tg.Son, tg.Soff, _t(k), tb, num_bands=3,
        max_atoms=M, export_reciprocal=True, export_H_sym=True)
    return crystals, jg, tg, k, M, jb, tb, j_out, t_out


def test_window_mode_bands_and_matrices(solved):
    *_, j_out, t_out = solved
    assert len(j_out) == len(t_out) == 6  # band, wfn, gap, HK, SK, H_sym (no dS in the data)
    band_j, wfn_j, gap_j, HK_j, SK_j, A_j = (np.asarray(a) for a in j_out)
    band_t, wfn_t, gap_t, HK_t, SK_t, A_t = (_np(a) for a in t_out)
    assert band_t.shape == band_j.shape == (2, 2, 6)
    assert wfn_t.shape == wfn_j.shape == (2, 2, 6, 70)
    np.testing.assert_allclose(band_t, band_j, **E_TOL)
    np.testing.assert_allclose(gap_t, gap_j, **E_TOL)
    np.testing.assert_allclose(HK_t, HK_j, **M_TOL)
    np.testing.assert_allclose(SK_t, SK_j, **M_TOL)
    np.testing.assert_allclose(A_t, A_j, **M_TOL)
    assert band_t.max() < 0.5 * t_band._PAD_ENERGY  # the window stays out of the pad states
    assert t_band._PAD_ENERGY == j_band._PAD_ENERGY
    checked = sum(_assert_same_states(wfn_t[b, q], wfn_j[b, q], band_j[b, q], SK_j[b, q])
                  for b in range(2) for q in range(2))
    assert checked >= 12


def test_window_is_clipped_out_of_the_pad_states(solved):
    """A window wider than the physical spectrum's upper part slides down
    (the clip of the JAX module) on both sides alike."""
    crystals, jg, tg, k, M, jb, tb, *_ = solved
    args = dict(num_bands=20, max_atoms=M)
    bj = np.asarray(j_band.band_energies_batched(
        jg, jg.Hon, jg.Hoff, jg.Son, jg.Soff, jnp.asarray(k), jb, **args)[0])
    bt = _np(t_band.band_energies_batched(
        tg, tg.Hon, tg.Hoff, tg.Son, tg.Soff, _t(k), tb, **args)[0])
    assert bt.shape == bj.shape == (2, 2, 40)
    np.testing.assert_allclose(bt, bj, **E_TOL)


def test_band_counts_mode(solved):
    crystals, jg, tg, k, M, jb, tb, *_ = solved
    counts = ((6, 2), (14, 4))
    j_out = j_band.band_energies_batched(
        jg, jg.Hon, jg.Hoff, jg.Son, jg.Soff, jnp.asarray(k), jb, num_bands=9, max_atoms=M,
        band_counts=j_band.band_counts_per_crystal(jg, counts))
    t_out = t_band.band_energies_batched(
        tg, tg.Hon, tg.Hoff, tg.Son, tg.Soff, _t(k), tb, num_bands=9, max_atoms=M,
        band_counts=t_band.band_counts_per_crystal(tg, t_band.species_count_table(counts)))
    assert len(t_out) == len(j_out) == 4
    np.testing.assert_allclose(_np(t_out[0]), np.asarray(j_out[0]), **E_TOL)
    np.testing.assert_allclose(_np(t_out[2]), np.asarray(j_out[2]), **E_TOL)
    np.testing.assert_array_equal(_np(t_out[3]), np.asarray(j_out[3]))
    assert tuple(t_out[1].shape) == tuple(j_out[1].shape) == (2, 2, 9, 70)


def test_predicted_overlap_sk_export(solved):
    crystals, jg, tg, k, M, jb, tb, j_ref, t_ref = solved
    j_out = j_band.band_energies_batched(
        jg, jg.Hon, jg.Hoff, jg.Son, jg.Soff, jnp.asarray(k), jb, num_bands=3, max_atoms=M,
        export_reciprocal=True, sk_export_on=jg.Son * 1.5, sk_export_off=jg.Soff * 1.5)
    t_out = t_band.band_energies_batched(
        tg, tg.Hon, tg.Hoff, tg.Son, tg.Soff, _t(k), tb, num_bands=3, max_atoms=M,
        export_reciprocal=True, sk_export_on=tg.Son * 1.5, sk_export_off=tg.Soff * 1.5)
    assert len(t_out) == len(j_out) == 5
    np.testing.assert_allclose(_np(t_out[4]), np.asarray(j_out[4]), **M_TOL)
    # the solve still factorizes the reference overlap
    np.testing.assert_allclose(_np(t_out[0]), _np(t_ref[0]), atol=1e-6)
    assert not np.allclose(_np(t_out[4]), _np(t_ref[4]))


def test_dsk_export_and_default_max_atoms():
    """With dSon/dSoff in the data dSK comes out; max_atoms=None takes the
    padded node count of the batch."""
    crystals = _crystals(n=1)
    rng = np.random.default_rng(3)
    for c in crystals:
        c["dSon"] = rng.normal(size=(*c["Son"].shape, 3))
        c["dSoff"] = rng.normal(size=(*c["Soff"].shape, 3))
    jg, tg = _graphs(crystals, bucket_multiple=4)
    k = _k(jg, 2)
    j_out = j_band.band_energies_batched(
        jg, jg.Hon, jg.Hoff, jg.Son, jg.Soff, jnp.asarray(k), j_basis("openmx", 14),
        num_bands=2, export_reciprocal=True)
    t_out = t_band.band_energies_batched(
        tg, tg.Hon, tg.Hoff, tg.Son, tg.Soff, _t(k), t_basis("openmx", 14),
        num_bands=2, export_reciprocal=True)
    assert len(t_out) == len(j_out) == 6
    n = tg.num_nodes * 14
    assert tuple(t_out[5].shape) == tuple(j_out[5].shape) == (1, 2, n, n, 3)
    np.testing.assert_allclose(_np(t_out[5]), np.asarray(j_out[5]), **M_TOL)
    np.testing.assert_allclose(_np(t_out[0]), np.asarray(j_out[0]), **E_TOL)


def test_reference_bands_match_a_float64_host_solve(solved):
    """The compact float64 scipy solve of the same H(k), S(k)."""
    import scipy.linalg

    crystals, jg, tg, k, M, jb, tb, j_out, t_out = solved
    band = _np(t_out[0])
    for b, c in enumerate(crystals):
        res_k = k[b].astype(np.float64)
        n = len(c["z"])
        valid = np.concatenate([tb.orbital_mask_table[z] > 0 for z in c["z"]])
        rows = lambda on, off: np.concatenate([c[on], c[off]])  # noqa: E731
        HK = t_band_cal.assemble_k_matrices_numpy(
            rows("Hon", "Hoff"), n, c["edge_index"], c["nbr_shift"], res_k, 14, valid)
        SK = t_band_cal.assemble_k_matrices_numpy(
            rows("Son", "Soff"), n, c["edge_index"], c["nbr_shift"], res_k, 14, valid)
        n_el = sum(tb.num_valence[int(z)] for z in c["z"])
        half = int(np.ceil(n_el / 2))
        start = min(max(half - 3, 0), max(int(valid.sum()) - 6, 0))
        for q in range(k.shape[1]):
            ev = scipy.linalg.eigh(HK[q], SK[q], eigvals_only=True)
            np.testing.assert_allclose(band[b, q], ev[start : start + 6], **E_TOL)


# ---------------------------------------------------------------------------
# the head's band branch, eagerly, in the modes the model fixture does not run
# ---------------------------------------------------------------------------

def test_head_band_branch_species_counts_and_reciprocal_export():
    crystals = _crystals()
    jg, tg = _graphs(crystals)
    k = _k(jg, 2)
    kw = dict(irreps_in_node=FEAT, irreps_in_edge=FEAT, nao_max=14, ham_type="openmx",
              ham_only=False, calculate_band_energy=True, num_k=2, band_num_control=7,
              band_species_counts=((6, 2), (14, 4)), export_reciprocal_values=True)
    rng = np.random.default_rng(4)
    feats = {"node_attr": rng.normal(size=(jg.num_nodes, 30)).astype(np.float32),
             "edge_attr": rng.normal(size=(jg.num_edges, 30)).astype(np.float32)}
    jh = JHead(**kw)
    jfeats = {n: jnp.asarray(v) for n, v in feats.items()}
    params = jh.init(jax.random.PRNGKey(0), jg, jfeats, k_vecs=jnp.asarray(k))
    jp = jh.apply(params, jg, jfeats, k_vecs=jnp.asarray(k))
    th = load_flax_params(THead(**kw), _flat(params))
    with torch.no_grad():
        tp = th(tg, {n: _t(v) for n, v in feats.items()}, k_vecs=_t(k))
    assert set(tp) == set(jp)
    assert {"band_mask", "HK", "SK", "band_energy_ref", "wavefunction_ref"} <= set(tp)
    assert "H_sym" not in tp
    for key in ("band_energy", "band_gap", "band_energy_ref", "band_gap_ref"):
        np.testing.assert_allclose(_np(tp[key]), np.asarray(jp[key]), err_msg=key, **E_TOL)
    for key in ("HK", "SK", "hamiltonian_on", "overlap_off"):
        np.testing.assert_allclose(_np(tp[key]), np.asarray(jp[key]), err_msg=key, **M_TOL)
    np.testing.assert_array_equal(_np(tp["band_mask"]), np.asarray(jp["band_mask"]))
    # the masked band loss
    spec = [{"metric": "mae", "prediction": "band_energy", "target": "band_energy"},
            {"metric": "mae", "prediction": "band_gap", "target": "band_gap"}]
    tl, jl = t_losses(tp, tg, spec)[0], j_losses(jp, jg, spec)[0]
    np.testing.assert_allclose(float(tl), float(jl), **E_TOL)
    # without k-points the branch does not run
    with torch.no_grad():
        assert "band_energy" not in th(tg, {n: _t(v) for n, v in feats.items()})


# ---------------------------------------------------------------------------
# the whole model through jax_params: outputs, losses, gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_pair():
    cfg_j = j_load_config(None, overrides=BAND_CFG)
    cfg_t = load_config(None, overrides=BAND_CFG)
    crystals = _crystals(seed=7)
    jg, tg = _graphs(crystals)
    jm = j_build(cfg_j)
    params = init_params_on_cpu(jm, jg, 0)
    k = _k(jg, 3, seed=8)

    def f(p):
        # the two weighted loss terms apart, so that one compilation gives
        # the gradient of each
        preds = jm.apply(p, jg, k_vecs=jnp.asarray(k))
        terms = jnp.stack([j_losses(preds, jg, [spec])[0] for spec in LOSSES])
        return terms, (preds, j_losses(preds, jg, LOSSES))

    jgrad, (jp, (jl, jlogs)) = jax.jit(jax.jacrev(f, has_aux=True))(params)
    tm = t_cli.build_model(cfg_t)
    load_flax_params(tm, _flat(params))
    return cfg_t, crystals, jg, tg, k, params, jl, jp, jlogs, jgrad, tm


def test_band_model_loads_the_same_parameter_tree(model_pair):
    cfg_t, *_rest, params, _jl, _jp, _jlogs, _jgrad, tm = model_pair
    plain = t_cli.build_model(load_config(None, overrides={
        **BAND_CFG, "output_nets": {"HamGNN_out": {"nao_max": 14}}}))
    assert not plain.output.calculate_band_energy and tm.output.calculate_band_energy
    names = {n for n, _ in tm.named_parameters()}
    assert names == {n for n, _ in plain.named_parameters()}  # the branch has no parameters
    assert names == {k.replace("/", ".") for k in _flat(params)}
    load_flax_params(plain, _flat(params))
    assert (tm.output.num_k, tm.output.band_num_control, tm.output.k_path) == (3, 2, None)


def test_band_model_forward_and_losses(model_pair):
    cfg_t, crystals, jg, tg, k, params, jl, jp, jlogs, jgrad, tm = model_pair
    with torch.no_grad():
        tp = tm(tg, k_vecs=_t(k))
        tl, tlogs = t_losses(tp, tg, LOSSES)
    assert set(tp) == set(jp)
    for key in ("band_energy", "band_gap", "band_energy_ref", "band_gap_ref"):
        np.testing.assert_allclose(_np(tp[key]), np.asarray(jp[key]), err_msg=key, **E_TOL)
    for key in ("hamiltonian_on", "hamiltonian_off", "H_sym", "H_sym_ref"):
        np.testing.assert_allclose(_np(tp[key]), np.asarray(jp[key]), err_msg=key, **M_TOL)
    assert tuple(tp["wavefunction"].shape) == tuple(jp["wavefunction"].shape)
    assert not tp["band_energy_ref"].requires_grad
    np.testing.assert_allclose(float(tl), float(jl), atol=5e-4, rtol=1e-4)
    for key in jlogs:
        np.testing.assert_allclose(float(tlogs[key]), float(jlogs[key]), err_msg=key, **E_TOL)
    # zero-point shift of the bands: the mean deviation from the reference bands is removed
    assert abs(float((tp["band_energy"] - tp["band_energy_ref"]).mean())) < 1e-4
    # without k-points the same model runs the Hamiltonian path only
    with torch.no_grad():
        assert "band_energy" not in tm(tg)


def _grad_rows(model, loss, ref):
    model.zero_grad()
    loss.backward(retain_graph=True)
    return [(name, float(np.abs(_np(p.grad) - ref[name.replace(".", "/")]).max()),
             float(np.abs(ref[name.replace(".", "/")]).max()))
            for name, p in model.named_parameters()]


def test_band_model_gradients(model_pair):
    """Per tensor against ``jax.grad``: the Hamiltonian term within 1e-3 *
    max|ref| as everywhere; the band term within 2e-2 * max|ref|.  The band
    term's limit is that of the fp32 eigensolvers, not of the port: with the
    pad states at 1e3 an eigenvector is good to ~eps * 1e3 / gap = 6e-5 / gap,
    percents where two bands come within 0.01 of each other, in LAPACK and in
    XLA alike (measured here: 9e-3).  The port's own backward through the
    assembly, Cholesky, ``eigh`` and the window is held to 1e-6 in float64 by
    ``test_band_gradient_against_finite_differences``."""
    cfg_t, crystals, jg, tg, k, params, jl, jp, jlogs, jgrad, tm = model_pair
    ref = _flat(jgrad)
    preds = tm(tg, k_vecs=_t(k))
    for i, (spec, tol) in enumerate(zip(LOSSES, (1e-3, 2e-2))):
        rows = _grad_rows(tm, t_losses(preds, tg, [spec])[0], {n: g[i] for n, g in ref.items()})
        assert max(scale for _n, _e, scale in rows) > 0
        for name, err, scale in rows:
            assert np.isfinite(err) and err <= tol * scale, (spec["prediction"], name, err, scale)


def test_band_gradient_against_finite_differences():
    """d(band loss)/d(h_on, h_off) through ``band_energies_batched`` in
    float64 against central differences along a random direction."""
    crystals = _crystals(n=1)
    tg = t_pad(crystals, bucket_multiple=4)
    k = _t(_k(tg, 2)).double()
    basis = t_basis("openmx", 14)
    rng = np.random.default_rng(21)
    h_on, h_off, s_on, s_off = (getattr(tg, n).double() for n in ("Hon", "Hoff", "Son", "Soff"))
    target = _t(rng.normal(size=(1, 2, 4)))

    def loss(on, off):
        band, _wfn, gap, A = t_band.band_energies_batched(
            tg, on, off, s_on, s_off, k, basis, num_bands=2, export_H_sym=True)
        return ((band - target) ** 2).sum() + gap.sum() + A.abs().sum() * 1e-3

    on, off = h_on.clone().requires_grad_(True), h_off.clone().requires_grad_(True)
    g_on, g_off = torch.autograd.grad(loss(on, off), (on, off))
    # a symmetric direction keeps H(k) Hermitian, as the head's outputs are
    d_on = _t(rng.normal(size=(tg.num_nodes, 14, 14)))
    d_on = (0.5 * (d_on + d_on.transpose(1, 2)) * (h_on != 0).reshape(-1, 14, 14)).reshape(h_on.shape)
    d_off = _t(rng.normal(size=(tg.num_edges, 14, 14)))
    d_off = 0.5 * (d_off + d_off[tg.inv_edge_idx].transpose(1, 2))
    d_off = (d_off * (h_off != 0).reshape(-1, 14, 14)).reshape(h_off.shape)
    eps = 1e-6
    with torch.no_grad():
        fd = (loss(h_on + eps * d_on, h_off + eps * d_off)
              - loss(h_on - eps * d_on, h_off - eps * d_off)) / (2 * eps)
    an = (g_on * d_on).sum() + (g_off * d_off).sum()
    assert abs(float(fd - an)) <= 1e-6 * abs(float(an)) + 1e-9, (float(fd), float(an))


def test_wavefunction_and_h_sym_losses_behave_as_in_jax(model_pair):
    """H_sym goes through Cholesky and the triangular solves only: finite
    gradients.  A loss on eigenvectors divides by eigenvalue gaps, and the pad
    states are exactly degenerate at _PAD_ENERGY: jax.grad of that loss on
    this input is not finite (measured once: all 57 leaves), and neither is
    the port's.  The loss values are finite on both sides."""
    cfg_t, crystals, jg, tg, k, *_rest, tm = model_pair
    spec_h = [{"metric": "mae", "prediction": "H_sym", "target": "H_sym"}]
    spec_w = [{"metric": "mae", "prediction": "wavefunction", "target": "wavefunction"}]
    tm.zero_grad()
    preds = tm(tg, k_vecs=_t(k))
    loss_h = t_losses(preds, tg, spec_h)[0]
    loss_w = t_losses(preds, tg, spec_w)[0]
    assert np.isfinite(float(loss_h)) and np.isfinite(float(loss_w))
    g_h = torch.autograd.grad(loss_h, list(tm.parameters()), retain_graph=True,
                              allow_unused=True)
    assert all(torch.isfinite(g).all() for g in g_h if g is not None)
    g_w = torch.autograd.grad(loss_w, list(tm.parameters()), allow_unused=True)
    assert any(not torch.isfinite(g).all() for g in g_w if g is not None)


# ---------------------------------------------------------------------------
# trainer and CLI
# ---------------------------------------------------------------------------

def test_trainer_band_kwargs_and_step(tmp_path, model_pair):
    cfg_t, crystals, jg, tg, *_rest = model_pair
    model = t_cli.build_model(cfg_t)
    tr = Trainer(model, losses=LOSSES, metrics=[], lr=1e-3, train_dir=str(tmp_path),
                 device="cpu")
    k1 = tr._band_kwargs(tg)["k_vecs"]
    k2 = tr._band_kwargs(tg)["k_vecs"]
    assert tuple(k1.shape) == (2, 3, 3) and k1.dtype == torch.float32
    assert torch.equal(k1, k2)  # the same k set per crystal slot at every call
    model.output.k_path = ((0.0, 0.0, 0.0), (0.5, 0.0, 0.0))
    want = t_kp.k_vecs_for_graph(tg, 3, model.output.k_path)
    np.testing.assert_array_equal(_np(tr._band_kwargs(tg)["k_vecs"]), want)
    loss, logs = tr.train_step(tg)
    assert np.isfinite(float(loss)) and float(logs["nonfinite_step"]) == 0.0
    assert "mae_band_energy" in logs
    val, agg = tr.eval_epoch([tg])
    assert np.isfinite(val) and np.isfinite(agg["mae_band_energy"])
    model.output.calculate_band_energy = False
    assert tr._band_kwargs(tg) == {}


def test_band_k_points_match_the_jax_trainer(tmp_path, model_pair):
    """Without a k_path both trainers draw the random k set from a fresh
    seeded generator at every call: two calls of each give the same k set,
    bit for bit as float32, in training and validation alike; with a k_path
    both follow it."""
    from hamgnn_tpu.train.trainer import Trainer as JTrainer

    cfg_t, crystals, jg, tg, *_rest = model_pair
    t_model = t_cli.build_model(cfg_t)
    t_tr = Trainer(t_model, losses=LOSSES, metrics=[], lr=1e-3,
                   train_dir=str(tmp_path / "t"), device="cpu")
    j_model = j_build(j_load_config(None, overrides=BAND_CFG))
    j_tr = JTrainer(j_model, losses=LOSSES, metrics=[], lr=1e-3, train_dir=str(tmp_path / "j"))
    ks = [np.asarray(j_tr._band_kwargs(jg)["k_vecs"]) for _ in range(2)]
    ks += [_np(t_tr._band_kwargs(tg)["k_vecs"]) for _ in range(2)]
    assert all(k.dtype == np.float32 and k.shape == (2, 3, 3) for k in ks)
    for k in ks[1:]:
        np.testing.assert_array_equal(k, ks[0])
    path = [[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.5, 0.5, 0.0]]
    cfg_path = json.loads(json.dumps(BAND_CFG))
    cfg_path["output_nets"]["HamGNN_out"]["k_path"] = path
    j_tr.model = j_build(j_load_config(None, overrides=cfg_path))
    t_tr.model = t_cli.build_model(load_config(None, overrides=cfg_path))
    want = t_kp.k_vecs_for_graph(tg, 3, path)
    np.testing.assert_array_equal(want, j_kp.k_vecs_for_graph(jg, 3, path))
    assert not np.array_equal(want, ks[0])
    for _ in range(2):
        np.testing.assert_array_equal(np.asarray(j_tr._band_kwargs(jg)["k_vecs"]), want)
        np.testing.assert_array_equal(_np(t_tr._band_kwargs(tg)["k_vecs"]), want)


def test_cli_fit_then_test_with_band_loss(tmp_path, capsys):
    save_graph_npz(str(tmp_path / "graph_data.npz"), _crystals(n=3, seed=11))
    cfg = json.loads(json.dumps(BAND_CFG))
    cfg["output_nets"]["HamGNN_out"]["k_path"] = [[0, 0, 0], [0.5, 0, 0], [0.5, 0.5, 0]]
    cfg["setup"] = {"stage": "fit"}
    cfg["dataset_params"] = {"graph_data_path": str(tmp_path), "batch_size": 1,
                             "train_ratio": 1 / 3, "val_ratio": 1 / 3, "test_ratio": 1 / 3}
    cfg["optim_params"] = {"lr": 1e-3, "min_epochs": 0, "max_epochs": 2}
    cfg["losses_metrics"] = {
        "losses": LOSSES,
        "metrics": [{"metric": "mae", "prediction": "band_energy", "target": "band_energy"},
                    {"metric": "mae", "prediction": "band_gap", "target": "band_gap"}]}
    cfg["profiler_params"] = {"train_dir": str(tmp_path / "fit")}
    with open(tmp_path / "fit.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    t_cli.main(["--config", str(tmp_path / "fit.yaml"), "--device", "cpu"])
    records = [json.loads(line) for line in open(tmp_path / "fit" / "metrics.jsonl")]
    assert [r["epoch"] for r in records] == [0, 1]
    for r in records:
        assert np.isfinite(r["train_loss"]) and np.isfinite(r["val/mae_band_energy"])
        assert np.isfinite(r["val/mae_band_gap"])
    out = capsys.readouterr().out
    assert "test metrics:" in out and "mae_band_energy" in out and "mae_band_gap" in out

    cfg["setup"] = {"stage": "test", "checkpoint_path": str(tmp_path / "fit" / "best.pt")}
    cfg["profiler_params"] = {"train_dir": str(tmp_path / "out")}
    with open(tmp_path / "test.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    t_cli.main(["--config", str(tmp_path / "test.yaml"), "--device", "cpu"])
    assert "mae_band_energy" in capsys.readouterr().out
    pred = np.load(tmp_path / "out" / "prediction_hamiltonian.npy")
    assert np.isfinite(pred).all() and pred.shape[1] == 196
    # the CLI writes the Hamiltonian files (and their scatter plot) only: no
    # band file of its own
    import importlib.util

    plot = ["hamiltonian_scatter.png"] if importlib.util.find_spec("matplotlib") else []
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted([
        "config_resolved.yaml", "prediction_hamiltonian.npy", "target_hamiltonian.npy", *plot])


@pytest.mark.parametrize("bnc,want", [
    (6, {"band_num_control": 6}),
    (None, {"band_num_control": 8}),
    (True, {"band_num_control": 8}),
    ({6: 2, 14: 4}, {"band_num_control": 32, "band_species_counts": ((6, 2), (14, 4))}),
    ({"6": 2, "14": 4}, {"band_num_control": 32, "band_species_counts": ((6, 2), (14, 4))}),
], ids=["int", "none", "bool", "dict_int_keys", "dict_str_keys"])
def test_cli_band_control(bnc, want):
    """An int is the window's half-width; a per-species mapping, as YAML gives
    it with number or string keys, reaches the head as ``band_species_counts``
    (the JAX CLI's loader turns the mapping into a namespace, which its
    ``_band_control_kwargs`` then takes for an unsupported value: logged in
    ROADMAP.md, not copied)."""
    cfg = load_config(None, overrides={"output_nets": {"HamGNN_out": {
        "band_num_control": bnc, "calculate_band_energy": True, "num_k": 4,
        "k_path": [[0, 0, 0], [0.5, 0, 0]], "export_reciprocal_values": True}}})
    assert t_cli._band_control_kwargs(cfg.output_nets.HamGNN_out) == want
    head = t_cli.build_model(load_config(None, overrides=_merge_out(BAND_CFG, {
        "band_num_control": bnc, "k_path": [[0, 0, 0], [0.5, 0, 0]],
        "export_reciprocal_values": True}))).output
    assert head.calculate_band_energy and head.export_reciprocal_values
    assert head.k_path == ((0.0, 0.0, 0.0), (0.5, 0.0, 0.0))
    assert head.band_num_control == want["band_num_control"]
    assert head.band_species_counts == want.get("band_species_counts")


def _merge_out(base, out):
    cfg = json.loads(json.dumps(base))
    cfg["output_nets"]["HamGNN_out"].update(out)
    return cfg


def test_cli_band_control_warns_on_a_fraction():
    cfg = load_config(None, overrides={"output_nets": {"HamGNN_out": {
        "band_num_control": 0.5, "max_bands": 12}}})
    with pytest.warns(UserWarning, match="12-band window"):
        assert t_cli._band_control_kwargs(cfg.output_nets.HamGNN_out) == {
            "band_num_control": 12}
    assert t_cli._freeze_k_path("auto") == "auto" and t_cli._freeze_k_path(None) is None


@pytest.mark.parametrize("key", ["soc_switch", "spin_constrained"])
def test_cli_still_refuses_soc_and_spin(key):
    """The magnetic head, with and without its SOC switch, is built (it was
    refused before it was ported), its band flags kept; the SOC head alone
    (``soc_switch`` without ``spin_constrained``) is built, band branch
    included."""
    cfg = load_config(None, overrides=_merge_out(BAND_CFG, {key: True,
                                                            "spin_constrained": True}))
    head = t_cli.build_model(cfg).output
    assert type(head).__name__ == "HamGNNMagneticOut" and head.calculate_band_energy
    assert head.soc_switch == (key == "soc_switch")
    if key == "soc_switch":
        head = t_cli.build_model(load_config(None, overrides=_merge_out(
            BAND_CFG, {key: True}))).output
        assert type(head).__name__ == "HamGNNSOCOut" and head.calculate_band_energy


# ---------------------------------------------------------------------------
# an overlap that is not positive definite, a matrix that is not finite: NaN
# where JAX gives NaN, never an exception
# ---------------------------------------------------------------------------

def _hermitian(rng, shape, n):
    a = rng.normal(size=(*shape, n, n)) + 1j * rng.normal(size=(*shape, n, n))
    return a + np.swapaxes(a, -1, -2).conj()


def test_plain_eigensolve_and_cholesky_give_nan_where_jax_does():
    """A NaN matrix through the plain eigensolve, an indefinite one through
    the Cholesky factor: NaN for that matrix alone, as ``jnp.linalg.eigh``
    and ``jnp.linalg.cholesky`` give, where ``torch.linalg.cholesky``
    raises; the other matrices as ``torch.linalg.eigh`` / ``cholesky``."""
    rng = np.random.default_rng(9)
    a = _hermitian(rng, (3,), 6).astype(np.complex64)
    a[1, 2, 3] = a[1, 3, 2] = np.nan
    w, v = t_eigh.hermitian_eigh(_t(a))
    jw, jv = jnp.linalg.eigh(jnp.asarray(a))
    np.testing.assert_array_equal(np.isnan(_np(w)), np.isnan(np.asarray(jw)))
    np.testing.assert_array_equal(np.isnan(_np(v)), np.isnan(np.asarray(jv)))
    assert np.isnan(_np(w)[1]).all() and np.isfinite(_np(w)[[0, 2]]).all()
    rw, rv = torch.linalg.eigh(_t(a[[0, 2]]))
    assert torch.equal(w[[0, 2]], rw) and torch.equal(v[[0, 2]], rv)

    s = _hermitian(rng, (3,), 6)
    s = (s @ np.swapaxes(s, -1, -2).conj() / 6 + np.eye(6)).astype(np.complex64)
    s[2] = -s[2]
    with pytest.raises(RuntimeError):
        torch.linalg.cholesky(_t(s))
    L, jl = t_eigh.cholesky(_t(s)), np.asarray(jnp.linalg.cholesky(jnp.asarray(s)))
    np.testing.assert_array_equal(np.isnan(_np(L)), np.isnan(jl))
    np.testing.assert_array_equal(np.isnan(_np(L)[2]), np.tri(6, dtype=bool))
    assert torch.equal(L[:2], torch.linalg.cholesky(_t(s[:2])))
    np.testing.assert_allclose(_np(L[:2]), jl[:2], atol=1e-5, rtol=0)


def test_eigensolve_gives_nan_for_a_matrix_that_does_not_converge(monkeypatch):
    """Where ``torch.linalg.eigh`` raises that a finite matrix did not
    converge (made here by a stand-in of it that raises for a marked
    matrix), that matrix alone gets NaN, as ``jnp.linalg.eigh`` gives for a
    failed solve; the others are ``torch.linalg.eigh``'s."""
    rng = np.random.default_rng(11)
    a = _t(_hermitian(rng, (3,), 5).astype(np.complex64))
    a[1, 0, 0] = 99.0
    eigh = torch.linalg.eigh

    def failing(m, *args, **kwargs):
        if bool((m[..., 0, 0].real == 99.0).any()):
            raise torch.linalg.LinAlgError("linalg.eigh: the algorithm failed to converge")
        return eigh(m, *args, **kwargs)

    monkeypatch.setattr(torch.linalg, "eigh", failing)
    w, v = t_eigh.hermitian_eigh(a)
    assert torch.isnan(w[1]).all() and torch.isnan(v[1]).all()
    rw, rv = eigh(a[[0, 2]])
    assert torch.equal(w[[0, 2]], rw) and torch.equal(v[[0, 2]], rv)


def test_eigh_backward_is_torchs():
    """``eigh_backward`` against torch's own backward of ``linalg.eigh``, in
    float64, for a loss on the eigenvalues and on |v|^2 (which does not
    depend on the eigenvectors' phases)."""
    rng = np.random.default_rng(10)
    a = torch.as_tensor(_hermitian(rng, (2, 3), 7)).requires_grad_(True)
    cw, cv = _t(rng.normal(size=(2, 3, 7))), _t(rng.normal(size=(2, 3, 7, 7)))

    def grad(fn):
        w, v = fn(a)
        return torch.autograd.grad((w * cw).sum() + (v.abs() ** 2 * cv).sum(), a)[0]

    ref = grad(torch.linalg.eigh)
    np.testing.assert_allclose(_np(grad(t_eigh.hermitian_eigh)), _np(ref), atol=1e-10, rtol=0)
    # the eigenvalues alone: no gradient through the eigenvectors' gaps
    g = torch.autograd.grad(t_eigh.hermitian_eigh(a)[0].sum(), a)[0]
    np.testing.assert_allclose(_np(g), _np(torch.eye(7).expand(2, 3, 7, 7)), atol=1e-12, rtol=0)


SOC_BAND_LOSSES = [{"metric": "mae", "prediction": p, "target": p, "loss_weight": 27.211}
                   for p in ("hamiltonian_real", "hamiltonian_imag")] + LOSSES[1:]


@pytest.mark.parametrize("head", ["hamgnn", "soc"])
def test_indefinite_overlap_drops_the_step_and_gives_nan_bands_as_jax(tmp_path, model_pair,
                                                                      head):
    """The same batch, whose first crystal's overlap is negative definite,
    and the same weights through the JAX trainer's jitted steps and the
    port's trainer: on both sides the training step is dropped
    (``nonfinite_step`` 1, parameters and optimizer state unchanged) and the
    eval step's bands are NaN at the same places, finite and equal
    elsewhere; nothing raises.  The non-SOC head takes ``model_pair``'s
    weights; most of the time is the JAX steps' compilation."""
    from jax.flatten_util import ravel_pytree

    from hamgnn_tpu.train.trainer import Trainer as JTrainer

    _cfg, crystals, _jg, _tg, _k, params, *_rest = model_pair
    crystals = list(crystals)
    cfg, losses = BAND_CFG, LOSSES
    if head == "soc":
        rng = np.random.default_rng(12)
        crystals = [add_random_soc_targets(rng, c, nao_max=14) for c in crystals]
        cfg = _merge_out(BAND_CFG, {"soc_switch": True, "soc_basis": "so3",
                                    "zero_point_shift": False})
        losses = SOC_BAND_LOSSES
    crystals[0] = dict(crystals[0], Son=-crystals[0]["Son"], Soff=-crystals[0]["Soff"])
    jg, tg = _graphs(crystals)
    j_tr = JTrainer(j_build(j_load_config(None, overrides=cfg)), losses=losses, metrics=[],
                    lr=1e-3, train_dir=str(tmp_path / "j"))
    if head == "soc":
        params = init_params_on_cpu(j_tr.model, jg, 0)
    j_tr.params = params
    j_tr.opt_state = j_tr.tx.init(ravel_pytree(params)[0])
    params0 = _flat(params)
    tm = t_cli.build_model(load_config(None, overrides=cfg))
    load_flax_params(tm, params0)
    t_tr = Trainer(tm, losses=losses, metrics=[], lr=1e-3, train_dir=str(tmp_path / "t"),
                   device="cpu")

    kw = j_tr._band_kwargs(jg)
    p1, _opt, j_loss, j_logs = j_tr._get_train_step(jg)(
        j_tr.params, j_tr.opt_state, jg, jnp.asarray(1e-3, jnp.float32), **kw)
    assert float(j_logs["nonfinite_step"]) == 1.0 and not np.isfinite(float(j_loss))
    assert all(np.array_equal(v, params0[n]) for n, v in _flat(p1).items())
    flat0, opt0 = t_tr.flat.clone(), {k: v.clone() for k, v in t_tr.opt.state_dict().items()}
    t_loss, t_logs = t_tr.train_step(tg)
    assert float(t_logs["nonfinite_step"]) == 1.0 and not np.isfinite(float(t_loss))
    assert torch.equal(t_tr.flat, flat0)
    assert all(torch.equal(v, opt0[k]) for k, v in t_tr.opt.state_dict().items())

    jp = j_tr._get_eval_step(jg)(p1, jg, **kw)[3]
    tp = t_tr.eval_step(tg)[3]
    for key in ("band_energy", "band_energy_ref", "band_gap", "band_gap_ref"):
        a, b = _np(tp[key]), np.asarray(jp[key])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=key)
        np.testing.assert_allclose(a[~np.isnan(b)], b[~np.isnan(b)], err_msg=key, **E_TOL)
    ref = _np(tp["band_energy_ref"])
    assert np.isnan(ref[0]).all() and np.isfinite(ref[1]).all()


# ---------------------------------------------------------------------------
# band_cal
# ---------------------------------------------------------------------------

def test_band_cal_matches_the_jax_package(tmp_path):
    crystals = _crystals(n=1, seed=13, n_atoms=4)
    c = crystals[0]
    nodes = [[0, 0, 0], [0.5, 0, 0], [0.5, 0.5, 0]]
    h_rows = np.concatenate([c["Hon"], c["Hoff"]])
    got = t_band_cal.band_structure_for_crystal(c, h_rows, 14, t_basis("openmx", 14), 7, nodes)
    ref = j_band_cal.band_structure_for_crystal(c, h_rows, 14, j_basis("openmx", 14), 7, nodes)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-10, atol=1e-10, err_msg=key)

    # the console entry on a prediction file
    save_graph_npz(str(tmp_path / "graph_data.npz"), crystals)
    np.save(tmp_path / "pred.npy", h_rows)
    cfg = {"nao_max": 14, "graph_data_path": str(tmp_path / "graph_data.npz"),
           "hamiltonian_path": str(tmp_path / "pred.npy"), "nk": 7,
           "save_dir": str(tmp_path / "bands"), "strcture_name": "si", "k_path": nodes,
           "label": ["G", "X", "M"]}
    with open(tmp_path / "band_cal.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    t_band_cal.main(["--config", str(tmp_path / "band_cal.yaml")])
    saved = np.load(tmp_path / "bands" / "si_0_bands.npz")
    np.testing.assert_allclose(saved["bands"], ref["bands"], rtol=1e-10, atol=1e-10)
    for name in ("si_0_bands.png", "si_0_bands.dat", "si_0.cif"):
        assert (tmp_path / "bands" / name).stat().st_size > 0
    assert (tmp_path / "bands" / "si_0.cif").read_text() == _jax_cif(c, tmp_path)


def _jax_cif(c, tmp_path):
    j_band_cal.write_cif(c, str(tmp_path / "ref.cif"))
    return (tmp_path / "ref.cif").read_text()


def test_band_cal_soc_branch_matches(tmp_path):
    """The numpy SOC branch comes along with the tool."""
    c = _crystals(n=1, seed=14)[0]
    rng = np.random.default_rng(15)
    n, e = len(c["z"]), c["edge_index"].shape[1]
    inv = c["inv_edge_idx"]

    def herm_rows():
        on = rng.normal(size=(n, 28, 28)) + 1j * rng.normal(size=(n, 28, 28))
        on = 0.5 * (on + on.conj().transpose(0, 2, 1))
        off = rng.normal(size=(e, 28, 28)) + 1j * rng.normal(size=(e, 28, 28))
        off = 0.5 * (off + off[inv].conj().transpose(0, 2, 1))
        rows = np.concatenate([on.reshape(n, -1), off.reshape(e, -1)])
        return rows.real, rows.imag

    hr, hi = herm_rows()
    nodes = [[0, 0, 0], [0.5, 0, 0]]
    got = t_band_cal.band_structure_for_crystal(
        c, hr, 14, t_basis("openmx", 14), 3, nodes, soc=True, ih_rows=hi)
    ref = j_band_cal.band_structure_for_crystal(
        c, hr, 14, j_basis("openmx", 14), 3, nodes, soc=True, ih_rows=hi)
    np.testing.assert_allclose(got["bands"], ref["bands"], rtol=1e-10, atol=1e-10)
    assert got["n_electrons"] == ref["n_electrons"]
