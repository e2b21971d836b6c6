"""Static tables of the PyTorch port against the JAX package: element-exact.

Irreps algebra, Wigner-3j, coupling tensors, packed-plan tables, basis tables,
merge/decompose matrices and the synthetic-crystal builders, for the
``bench.py`` irreps and the ``examples/sk/config.yaml`` irreps.
"""

import numpy as np
import pytest
import torch

from hamgnn_tpu.e3 import fused_tp as j_fused
from hamgnn_tpu.e3 import irreps as j_irreps
from hamgnn_tpu.e3 import packed_tp as j_packed
from hamgnn_tpu.e3 import pallas_tp as j_pallas
from hamgnn_tpu.e3 import wigner as j_wigner
from hamgnn_tpu.models import basis as j_basis
from hamgnn_tpu.models import output as j_output
from hamgnn_tpu_torch.e3 import fused_tp as t_fused
from hamgnn_tpu_torch.e3 import irreps as t_irreps
from hamgnn_tpu_torch.e3 import packed_tp as t_packed
from hamgnn_tpu_torch.e3 import tp_kernel as t_kernel
from hamgnn_tpu_torch.e3 import wigner as t_wigner
from hamgnn_tpu_torch.models import basis as t_basis
from hamgnn_tpu_torch.models import output as t_output

BENCH_FEAT = "64x0e+32x0o+24x1o+12x1e+12x2e+6x2o+4x3o+4x3e+2x4e"
SK_FEAT = "64x0e+16x0o+24x1o+12x1e+16x2e+8x2o+8x3o+6x3e+4x4e+2x4o"
SH = "0e + 1o + 2e + 3o + 4e"
FEATS = [BENCH_FEAT, SK_FEAT]


def _combined(feat):
    return repr(t_irreps.Irreps([(2 * m, ir) for m, ir in t_irreps.Irreps(feat)]))


def _plan_keys():
    keys = []
    for feat in FEATS:
        f = repr(t_irreps.Irreps(feat))
        s = repr(t_irreps.Irreps(SH))
        keys += [("pair", ("96x0e", s, f, f)),
                 ("node", (_combined(feat), s, f, f)),
                 ("edge", (f, s, f, f))]
    return keys


PLAN_KEYS = _plan_keys()


@pytest.mark.parametrize("s", FEATS + [SH, "96x0e", "1x0e+1x0e+1x1o+2x1o+1x2e"])
def test_irreps_algebra(s):
    a, b = j_irreps.Irreps(s), t_irreps.Irreps(s)
    assert repr(a) == repr(b)
    assert a.dim == b.dim and a.num_irreps == b.num_irreps and a.lmax == b.lmax
    assert a.slices() == b.slices() and a.ls == b.ls
    assert repr(a.simplify()) == repr(b.simplify())
    sa, sb = a.sort(), b.sort()
    assert repr(sa[0]) == repr(sb[0]) and sa[1:] == sb[1:]
    ga, gb = j_irreps.irreps2gate(a), t_irreps.irreps2gate(b)
    assert [repr(x) for x in ga] == [repr(x) for x in gb]


@pytest.mark.parametrize("l1", range(5))
def test_wigner_3j_exact(l1):
    for l2 in range(5):
        for l3 in range(abs(l1 - l2), l1 + l2 + 1):
            np.testing.assert_array_equal(j_wigner.wigner_3j(l1, l2, l3),
                                          t_wigner.wigner_3j(l1, l2, l3))


@pytest.mark.parametrize("feat", FEATS)
def test_coupling_and_mid_irreps(feat):
    sh_key = tuple((mi.ir.l, mi.ir.p) for mi in t_irreps.Irreps(SH))
    t_key = tuple((mi.ir.l, mi.ir.p) for mi in t_irreps.Irreps(feat))
    for mi in t_irreps.Irreps(feat):
        Cj, gj = j_fused._coupling_tensor(mi.ir.l, mi.ir.p, sh_key, t_key)
        Ct, gt = t_fused._coupling_tensor(mi.ir.l, mi.ir.p, sh_key, t_key)
        np.testing.assert_array_equal(Cj, Ct)
        assert repr(gj) == repr(gt)
        Pj, hj = j_packed._packed_coupling(mi.ir.l, mi.ir.p, sh_key, t_key)
        Pt, ht = t_packed._packed_coupling(mi.ir.l, mi.ir.p, sh_key, t_key)
        np.testing.assert_array_equal(Pj, Pt)
        assert repr(hj) == repr(ht)
    for xin in (feat, _combined(feat)):
        assert repr(j_fused.SHTensorProductExpansion.mid_irreps(xin, SH, feat)) \
            == repr(t_fused.mid_irreps(xin, SH, feat))


@pytest.mark.parametrize("name,key", PLAN_KEYS, ids=[f"{n}{i // 3}" for i, (n, _) in enumerate(PLAN_KEYS)])
def test_packed_plan_tables(name, key):
    pj, pt = j_packed.get_plan(*key), t_packed.get_plan(*key)
    assert pj.key == pt.key
    assert pj.weight_numel == pt.weight_numel and pj.linear_numel == pt.linear_numel
    np.testing.assert_array_equal(pj.scale_perm, pt.scale_perm)
    assert pj.out_plans == pt.out_plans
    assert pj._grp_w_base == pt._grp_w_base
    assert len(pj.per_chunk) == len(pt.per_chunk)
    for (sa, ma, da, Ca, ga), (sb, mb, db, Cb, gb) in zip(pj.per_chunk, pt.per_chunk):
        assert (sa, ma, da) == (sb, mb, db) and repr(ga) == repr(gb)
        np.testing.assert_array_equal(Ca, Cb)
    for srcs_a, srcs_b in zip(pj.out_sources, pt.out_sources):
        assert [(g, gi) for g, gi, _ in srcs_a] == [(g, gi) for g, gi, _ in srcs_b]
        for (_, _, ra), (_, _, rb) in zip(srcs_a, srcs_b):
            np.testing.assert_array_equal(ra, rb)


@pytest.mark.parametrize("name,key", PLAN_KEYS[:3], ids=["pair", "node", "edge"])
def test_kernel_wcat_matches_pallas_spec(name, key):
    """The CUDA kernel's Wcat holds the Pallas spec's Wcat blocks without the
    TPU's 8-row alignment and V padding, bit for bit."""
    import jax.numpy as jnp

    plan = j_packed.get_plan(*key)
    js = j_pallas.PallasSpec(plan)
    ts = t_kernel.get_spec(t_packed.get_plan(*key))
    fw = np.random.default_rng(0).normal(size=plan.linear_numel).astype(np.float32)
    wj = np.asarray(js.build_wcat(jnp.asarray(fw)))
    wt = ts.build_wcat(torch.as_tensor(fw)).numpy()
    blocks = []
    for (k_out, b, d3, V, r0, fan_rows, sources, wb, fast) in js.sched:
        fan_in = plan.out_plans[k_out][0]
        blocks.append(wj[r0 : r0 + fan_in, :V].reshape(-1))
    np.testing.assert_array_equal(np.concatenate(blocks), wt)
    # the x elements the kernel's slabs gather (their compact x rows) are
    # those of the Pallas spec's m-major x permutation
    xs = set(ts.xmap.tolist())
    assert xs and xs <= set(js.x_perm.tolist())


@pytest.mark.parametrize("ham_type,nao", [("openmx", 13), ("openmx", 14), ("openmx", 19),
                                          ("openmx", 26), ("siesta", 13), ("siesta", 19),
                                          ("abacus", 13), ("abacus", 27), ("abacus", 40)])
def test_basis_and_merge_matrices(ham_type, nao):
    bj, bt = j_basis.get_basis_set(ham_type, nao), t_basis.get_basis_set(ham_type, nao)
    assert repr(bj.orbital_irreps) == repr(bt.orbital_irreps)
    assert bj.basis_def == bt.basis_def and bj.num_valence == bt.num_valence
    for attr in ("index_change", "minus_index"):
        a, b = getattr(bj, attr), getattr(bt, attr)
        assert (a is None and b is None) or np.array_equal(a, b)
    np.testing.assert_array_equal(bj.orbital_mask_table, bt.orbital_mask_table)
    np.testing.assert_array_equal(bj.num_orbital_table, bt.num_orbital_table)
    assert repr(j_basis.hamiltonian_irreps(bj)) == repr(t_basis.hamiltonian_irreps(bt))
    np.testing.assert_array_equal(j_output._merge_reorder_matrix(ham_type, nao),
                                  t_output._merge_reorder_matrix(ham_type, nao))
    np.testing.assert_array_equal(j_output._decompose_matrix(ham_type, nao),
                                  t_output._decompose_matrix(ham_type, nao))


@pytest.mark.parametrize("n_atoms,cutoff", [(4, 4.0), (12, 4.5), (24, 4.0)])
def test_synthetic_crystal_matches_fixture(n_atoms, cutoff):
    from util_fixtures import add_random_hamiltonian_targets, make_crystal

    from hamgnn_tpu_torch.data import synthetic

    a = add_random_hamiltonian_targets(
        np.random.default_rng(5), make_crystal(np.random.default_rng(3), n_atoms=n_atoms,
                                               cell_size=7.0, cutoff=cutoff), nao_max=19)
    b = synthetic.add_random_hamiltonian_targets(
        np.random.default_rng(5), synthetic.make_crystal(np.random.default_rng(3),
                                                         n_atoms=n_atoms, cell_size=7.0,
                                                         cutoff=cutoff), nao_max=19)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
