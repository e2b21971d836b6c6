"""``tools_dev/sk_split_check.py``: the structures it draws again are the
ones ``tools/sk_dataset.py`` writes, and its report of a small set."""

import numpy as np


def test_structures_are_the_ones_the_teacher_writes(tmp_path, monkeypatch):
    from hamgnn_tpu_torch.tools import sk_dataset
    from hamgnn_tpu_torch.tools_dev.sk_split_check import structures

    written = []
    monkeypatch.setattr(sk_dataset, "write_structure_dir_siesta",
                        lambda d, teacher, z, pos, cell: written.append((z, pos, cell)))
    sk_dataset.main(["--out", str(tmp_path / "set"), "--seed", "7", "--format", "siesta",
                     "--nao-max", "19", "--n-si", "2", "--n-c", "1", "--n-sic", "2"])
    drawn = list(structures(7, (2, 1, 2)))
    assert [k for k, *_ in drawn] == ["si", "si", "c", "sic", "sic"]
    assert len(written) == len(drawn)
    for (z, pos, cell), (_, cell2, pos2, z2) in zip(written, drawn):
        assert np.array_equal(z, z2) and np.array_equal(pos, pos2) and np.array_equal(cell, cell2)


def test_report_of_a_small_set():
    from hamgnn_tpu_torch.tools_dev.sk_split_check import report

    out = report("sk_siesta", 7, crystal=4, sizes=(2, 1, 2))
    assert out["crystals"] == 5
    assert sum(s["crystals"] for s in out["splits"].values()) == 5
    assert sum(s["counts"]["sic"] for s in out["splits"].values()) == 2
    row = out["crystal"]
    assert row["kind"] == "sic" and set(row["shortest"]) == {"14-6", "14-14", "6-6"}
    si_c = row["shortest"]["14-6"]
    assert 0 < si_c["r0_ang"] < si_c["cutoff_ang"] and 1.0 < si_c["r_ang"] < si_c["cutoff_ang"]
    assert row["max_abs_dH_Ha"] > 0
    assert out["crystal_rank_among_sic"]["of"] == 2
