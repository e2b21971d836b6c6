"""The crystals of a shipped SK container example and its splits, on the host.

Draws the rattled structures of ``tools/sk_dataset.py`` for a teacher seed
again (the same ``RandomState`` draws in the same order, no file written)
and reports, crystal by crystal: its kind (si, c, sic), the shortest
distance of each species pair under periodic boundaries, the teacher's pair
cutoff and reference bond length for it (``SKTeacher._radial``: r0 = 0.45 x
the cutoff), the largest |H - H0| entry of its blocks (what the model learns
with ``add_H0``), and the split it falls in under ``data/dataset.py``
``reference_split`` with the example config's ratios.  The set's index of a
crystal is its ``struct_NNNN`` number, the order the packing tools read.

    python -m hamgnn_tpu_torch.tools_dev.sk_split_check --example sk_siesta --seed 7 \\
        --crystal 154

Prints one JSON object: per split the count of each kind and the SiC share,
the spread of each SiC crystal's shortest Si-C distance and largest |dH|
per split, and the named crystal's row with its rank among the SiC crystals.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..data.dataset import reference_split
from ..data.neighborlist import neighbor_list_pbc
from ..tools.sk_dataset import (A_C, A_SI, A_SIC, AU2ANG, PAO_RADIUS, SKTeacher,
                                _fcc_primitive, rattled)
from .sk_examples import EXAMPLES

SPLIT_RATIOS = (0.6, 0.2, 0.2)   # every shipped SK config's train / val / test ratios
KINDS = ("si", "c", "sic")


def structures(seed: int, sizes) -> Iterator[Tuple[str, np.ndarray, np.ndarray, np.ndarray]]:
    """(kind, cell, pos, z) of each crystal ``tools/sk_dataset.py`` writes
    with ``--seed seed`` and ``--n-si/--n-c/--n-sic sizes``, in its order
    (Bohr)."""
    protos = {"si": _fcc_primitive(A_SI, 14, 14), "c": _fcc_primitive(A_C, 6, 6),
              "sic": _fcc_primitive(A_SIC, 14, 6)}
    rng = np.random.RandomState(seed + 1)
    for kind, count in zip(KINDS, sizes):
        for _ in range(count):
            yield (kind, *rattled(rng, protos[kind]))


def crystal_rows(example: str, seed: int, sizes=None) -> List[Dict]:
    """One row a crystal of ``example``'s set at teacher seed ``seed``, in
    the set's order (``sizes``: the example's own by default)."""
    ex = EXAMPLES[example]
    if ex.data != "container":
        raise ValueError(f"{example} is not a container set")
    flags = list(ex.flags)
    nao = int(flags[flags.index("--nao-max") + 1]) if "--nao-max" in flags else 14
    teacher = SKTeacher(ham_type=ex.fmt, nao_max=nao, seed=seed)
    rows = []
    for kind, cell, pos, z in structures(seed, sizes or ex.sizes):
        radii = np.array([PAO_RADIUS[int(v)] for v in z])
        (src, dst), _, shift = neighbor_list_pbc(pos, cell, radii)
        r = np.linalg.norm(pos[dst] + shift - pos[src], axis=1)
        shortest = {}
        for a, b in ((14, 6), (14, 14), (6, 6)):
            pair = ((z[src] == a) & (z[dst] == b)) | ((z[src] == b) & (z[dst] == a))
            if pair.any():
                cut = PAO_RADIUS[a] + PAO_RADIUS[b]
                shortest[f"{a}-{b}"] = {"r_ang": float(r[pair].min() * AU2ANG),
                                        "cutoff_ang": float(cut * AU2ANG),
                                        "r0_ang": float(0.45 * cut * AU2ANG)}
        blocks = teacher.build(z, pos, cell)
        dh = max(float(np.abs(h - h0).max())
                 for key in ("on", "off")
                 for h, h0 in zip(blocks[f"H{key}"], blocks[f"H0{key}"]))
        rows.append({"index": len(rows), "kind": kind, "edges": int(len(src)),
                     "shortest": shortest, "max_abs_dH_Ha": dh})
    return rows


def report(example: str, seed: int, crystal: int, sizes=None) -> Dict:
    rows = crystal_rows(example, seed, sizes)
    splits = dict(zip(("train", "val", "test"), reference_split(len(rows), *SPLIT_RATIOS)))
    for name, idx in splits.items():
        for i in idx:
            rows[i]["split"] = name
    sic = [r for r in rows if r["kind"] == "sic"]

    def spread(vals):
        vals = np.asarray(vals, np.float64)
        return {"min": float(vals.min()), "median": float(np.median(vals)),
                "max": float(vals.max())} if vals.size else None

    per_split = {}
    for name, idx in splits.items():
        counts = {k: sum(rows[i]["kind"] == k for i in idx) for k in KINDS}
        s = [r for r in sic if r["split"] == name]
        per_split[name] = {
            "crystals": len(idx), "counts": counts, "sic_share": counts["sic"] / len(idx),
            "sic_shortest_si_c_ang": spread([r["shortest"]["14-6"]["r_ang"] for r in s]),
            "sic_max_abs_dH_Ha": spread([r["max_abs_dH_Ha"] for r in s])}
    row = rows[crystal]
    out = {"example": example, "seed": seed, "crystals": len(rows), "splits": per_split,
           "crystal": row}
    if row["kind"] == "sic":
        by_r = sorted(sic, key=lambda r: r["shortest"]["14-6"]["r_ang"])
        by_dh = sorted(sic, key=lambda r: -r["max_abs_dH_Ha"])
        out["crystal_rank_among_sic"] = {
            "shortest_si_c_ascending": [r["index"] for r in by_r].index(crystal) + 1,
            "max_abs_dH_descending": [r["index"] for r in by_dh].index(crystal) + 1,
            "of": len(sic)}
        out["sic_shorter_than_it"] = [
            {"index": r["index"], "split": r["split"],
             "r_ang": r["shortest"]["14-6"]["r_ang"], "max_abs_dH_Ha": r["max_abs_dH_Ha"]}
            for r in by_r[:by_r.index(row)]]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--example", default="sk_siesta")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--crystal", type=int, default=154)
    args = ap.parse_args(argv)
    print(json.dumps(report(args.example, args.seed, args.crystal)))


if __name__ == "__main__":
    main()
