"""k-path generation for band-structure calculations (host-side numpy), the
port's own copy of ``hamgnn_tpu/physics/kpoints.py`` (tested element-exact
against it).

Given high-symmetry nodes in reduced coordinates and a total point count,
points are distributed along the segments in proportion to their Cartesian
reciprocal-space length (the pythTB-style ``k_path`` of the reference).
Returns reduced k-vectors plus the Cartesian transform (reciprocal lattice),
matching how the output head converts k to Cartesian before the phase
factors (``k_vec @ lat_per_inv``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def reciprocal_lattice(lat: np.ndarray) -> np.ndarray:
    """Rows are reciprocal vectors WITHOUT the 2*pi factor: inv(lat).T."""
    return np.linalg.inv(lat).T


def k_path(nodes: Sequence[Sequence[float]], nk: int, lat: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Interpolate a k-path through ``nodes`` (reduced coords).

    Returns (k_vec (nk,3) reduced, k_dist (nk,), k_node (n_nodes,), lat_per_inv).
    """
    nodes = np.asarray(nodes, dtype=float)
    n_nodes = nodes.shape[0]
    lat_per_inv = reciprocal_lattice(np.asarray(lat, dtype=float))
    # metric for distances in reduced coordinates
    k_metric = lat_per_inv @ lat_per_inv.T

    k_node = np.zeros(n_nodes)
    for n in range(1, n_nodes):
        dk = nodes[n] - nodes[n - 1]
        k_node[n] = k_node[n - 1] + float(np.sqrt(dk @ k_metric @ dk))

    node_index = [0]
    for n in range(1, n_nodes - 1):
        frac = k_node[n] / max(k_node[-1], 1e-30)
        node_index.append(int(round(frac * (nk - 1))))
    node_index.append(nk - 1)

    k_dist = np.zeros(nk)
    k_vec = np.zeros((nk, 3))
    k_vec[0] = nodes[0]
    for n in range(1, n_nodes):
        n_i, n_f = node_index[n - 1], node_index[n]
        kd_i, kd_f = k_node[n - 1], k_node[n]
        k_i, k_f = nodes[n - 1], nodes[n]
        for j in range(n_i, n_f + 1):
            frac = (j - n_i) / max(n_f - n_i, 1)
            k_dist[j] = kd_i + frac * (kd_f - kd_i)
            k_vec[j] = k_i + frac * (k_f - k_i)
    return k_vec, k_dist, k_node, lat_per_inv


def k_path_cartesian(nodes, nk: int, lat: np.ndarray) -> np.ndarray:
    """Convenience: reduced path -> Cartesian k (units 1/length, no 2*pi)."""
    k_vec, _, _, lat_per_inv = k_path(nodes, nk, lat)
    return k_vec @ lat_per_inv


def random_k_cartesian(rng, nk: int, lat: np.ndarray) -> np.ndarray:
    """Reference fallback: uniform reduced k in (-1, 1), to Cartesian."""
    k_vec = 2.0 * rng.random((nk, 3)) - 1.0
    return k_vec @ reciprocal_lattice(np.asarray(lat, dtype=float))


def k_vecs_for_graph(graph, num_k: int, k_path_spec=None, rng=None) -> np.ndarray:
    """Per-crystal Cartesian k-point batches (B, num_k, 3) for band training.

    Mirrors the reference's in-forward k generation: a user k-path list is
    interpolated per crystal; otherwise uniform random reduced k in (-1, 1)
    drawn from ``rng``.  Host-side data prep: the cells as ``pad_and_batch``
    collated them (``graph.cell_host``), else read from ``graph.cell``.
    """
    rng = rng or np.random.default_rng(0)
    cells = getattr(graph, "cell_host", None)
    if cells is None:
        cell = graph.cell
        cells = np.asarray(cell.cpu() if hasattr(cell, "cpu") else cell)
    out = []
    for b in range(cells.shape[0]):
        lat = cells[b]
        if isinstance(k_path_spec, str) and k_path_spec.lower() == "auto":
            nodes, _ = auto_k_path(lat)
            out.append(k_path_cartesian(nodes, num_k, lat))
        elif isinstance(k_path_spec, (list, tuple)) and len(k_path_spec) >= 2:
            out.append(k_path_cartesian(k_path_spec, num_k, lat))
        else:
            out.append(random_k_cartesian(rng, num_k, lat))
    return np.stack(out).astype(np.float32)


# ---------------------------------------------------------------------------
# Automatic high-symmetry paths (the reference calls pymatgen's KPathSeek for
# k_path 'auto').  Without spglib/pymatgen the lattice is classified from the
# primitive-cell metric (lengths + pairwise dots, tolerance-based) and mapped
# to the standard Setyawan-Curtarolo path for that Bravais type
# (Comput. Mater. Sci. 49, 299 (2010)).  Covered: CUB, FCC, BCC, TET, BCT1/2,
# ORC, ORCF1/2, ORCI, ORCC, HEX, RHL1/2, MCL, TRI.  C-centered monoclinic
# primitive cells (MCLC) and anything unrecognized fall back to a generic
# path with a logged warning (never silently).
#
# Reduced coordinates are emitted in the *given* cell's basis: when the cell
# rows are a (signed) permutation of the Setyawan-Curtarolo convention, the
# same permutation is applied to the k-point components (reduced coordinates
# co-transform with their basis vectors).
# ---------------------------------------------------------------------------

_SC_POINTS = {
    "CUB": {"G": (0, 0, 0), "X": (0, 0.5, 0), "M": (0.5, 0.5, 0),
            "R": (0.5, 0.5, 0.5)},
    "FCC": {"G": (0, 0, 0), "X": (0.5, 0, 0.5), "W": (0.5, 0.25, 0.75),
            "K": (0.375, 0.375, 0.75), "L": (0.5, 0.5, 0.5),
            "U": (0.625, 0.25, 0.625)},
    "BCC": {"G": (0, 0, 0), "H": (0.5, -0.5, 0.5), "P": (0.25, 0.25, 0.25),
            "N": (0, 0, 0.5)},
    "TET": {"G": (0, 0, 0), "X": (0, 0.5, 0), "M": (0.5, 0.5, 0),
            "Z": (0, 0, 0.5), "R": (0, 0.5, 0.5), "A": (0.5, 0.5, 0.5)},
    "ORC": {"G": (0, 0, 0), "X": (0.5, 0, 0), "S": (0.5, 0.5, 0),
            "Y": (0, 0.5, 0), "Z": (0, 0, 0.5), "U": (0.5, 0, 0.5),
            "R": (0.5, 0.5, 0.5), "T": (0, 0.5, 0.5)},
    "HEX": {"G": (0, 0, 0), "M": (0.5, 0, 0), "K": (1 / 3, 1 / 3, 0),
            "A": (0, 0, 0.5), "L": (0.5, 0, 0.5), "H": (1 / 3, 1 / 3, 0.5)},
    "TRI": {"G": (0, 0, 0), "L": (0.5, 0.5, 0), "M": (0, 0.5, 0.5),
            "N": (0.5, 0, 0.5), "R": (0.5, 0.5, 0.5), "X": (0.5, 0, 0),
            "Y": (0, 0.5, 0), "Z": (0, 0, 0.5)},
    "GEN": {"G": (0, 0, 0), "X": (0.5, 0, 0), "Y": (0, 0.5, 0),
            "Z": (0, 0, 0.5), "R": (0.5, 0.5, 0.5)},
}

_SC_PATHS = {
    "CUB": ["G", "X", "M", "G", "R", "X"],
    "FCC": ["G", "X", "W", "K", "G", "L", "U", "W", "L", "K"],
    "BCC": ["G", "H", "N", "G", "P", "H"],
    "TET": ["G", "X", "M", "G", "Z", "R", "A", "Z"],
    "ORC": ["G", "X", "S", "Y", "G", "Z", "U", "R", "T", "Z"],
    "HEX": ["G", "M", "K", "G", "A", "L", "H", "A"],
    "TRI": ["X", "G", "Y", "L", "G", "Z", "N", "G", "M", "R", "G"],
    "GEN": ["G", "X", "G", "Y", "G", "Z", "R", "G"],
}


def _param_points(kind: str, p):
    """Setyawan-Curtarolo point tables with lattice-parameter-dependent
    coordinates.  ``p`` carries the derived conventional parameters."""
    if kind == "BCT1":  # c < a; eta = (1 + c^2/a^2)/4
        eta = (1 + p["c2"] / p["a2"]) / 4
        pts = {"G": (0, 0, 0), "M": (-0.5, 0.5, 0.5), "N": (0, 0.5, 0),
               "P": (0.25, 0.25, 0.25), "X": (0, 0, 0.5),
               "Z": (eta, eta, -eta), "Z1": (-eta, 1 - eta, eta)}
        path = ["G", "X", "M", "G", "Z", "P", "N", "Z1", "M"]
        return pts, path
    if kind == "BCT2":  # c > a
        eta = (1 + p["a2"] / p["c2"]) / 4
        zeta = p["a2"] / (2 * p["c2"])
        pts = {"G": (0, 0, 0), "N": (0, 0.5, 0), "P": (0.25, 0.25, 0.25),
               "S": (-eta, eta, eta), "S1": (eta, 1 - eta, -eta),
               "X": (0, 0, 0.5), "Y": (-zeta, zeta, 0.5),
               "Y1": (0.5, 0.5, -zeta), "Z": (0.5, 0.5, -0.5)}
        path = ["G", "X", "Y", "S", "G", "Z", "S1", "N", "P", "Y1", "Z"]
        return pts, path
    if kind == "ORCF1":  # 1/a^2 >= 1/b^2 + 1/c^2 (ORCF3 at equality)
        a2, b2, c2 = p["a2"], p["b2"], p["c2"]
        zeta = (1 + a2 / b2 - a2 / c2) / 4
        eta = (1 + a2 / b2 + a2 / c2) / 4
        pts = {"G": (0, 0, 0), "A": (0.5, 0.5 + zeta, zeta),
               "A1": (0.5, 0.5 - zeta, 1 - zeta), "L": (0.5, 0.5, 0.5),
               "T": (1, 0.5, 0.5), "X": (0, eta, eta),
               "X1": (1, 1 - eta, 1 - eta), "Y": (0.5, 0, 0.5),
               "Z": (0.5, 0.5, 0)}
        path = ["G", "Y", "T", "Z", "G", "X", "A1", "Y", "L", "G"]
        return pts, path
    if kind == "ORCF2":  # 1/a^2 < 1/b^2 + 1/c^2
        a2, b2, c2 = p["a2"], p["b2"], p["c2"]
        eta = (1 + a2 / b2 - a2 / c2) / 4
        delta = (1 + b2 / a2 - b2 / c2) / 4
        phi = (1 + c2 / b2 - c2 / a2) / 4
        pts = {"G": (0, 0, 0), "C": (0.5, 0.5 - eta, 1 - eta),
               "C1": (0.5, 0.5 + eta, eta), "D": (0.5 - delta, 0.5, 1 - delta),
               "D1": (0.5 + delta, 0.5, delta), "L": (0.5, 0.5, 0.5),
               "H": (1 - phi, 0.5 - phi, 0.5), "H1": (phi, 0.5 + phi, 0.5),
               "X": (0, 0.5, 0.5), "Y": (0.5, 0, 0.5), "Z": (0.5, 0.5, 0)}
        path = ["G", "Y", "C", "D", "X", "G", "Z", "D1", "H", "C", "L", "G"]
        return pts, path
    if kind == "ORCI":
        a2, b2, c2 = p["a2"], p["b2"], p["c2"]
        zeta = (1 + a2 / c2) / 4
        eta = (1 + b2 / c2) / 4
        delta = (b2 - a2) / (4 * c2)
        mu = (a2 + b2) / (4 * c2)
        pts = {"G": (0, 0, 0), "L": (-mu, mu, 0.5 - delta),
               "L1": (mu, -mu, 0.5 + delta), "L2": (0.5 - delta, 0.5 + delta, -mu),
               "R": (0, 0.5, 0), "S": (0.5, 0, 0), "T": (0, 0, 0.5),
               "W": (0.25, 0.25, 0.25), "X": (-zeta, zeta, zeta),
               "X1": (zeta, 1 - zeta, -zeta), "Y": (eta, -eta, eta),
               "Y1": (1 - eta, eta, -eta), "Z": (0.5, 0.5, -0.5)}
        path = ["G", "X", "L", "T", "W", "R", "X1", "Z", "G", "Y", "S", "W"]
        return pts, path
    if kind == "ORCC":  # a < b convention
        zeta = (1 + p["a2"] / p["b2"]) / 4
        pts = {"G": (0, 0, 0), "A": (zeta, zeta, 0.5),
               "A1": (-zeta, 1 - zeta, 0.5), "R": (0, 0.5, 0.5),
               "S": (0, 0.5, 0), "T": (-0.5, 0.5, 0.5), "X": (zeta, zeta, 0),
               "X1": (-zeta, 1 - zeta, 0), "Y": (-0.5, 0.5, 0),
               "Z": (0, 0, 0.5)}
        path = ["G", "X", "S", "R", "A", "Z", "G", "Y", "X1", "A1", "T", "Y"]
        return pts, path
    if kind == "RHL1":  # alpha < 90
        ca = p["cosa"]
        eta = (1 + 4 * ca) / (2 + 4 * ca)
        nu = 0.75 - eta / 2
        pts = {"G": (0, 0, 0), "B": (eta, 0.5, 1 - eta),
               "B1": (0.5, 1 - eta, eta - 1), "F": (0.5, 0.5, 0),
               "L": (0.5, 0, 0), "L1": (0, 0, -0.5), "P": (eta, nu, nu),
               "P1": (1 - nu, 1 - nu, 1 - eta), "P2": (nu, nu, eta - 1),
               "Q": (1 - nu, nu, 0), "X": (nu, 0, -nu), "Z": (0.5, 0.5, 0.5)}
        path = ["G", "L", "B1", "B", "Z", "G", "X", "Q", "F", "P1", "Z", "L", "P"]
        return pts, path
    if kind == "RHL2":  # alpha > 90
        ca = p["cosa"]
        # eta = 1/(2 tan^2(alpha/2)); tan^2(a/2) = (1-cos a)/(1+cos a)
        eta = (1 + ca) / (2 * (1 - ca))
        nu = 0.75 - eta / 2
        pts = {"G": (0, 0, 0), "F": (0.5, -0.5, 0), "L": (0.5, 0, 0),
               "P": (1 - nu, -nu, 1 - nu), "P1": (nu, nu - 1, nu - 1),
               "Q": (eta, eta, eta), "Q1": (1 - eta, -eta, -eta),
               "Z": (0.5, -0.5, 0.5)}
        path = ["G", "P", "Z", "Q", "G", "F", "P1", "Q1", "L", "Z"]
        return pts, path
    if kind == "MCL":  # a, b <= c, alpha < 90 between b and c
        b, c, ca = p["b"], p["c"], p["cosa"]
        sa2 = 1 - ca * ca
        eta = (1 - b * ca / c) / (2 * sa2)
        nu = 0.5 - eta * c * ca / b
        pts = {"G": (0, 0, 0), "A": (0.5, 0.5, 0), "C": (0, 0.5, 0.5),
               "D": (0.5, 0, 0.5), "D1": (0.5, 0, -0.5), "E": (0.5, 0.5, 0.5),
               "H": (0, eta, 1 - nu), "H1": (0, 1 - eta, nu),
               "H2": (0, eta, -nu), "M": (0.5, eta, 1 - nu),
               "M1": (0.5, 1 - eta, nu), "M2": (0.5, eta, -nu),
               "X": (0, 0.5, 0), "Y": (0, 0, 0.5), "Y1": (0, 0, -0.5),
               "Z": (0.5, 0, 0)}
        path = ["G", "Y", "H", "C", "E", "M1", "A", "X", "H1", "M", "D", "Z",
                "Y", "D"]
        return pts, path
    raise KeyError(kind)


def _perm_matrix(order):
    """P with rows of the new basis = old rows permuted by ``order``:
    new[i] = old[order[i]]."""
    P = np.zeros((3, 3))
    for i, j in enumerate(order):
        P[i, j] = 1.0
    return P


def classify_bravais(cell: np.ndarray, tol: float = 1e-3) -> str:
    """Bravais type of a *primitive* cell from its metric (public API;
    the full classification with derived parameters is internal)."""
    kind, _, _ = _classify_full(cell, tol)
    return kind


def _classify_full(cell: np.ndarray, tol: float = 1e-3):
    """(kind, params, P): Setyawan-Curtarolo lattice kind, derived
    conventional parameters, and the permutation P such that
    ``P @ cell`` rows follow the S-C axis convention (k-points are emitted as
    ``k_sc @ P`` to return to the given basis)."""
    cell = np.asarray(cell, float).reshape(3, 3)
    lengths = np.linalg.norm(cell, axis=1)
    dots = np.array([cell[1] @ cell[2], cell[0] @ cell[2], cell[0] @ cell[1]])
    cos = dots / np.array([lengths[1] * lengths[2],
                           lengths[0] * lengths[2],
                           lengths[0] * lengths[1]])
    I3 = np.eye(3)

    def eq(x, y):
        return abs(x - y) < tol * max(abs(x), abs(y), 1.0)

    len_eq = [eq(lengths[0], lengths[1]), eq(lengths[0], lengths[2]),
              eq(lengths[1], lengths[2])]
    right = np.abs(cos) < tol

    # --- all lengths equal ------------------------------------------------
    if all(len_eq):
        if right.all():
            return "CUB", {}, I3
        if np.all(np.abs(cos - 0.5) < tol):
            return "FCC", {}, I3
        if np.all(np.abs(cos + 1 / 3) < tol):
            return "BCC", {}, I3
        if eq(cos[0], cos[1]) and eq(cos[1], cos[2]):
            kind = "RHL1" if cos[0] > 0 else "RHL2"
            return kind, {"cosa": float(cos[0])}, I3
        # two equal dots -> BCT: the distinguished (tetragonal) primitive
        # vector is the one appearing in BOTH equal dots; dots index i pairs
        # the two vectors != i, so the odd dot's index IS the distinguished
        # vector
        d = dots
        pairs_eq = [eq(d[0], d[1]), eq(d[0], d[2]), eq(d[1], d[2])]
        if any(pairs_eq):
            # odd index: the dot not in the equal pair
            odd = [2, 1, 0][pairs_eq.index(True)]
            c2 = -4.0 * d[[i for i in range(3) if i != odd][0]]
            a2 = (c2 - 4.0 * d[odd]) / 2.0
            if c2 > tol and a2 > tol:
                order = [i for i in range(3) if i != odd] + [odd]
                P = _perm_matrix(order)
                kind = "BCT1" if c2 < a2 else "BCT2"
                return kind, {"a2": a2, "c2": c2}, P
        # three distinct dots, all lengths equal -> ORCI
        s = [-2.0 * (d[1] + d[2]), -2.0 * (d[0] + d[2]), -2.0 * (d[0] + d[1])]
        # s[i] = (conventional axis associated with primitive vector i)^2
        if all(v > tol for v in s):
            order = list(np.argsort(s))
            P = _perm_matrix(order)
            a2, b2, c2 = sorted(s)
            return "ORCI", {"a2": a2, "b2": b2, "c2": c2}, P

    # --- hexagonal: two equal axes at 120/60 deg, third orthogonal --------
    for k in range(3):
        i, j = [x for x in range(3) if x != k]
        # cos index m is the angle NOT involving axis m -> angle(i,j) = cos[k]
        if (eq(lengths[i], lengths[j]) and abs(cos[i]) < tol
                and abs(cos[j]) < tol and abs(abs(cos[k]) - 0.5) < tol):
            return "HEX", {}, _perm_matrix([i, j, k])

    # --- all right angles: TET / ORC --------------------------------------
    if right.all():
        if all(len_eq):
            return "CUB", {}, I3
        if any(len_eq):
            # unique axis to position 3 (c)
            uniq = [2, 1, 0][len_eq.index(True)]
            i, j = [x for x in range(3) if x != uniq]
            return "TET", {}, _perm_matrix([i, j, uniq])
        order = list(np.argsort(lengths))
        return "ORC", {}, _perm_matrix(order)

    # --- exactly one non-right angle --------------------------------------
    if int(right.sum()) == 2:
        ang = int(np.argmin(right))   # cos[ang] is the non-right one
        i, j = [x for x in range(3) if x != ang]   # the two angled axes
        if eq(lengths[i], lengths[j]):
            # ORCC primitive: centered pair (equal lengths) spans the angle,
            # third axis (= conventional c) orthogonal
            l2 = float(lengths[i] ** 2)
            d = float(cell[i] @ cell[j])
            a2 = 2.0 * (l2 + d)
            b2 = 2.0 * (l2 - d)
            if a2 > tol and b2 > tol:
                if a2 > b2:
                    a2, b2 = b2, a2   # S-C convention a < b (see E(k)=E(-k)
                    # note in the module docstring: component sign flips map
                    # to time-reversal-equivalent points)
                return "ORCC", {"a2": a2, "b2": b2}, _perm_matrix([i, j, ang])
        # MCL: S-C convention puts the angled pair as (b, c) with b <= c and
        # alpha < 90; axis 'ang' (orthogonal to both) becomes a
        bi, ci = (i, j) if lengths[i] <= lengths[j] else (j, i)
        ca = float(cell[bi] @ cell[ci] / (lengths[bi] * lengths[ci]))
        P = _perm_matrix([ang, bi, ci])
        if ca < 0:
            # flip c to make alpha < 90 (k_c sign flip: time-reversal pair)
            P[2] = -P[2]
            ca = -ca
        return "MCL", {"b": float(lengths[bi]), "c": float(lengths[ci]),
                       "cosa": ca}, P

    # --- ORCF: all-positive dots with |a_i|^2 = sum of its two dots
    # (primitive a1=(0,b/2,c/2) etc.: conventional axis i pairs with dots[i])
    if (dots > tol).all():
        consistent = all(
            eq(float(lengths[i] ** 2), float(dots[(i + 1) % 3] + dots[(i + 2) % 3]))
            for i in range(3))
        if consistent:
            s = [4.0 * float(d) for d in dots]   # (a^2, b^2, c^2) per axis
            order = list(np.argsort(s))
            P = _perm_matrix(order)
            a2, b2, c2 = sorted(s)
            kind = "ORCF1" if 1.0 / a2 >= 1.0 / b2 + 1.0 / c2 - tol else "ORCF2"
            return kind, {"a2": a2, "b2": b2, "c2": c2}, P

    # --- two equal lengths + two equal cosines: likely MCLC (C-centered
    # monoclinic primitive) — S-C variant logic not implemented; warn in
    # auto_k_path via the GEN fallback
    if any(len_eq):
        return "GEN", {}, I3

    # --- triclinic --------------------------------------------------------
    return "TRI", {}, I3


def auto_k_path(cell: np.ndarray, tol: float = 1e-3
                ) -> Tuple[List[List[float]], List[str]]:
    """(nodes, labels) of the automatic high-symmetry path for ``cell``."""
    kind, params, P = _classify_full(cell, tol)
    if kind == "GEN":
        import warnings

        warnings.warn(
            "auto k-path: primitive cell not classified as a covered "
            "Setyawan-Curtarolo Bravais type (likely C-centered monoclinic); "
            "using a generic path. Supply an explicit k_path for "
            "high-symmetry bands.", stacklevel=2)
    if kind in _SC_POINTS:
        pts, path = _SC_POINTS[kind], _SC_PATHS[kind]
    else:
        pts, path = _param_points(kind, params)
    nodes = [list(np.asarray(pts[p], float) @ P) for p in path]
    labels = ["$\\Gamma$" if p == "G" else p for p in path]
    return nodes, labels
