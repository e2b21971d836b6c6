"""band_cal_parallel: the batched band solver for large systems, counterpart
of ``hamgnn_tpu/tools/band_cal_parallel.py``.

    python -m hamgnn_tpu_torch.tools.band_cal_parallel --config band_cal_parallel.yaml [--device cpu]

It takes the place of the reference's MPI program (``mpirun
band_cal_parallel``): the k-point loop becomes a batched Cholesky-reduced
Hermitian eigensolve on the card, ``k_batch`` k-points per solve, in
complex64 as the JAX package solves it.  H(k) and S(k) are assembled on the
host (``tools/band_cal.py``).  No TPU kernel lies on this path: the solve is
``torch.linalg`` (cuSOLVER on the card).

Same YAML as band_cal (nao_max, graph_data_path, hamiltonian_path, nk,
save_dir, Ham_type, k_path); extra key: ``k_batch``.  Where the JAX package
shards the k batch over a device mesh, ``solve_bands_batched`` takes a
``torch.distributed`` process group: each rank solves its share of every
k batch and the eigenvalues are gathered on every rank.  Under a launcher
(``torchrun --nproc_per_node <cards> -m hamgnn_tpu_torch.tools.band_cal_parallel``)
the CLI solves over the world, each rank on ``cuda:LOCAL_RANK``, and rank 0
writes the files.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist
import yaml

from .. import resolve_device
from ..models.basis import get_basis_set
from .band_cal import HARTREE2EV, _auto_k_path, assemble_k_matrices_numpy


def _batched_geig(HK: torch.Tensor, SK: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of the pencils (H, S): S = L L^H, A = L^-1 H L^-H."""
    L = torch.linalg.cholesky(SK)
    Hh = torch.linalg.solve_triangular(L, HK, upper=False)
    A = torch.linalg.solve_triangular(
        L, Hh.transpose(-1, -2).conj(), upper=False).transpose(-1, -2).conj()
    A = 0.5 * (A + A.transpose(-1, -2).conj())
    return torch.linalg.eigvalsh(A)


def solve_bands_batched(HK: np.ndarray, SK: np.ndarray, k_batch: int = 32,
                        group=None, device=None) -> np.ndarray:
    """Generalized eigenvalues for (nk, n, n) Hermitian pairs, ``k_batch``
    k-points per solve on ``device`` (cuda unless the caller asks for the
    CPU).  ``group``: a ``torch.distributed`` process group over which each
    k batch is split; a batch is padded with copies of its last k-point to a
    multiple of the group's size, as the JAX package pads it for its mesh,
    and every rank returns all the eigenvalues."""
    if group is not None and not isinstance(group, dist.ProcessGroup):
        raise TypeError("group: a torch.distributed process group (the port's "
                        f"counterpart of the JAX mesh), not {type(group).__name__}")
    dev = resolve_device(device)
    nk = HK.shape[0]
    out = []
    for s in range(0, nk, k_batch):
        hk = HK[s : s + k_batch].astype(np.complex64)
        sk = SK[s : s + k_batch].astype(np.complex64)
        if group is None:
            ev = _batched_geig(torch.as_tensor(hk, device=dev), torch.as_tensor(sk, device=dev))
            out.append(ev.cpu().numpy())
            continue
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        pad = (-len(hk)) % size
        if pad:
            hk = np.concatenate([hk, np.tile(hk[-1:], (pad, 1, 1))])
            sk = np.concatenate([sk, np.tile(sk[-1:], (pad, 1, 1))])
        share = len(hk) // size
        mine = slice(rank * share, (rank + 1) * share)
        ev = _batched_geig(torch.as_tensor(hk[mine], device=dev),
                           torch.as_tensor(sk[mine], device=dev)).contiguous()
        parts = [torch.empty_like(ev) for _ in range(size)]
        dist.all_gather(parts, ev, group=group)
        ev = torch.cat(parts).cpu().numpy()
        out.append(ev[: len(ev) - pad] if pad else ev)
    return np.concatenate(out)


def main(argv=None):
    from ..data.dataset import load_graph_npz
    from ..physics.kpoints import k_path as make_k_path

    parser = argparse.ArgumentParser(description="parallel band calculation")
    parser.add_argument("--config", default="band_cal_parallel.yaml", type=str)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    with open(args.config, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    from ..parallel.multihost import is_primary, local_device, maybe_initialize_distributed

    device = args.device
    group = None
    if maybe_initialize_distributed(device=device):
        # under a launcher: the k batches split over the world
        device = local_device(device)
        group = dist.group.WORLD
    primary = is_primary()

    nao = cfg["nao_max"]
    basis = get_basis_set(cfg.get("Ham_type", "openmx").lower(), nao)
    save_dir = cfg["save_dir"]
    if primary:
        os.makedirs(save_dir, exist_ok=True)
    nk = cfg["nk"]
    k_batch = cfg.get("k_batch", 32)

    graphs = load_graph_npz(cfg["graph_data_path"])
    ham_path = cfg.get("hamiltonian_path")
    H_flat = np.load(ham_path) if ham_path else None

    ofs = 0
    for idx, c in enumerate(graphs):
        z = np.asarray(c["z"], int)
        n = len(z)
        e = np.asarray(c["edge_index"]).shape[1]
        h_rows = (H_flat[ofs : ofs + n + e] if H_flat is not None
                  else np.concatenate([c["Hon"], c["Hoff"]]))
        ofs += n + e
        s_rows = np.concatenate([np.asarray(c["Son"]), np.asarray(c["Soff"])])

        cell = np.asarray(c["cell"]).reshape(3, 3)
        nodes = cfg.get("k_path") or _auto_k_path(cell)[0]
        k_frac, k_dist, k_node, lat_inv = make_k_path(nodes, nk, cell)
        k_cart = k_frac @ lat_inv

        table = basis.orbital_mask_table
        valid = np.concatenate([table[zi] > 0 for zi in z])
        HK = assemble_k_matrices_numpy(
            h_rows, n, np.asarray(c["edge_index"], int),
            np.asarray(c["nbr_shift"], float), k_cart, nao, valid)
        SK = assemble_k_matrices_numpy(
            s_rows, n, np.asarray(c["edge_index"], int),
            np.asarray(c["nbr_shift"], float), k_cart, nao, valid)
        bands = solve_bands_batched(HK, SK, k_batch=k_batch, group=group,
                                    device=device) * HARTREE2EV
        if primary:
            np.savez(os.path.join(save_dir, f"bands_{idx}.npz"),
                     k_dist=k_dist, k_node=k_node, bands=bands)
            print(f"[{idx}] solved {bands.shape} bands")


if __name__ == "__main__":
    main()
