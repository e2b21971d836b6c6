"""``graph_data.npz`` -> LMDB graph store, counterpart of
``hamgnn_tpu/tools/npz_to_lmdb.py``:

    python -m hamgnn_tpu_torch.tools.npz_to_lmdb graph_data.npz graph_data.lmdb

Each crystal goes under ``graph_{i}`` as a pickled PyG ``Data`` (the port's
shim, under the ``torch_geometric`` class paths), the count under
``num_graphs``, so the reference, the JAX package and this port read the
result.  Where the ``lmdb`` module is missing it writes the lmdb-lite form
(``data.dataset.LmdbGraphStore``): a directory with a ``num_graphs`` text
file and one ``graph_{i}.pkl`` per crystal.
"""

from __future__ import annotations

import argparse
import os
import pickle


def convert(npz_path: str, lmdb_path: str, map_size_factor: float = 4.0) -> int:
    """Write the graphs of ``npz_path`` to a store at ``lmdb_path``; returns
    their number."""
    from ..data.dataset import load_graph_npz
    from ..interfaces.pyg_shim import Data, install_shim

    install_shim()
    graphs = load_graph_npz(npz_path)
    try:
        import lmdb
    except ImportError:
        os.makedirs(lmdb_path, exist_ok=True)
        for i, c in enumerate(graphs):
            with open(os.path.join(lmdb_path, f"graph_{i}.pkl"), "wb") as f:
                pickle.dump(Data(**c), f)
        with open(os.path.join(lmdb_path, "num_graphs"), "w") as f:
            f.write(str(len(graphs)))
        return len(graphs)
    env = lmdb.open(lmdb_path, map_size=int(os.path.getsize(npz_path) * map_size_factor
                                            + (1 << 24)))
    with env.begin(write=True) as txn:
        for i, c in enumerate(graphs):
            txn.put(f"graph_{i}".encode(), pickle.dumps(Data(**c)))
        txn.put(b"num_graphs", str(len(graphs)).encode())
    env.close()
    return len(graphs)


def main(argv=None):
    parser = argparse.ArgumentParser(description="graph_data.npz -> LMDB graph store")
    parser.add_argument("npz")
    parser.add_argument("lmdb")
    args = parser.parse_args(argv)
    print(f"wrote {convert(args.npz, args.lmdb)} graphs to {args.lmdb}")


if __name__ == "__main__":
    main()
