# Frozen copy of hamgnn_tpu_torch/models/view.py, with its imports rewritten.
"""GraphView: the rows one device holds of a padded Graph, with the
communication it needs injected as hooks; counterpart of
``hamgnn_tpu/models/view.py``.

The representation networks and the output heads are written against this
view, so the same modules, parameters and arithmetic run

* on one device: ``GraphView.dense(graph)``, whose hooks are plain indexing
  (``rows[src]``, ``rows[inv_edge]``) and an identity ``psum``;
* under the halo edge partition: ``parallel.halo_model.halo_view``, whose
  hooks are collectives over the rank's graph group.

Hooks (N owned nodes, E local edges):

* ``gather_src(rows)``: (N, D) -> (E, D) rows of each edge's source;
* ``gather_dst(rows)``: (N, D) -> (E, D) rows of each edge's destination (an
  edge lives with its destination's owner, so this is local);
* ``inv_exchange(rows)``: (E, D) -> (E, D) rows of each edge's inverse edge;
* ``psum(x)``: the sum over the partition (differentiable);
* the overlap hooks (the partition only): ``gather_src_interior`` reads owned
  rows, ``halo_start(rows)`` starts the exchange and returns a thunk that
  gives the received (S*H, D) rows (it waits for them), ``interior_mask``,
  ``boundary_pos`` / ``boundary_mask`` (the local rows of the edges whose
  source is remote) and ``src_halo_pos`` (their sources in the halo rows);
* ``gather_nodes_global`` / ``gather_edges_global``: the whole crystal's rows
  in the global padded order, for the band solve (identity on one device).

``graph`` is the whole padded Graph where one is at hand (one device, or the
band mode of the partition), else None; heads run whole-crystal work only
when it is set.  The dense hooks only index: they read nothing from the
device on the host, so a captured step still captures.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from .graph import Graph


def _identity(x):
    return x


@dataclasses.dataclass
class GraphView:
    # per owned node
    z: Any
    node_mask: Any
    num_nodes: int
    # per local edge
    edge_vec: Any
    edge_mask: Any
    z_src: Any
    z_dst: Any
    dst_index: Any
    # communication hooks
    gather_src: Callable
    gather_dst: Callable
    inv_exchange: Callable
    psum: Callable = _identity
    # the overlap split (the partition only)
    gather_src_interior: Optional[Callable] = None
    halo_start: Optional[Callable] = None
    interior_mask: Optional[Any] = None
    boundary_pos: Optional[Any] = None
    boundary_mask: Optional[Any] = None
    src_halo_pos: Optional[Any] = None
    # whole-crystal row order
    gather_nodes_global: Callable = _identity
    gather_edges_global: Callable = _identity
    # charge doping per owned node and per edge endpoint
    doping_own: Optional[Any] = None
    doping_src: Optional[Any] = None
    doping_dst: Optional[Any] = None
    # targets and references in the view's row order
    Hon: Optional[Any] = None
    Hoff: Optional[Any] = None
    Son: Optional[Any] = None
    Soff: Optional[Any] = None
    Hon0: Optional[Any] = None
    Hoff0: Optional[Any] = None
    iHon: Optional[Any] = None
    iHoff: Optional[Any] = None
    iHon0: Optional[Any] = None
    iHoff0: Optional[Any] = None
    Lon: Optional[Any] = None
    Loff: Optional[Any] = None
    spin_vec: Optional[Any] = None
    spin_length: Optional[Any] = None
    graph: Optional[Graph] = None

    @classmethod
    def dense(cls, graph: Graph) -> "GraphView":
        """The one-device view: the gathers are plain indexing."""
        src, dst = graph.edge_index[0], graph.edge_index[1]
        inv_edge = graph.inv_edge_idx
        doping = None
        if graph.doping_charge is not None:
            doping = graph.doping_charge[graph.batch]
        return cls(
            z=graph.z, node_mask=graph.node_mask, num_nodes=graph.num_nodes,
            edge_vec=graph.edge_vectors(), edge_mask=graph.edge_mask,
            z_src=graph.z[src], z_dst=graph.z[dst], dst_index=dst,
            gather_src=lambda rows: rows[src],
            gather_dst=lambda rows: rows[dst],
            inv_exchange=(lambda rows: rows[inv_edge]) if inv_edge is not None
            else _identity,
            doping_own=doping,
            doping_src=None if doping is None else doping[src],
            doping_dst=None if doping is None else doping[dst],
            Hon=graph.Hon, Hoff=graph.Hoff, Son=graph.Son, Soff=graph.Soff,
            Hon0=graph.Hon0, Hoff0=graph.Hoff0, iHon=graph.iHon, iHoff=graph.iHoff,
            iHon0=graph.iHon0, iHoff0=graph.iHoff0, Lon=graph.Lon, Loff=graph.Loff,
            spin_vec=graph.spin_vec, spin_length=graph.spin_length,
            graph=graph)


def as_view(graph_or_view) -> GraphView:
    if isinstance(graph_or_view, GraphView):
        return graph_or_view
    return GraphView.dense(graph_or_view)
