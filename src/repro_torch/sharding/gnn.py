"""Sharding rules for the GNN stack (edge-parallel message passing), the
port of the reference's `repro.sharding.gnn`, as the port's specs.

GNN sharding regimes on the production mesh (DESIGN.md §5):

* **Edge parallelism** — the edge list (src, dst, edge_mask) and every
  edge-indexed tensor shard over the flattened data axes; a segment sum
  over sharded edges is a local scatter-add plus an all-reduce over the
  data axes (the all-reduce IS the aggregation boundary).
* **Node tensors** shard over data when the node count divides the axis
  (full-graph shapes), else replicate (tiny molecule graphs).
* **Params replicate** — every assigned GNN is < 10M params.
* Triplet tensors (DimeNet) shard over data like edges.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from torch.distributed.tensor import Placement

from repro_torch.sharding.spec import P, Spec, placements, size_of


@dataclasses.dataclass
class GNNSharding:
    mesh: object                     # a DeviceMesh, or a MeshShape stand-in
    dp: Tuple[str, ...]
    batch_specs: Dict[str, Spec]
    param_spec: Spec                 # uniform: replicated

    def placements(self, spec: Spec) -> Tuple[Placement, ...]:
        return placements(spec, self.mesh)


def gnn_sharding(mesh, meta: dict,
                 dp_axes: Tuple[str, ...] = ("data",)) -> GNNSharding:
    dp_size = size_of(mesh, dp_axes)
    n_nodes = meta["n_nodes"]
    n_edges = meta["n_edges"]
    edge_spec = P(dp_axes) if n_edges % dp_size == 0 else P(None)
    node_spec = P(dp_axes) if n_nodes % dp_size == 0 else P(None)
    specs = dict(
        node_feat=P(*node_spec, None),
        positions=P(*node_spec, None),
        node_mask=node_spec,
        src=edge_spec,
        dst=edge_spec,
        edge_mask=edge_spec,
        graph_id=node_spec,
        targets=node_spec,
    )
    if meta.get("n_triplets"):
        t = meta["n_triplets"]
        trip_spec = P(dp_axes) if t % dp_size == 0 else P(None)
        specs["trip_kj"] = trip_spec
        specs["trip_ji"] = trip_spec
        specs["trip_mask"] = trip_spec
    return GNNSharding(mesh=mesh, dp=dp_axes, batch_specs=specs,
                       param_spec=P())
