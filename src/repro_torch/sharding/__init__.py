"""Sharding rules of the port: the reference's `repro.sharding` as specs
(`spec.P`, one entry a tensor dim, as `PartitionSpec`) and their DTensor
placements on a `torch.distributed` `DeviceMesh`. The reference's
`sharding/compat.py` bridges two jax spellings of `shard_map` and has no
counterpart here."""
from repro_torch.sharding.gnn import GNNSharding, gnn_sharding  # noqa: F401
from repro_torch.sharding.lm import (LMSharding, lm_sharding,  # noqa: F401
                                     opt_state_specs)
from repro_torch.sharding.recsys import (RecsysSharding,  # noqa: F401
                                         recsys_sharding)
from repro_torch.sharding.spec import (P, MeshShape,  # noqa: F401
                                       distribute, placements)
