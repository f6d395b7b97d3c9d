"""Architecture registry: every ported arch is selectable via --arch <id>.

Importing this package registers the architectures the port can build:
the five LMs, the two-tower retrieval model and the paper's own `rmce`.
The reference's four GNN archs (meshgraphnet, schnet, dimenet, mace) need
the GNN model configs and are registered with them; until then
`get_arch` raises the registry's KeyError for their names.
`get_arch(name)` returns the ArchSpec; `list_archs()` enumerates them.
"""
from repro_torch.configs.base import (ArchSpec, ShapeCell, get_arch,
                                      list_archs, register)

# assigned architectures (importing registers them)
from repro_torch.configs import mixtral_8x7b         # noqa: F401
from repro_torch.configs import phi35_moe            # noqa: F401
from repro_torch.configs import qwen3_14b            # noqa: F401
from repro_torch.configs import chatglm3_6b          # noqa: F401
from repro_torch.configs import command_r_plus_104b  # noqa: F401
from repro_torch.configs import two_tower_retrieval  # noqa: F401
# the paper's own architecture: distributed RMCE
from repro_torch.configs import rmce                 # noqa: F401

__all__ = ["ArchSpec", "ShapeCell", "get_arch", "list_archs", "register"]
