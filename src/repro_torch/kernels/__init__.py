"""Kernel packages of the port, one per reference kernel package.

Each is `<name>/{ref,ops}.py` beside `<name>/csrc/<name>.cu`: `ref` holds
the plain PyTorch versions, `ops` dispatches CPU tensors to them and CUDA
tensors to the hand-written Hopper kernels (built at first use by
`_build`, never at import). As in the reference package, the `ops`
modules are what callers use:

  bitset_ops      — AND+popcount set algebra of the Bron–Kerbosch engine;
  common_neighbor — per-edge common-neighbour test (Lemma-4 triangles);
  segment_spmm    — message-passing aggregation (GNN substrate);
  embedding_bag   — multi-hot gather + bag sum (recsys substrate);
  flash_attention — softmax attention forward (LM substrate).

`shapes_only()` is the scope in which the wrappers also take meta tensors
to their plain versions (the dry run, `launch/dryrun.py`).
"""
from repro_torch.kernels._build import shapes_only  # noqa: F401
from repro_torch.kernels.bitset_ops import ops as bitset_ops  # noqa: F401
from repro_torch.kernels.common_neighbor import ops as common_neighbor  # noqa: F401,E501
from repro_torch.kernels.segment_spmm import ops as segment_spmm  # noqa: F401
from repro_torch.kernels.embedding_bag import ops as embedding_bag  # noqa: F401
from repro_torch.kernels.flash_attention import ops as flash_attention  # noqa: F401,E501
