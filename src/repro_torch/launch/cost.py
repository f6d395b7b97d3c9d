"""Per-rank cost of one step, the port's counterpart of the reference's
`repro.launch.hlo_cost`.

The reference walks the partitioned HLO that XLA compiled for one device.
The port has no HLO: it runs the step once on a world of ranks (a fake one
in the dry run), its arguments meta DTensors, under `StepCost`, a dispatch
mode that sees each aten op on one rank's local shards. For an op on
DTensors it steps aside, so DTensor's own dispatch runs first and the mode
then sees the local ops DTensor issues, its redistributions' collectives
included, and none of the ops its sharding propagation runs to find a
layout. Every term is therefore per rank, as the reference's are per
device. Costs:

  flops        — matrix products, convolutions and attention by torch's own
                 formulas (`torch.utils.flop_counter`) on local shapes
                 (`matmul_flops`), plus one per output element of every
                 pointwise op and one per input element of a reduction;
  bytes        — per op, operand bytes + output bytes on local shards: the
                 same model as the reference's (an op reads its operands and
                 writes its output once), with nothing fused, so each op is
                 one round trip of device memory (the reference's HLO fuses
                 elementwise chains first); views, metadata and allocations
                 are free; a collective adds its payload twice (in and out);
  collectives  — by kind (the reference's names: all-reduce, all-gather,
                 reduce-scatter, all-to-all, collective-permute): count,
                 payload bytes and link bytes, the payload times the ring
                 factor of ``collective_link_bytes`` (the reference's
                 formulas, copied).

`torch.utils.flop_counter.FlopCounterMode` counts something else: it sees
the DTensor ops first, so it counts global shapes where a step works on
DTensors, and local shapes where the step itself works on `to_local()`
shards; that mix matches neither a rank's work nor the whole world's.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, Iterable, List

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# aten op -> the reference's collective kind (functional and c10d ops)
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
# ops that move no data: allocations, waits and metadata
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "wait_tensor",
         "_local_scalar_dense", "set_", "resize_", "_to_copy_meta"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "_softmax", "_log_softmax", "cumsum", "cumprod",
               "linalg_vector_norm", "norm", "var", "std", "var_mean",
               "argmax", "argmin", "any", "all", "_softmax_backward_data",
               "_log_softmax_backward_data"}


def collective_link_bytes(opcode: str, out_bytes: float, g: int) -> float:
    """Ring-algorithm per-device link traffic (the reference's formulas,
    `hlo_cost.collective_link_bytes`, on its op names)."""
    if g <= 1:
        return 0.0
    if opcode == "all-reduce":
        return 2.0 * (g - 1) / g * out_bytes
    if opcode == "all-gather":
        return (g - 1) / g * out_bytes          # out = full gathered value
    if opcode == "reduce-scatter":
        return (g - 1) * out_bytes              # in = out × g
    if opcode == "all-to-all":
        return (g - 1) / g * out_bytes
    if opcode == "collective-permute":
        return float(out_bytes)
    return 0.0


def _in_sharding_propagation() -> bool:
    """Whether the op being dispatched runs inside DTensor's sharding
    propagation: for an op it has no rule for, DTensor propagates through
    the op's decomposition, running the decomposed ops on the rank's
    local shapes (torch 2.11 does so for `softplus`: exp, gt, log1p,
    where), once a new (shape, placements). That is no work of the
    rank's."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "propagate_op_sharding_non_cached":
            return True
        f = f.f_back
    return False


def _tensors(tree) -> Iterable[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """Bytes one rank holds of `tree` (tensors, DTensors by their local
    shards, modules by their parameters and buffers, dicts, lists)."""
    if isinstance(tree, torch.nn.Module):
        tree = [*tree.parameters(), *tree.buffers()]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(t) for t in tree)
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    return 0


def _group_ranks(func, named: Dict[str, Any]) -> List[int]:
    """The global ranks of a collective's group, from its group name (the
    functional collectives) or its process group (the c10d ops)."""
    import torch.distributed as dist
    group = named.get("process_group")
    if group is not None:
        if not isinstance(group, dist.ProcessGroup):
            group = dist.ProcessGroup.unbox(group)
    else:
        name = named.get("group_name")
        if not isinstance(name, str):
            raise ValueError(f"{func}: cannot tell the group")
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(name)
    return list(dist.get_process_group_ranks(group))


class StepCost(TorchDispatchMode):
    """Per-rank cost of whatever runs inside `with StepCost() as cost:`.
    A collective's link bytes also count in `across_hosts` when its group
    spans hosts of `host_size` consecutive ranks."""

    def __init__(self, host_size: int = 8) -> None:
        super().__init__()
        self.host_size = host_size
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {}
        # aten op -> [calls, flops, bytes]: where the terms come from
        self.by_op: Dict[str, List[float]] = {}

    @property
    def link(self) -> float:
        return sum(r["link_bytes"] for r in self.collectives.values())

    @property
    def link_across_hosts(self) -> float:
        return sum(r["across_hosts"] for r in self.collectives.values())

    def totals(self) -> Dict[str, Any]:
        return dict(flops=self.flops, matmul_flops=self.matmul_flops,
                    bytes=self.bytes, link=self.link,
                    link_across_hosts=self.link_across_hosts,
                    collectives={k: dict(v) for k, v in
                                 sorted(self.collectives.items())},
                    by_op={k: list(v) for k, v in self.by_op.items()})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor first; then its local ops
        out = func(*args, **kwargs)
        if (any(issubclass(t, FakeTensor) for t in types)
                or _in_sharding_propagation()):
            return out                     # DTensor's sharding propagation
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_KINDS.get(name)
            if kind is None:
                return                      # waits and bookkeeping
            named = dict(zip((a.name for a in func._schema.arguments), args))
            named.update(kwargs)
            ranks = _group_ranks(func, named)
            if kind in ("all-gather", "reduce-scatter"):
                size = sum(_nbytes(t) for t in outs)
            else:
                size = sum(_nbytes(t) for t in ins)
            link = collective_link_bytes(kind, size, len(ranks))
            rec = self.collectives.setdefault(
                kind, dict(count=0, bytes=0.0, link_bytes=0.0,
                           across_hosts=0.0))
            rec["count"] += 1
            rec["bytes"] += size
            rec["link_bytes"] += link
            if len({r // self.host_size for r in ranks}) > 1:
                rec["across_hosts"] += link
            self.bytes += 2.0 * size
            return
        if func.is_view or name in _FREE or ns == "prim":
            return
        moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        packet = func._overloadpacket
        f = 0.0
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.matmul_flops += f
        elif name.rstrip("_") in _REDUCTIONS and ins:
            f = float(ins[0].numel())
        elif torch.Tag.pointwise in func.tags and outs:
            f = float(max(t.numel() for t in outs))
        self.flops += f
        self.bytes += moved
        rec = self.by_op.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += f
        rec[2] += moved

