"""Error-feedback int8 gradient compression for the cross-node all-reduce.

The reference's scheme (`repro.optim.compress`) on a `torch.distributed`
group in place of a mesh axis: each gradient is quantised to int8 with one
scale per tensor, the quantisation residual is carried into the next step
(error feedback, the 1-bit Adam / EF-SGD lineage), and the dequantised
tensor is all-reduced and divided by the group's size. As in the
reference, the sum runs on the dequantised float32 tensor; the wire format
(the int8 tensor and its scale) is the collective's concern.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

Named = Mapping[str, torch.Tensor]


def ef_state_init(grads_like: Named) -> Dict[str, torch.Tensor]:
    """float32 zeros of each gradient's shape, on its device."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads_like.items()}


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def ef_int8_allreduce(grads: Named, ef: Named, group: Optional[
        dist.ProcessGroup] = None) -> Tuple[Dict, Dict]:
    """(mean of the quantised gradients over `group`, in each gradient's
    type; the new residuals). `group` None is the default group, which
    must be initialised."""
    n = dist.get_world_size(group)
    out, new_ef = {}, {}
    for name, g in grads.items():
        x = g.to(torch.float32) + ef[name]
        q, scale = _quantize(x)
        deq = q.to(torch.float32) * scale
        new_ef[name] = x - deq
        dist.all_reduce(deq, group=group)
        out[name] = (deq / n).to(g.dtype)
    return out, new_ef
