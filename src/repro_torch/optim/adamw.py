"""AdamW with decoupled weight decay and global-norm clipping, on named
parameters (`dict(model.named_parameters())`).

The reference's semantics (`repro.optim.adamw`): float32 moments whatever
the parameter's type, the gradients clipped to `clip_norm` by their global
norm, bias correction by the step counter, a per-call lr, each element
computed in the reference's order of operations. Unlike the reference,
which returns new arrays, the update writes the parameters and the
moments in place: at full width a second copy of each would not fit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch
from torch.distributed.tensor import DTensor

Named = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params: Named) -> Dict:
    """dict(mu, nu: name -> float32 zeros of each parameter's shape on its
    device, step: int32 zero on the first parameter's device)."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    dev = next(iter(params.values())).device
    return dict(mu=zeros(), nu=zeros(),
                step=torch.zeros((), dtype=torch.int32, device=dev))


def laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Gradient `g` laid out as its parameter `p`: a DTensor gradient
    (partial sums over the ranks that split the batch, say) redistributed
    to `p`'s placements, which reduces it; a plain one as it is."""
    if isinstance(g, DTensor):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32."""
    return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32)
                        for t in tensors]).square().sum().sqrt()


@torch.no_grad()
def adamw_update(params: Named, grads: Named, state: Dict, lr,
                 cfg: AdamWConfig = AdamWConfig()) -> Tuple[Named, Dict]:
    """One AdamW step at learning rate `lr` (a float or a float32 scalar
    tensor). Writes each parameter and its moments in place and returns
    (params, state) with the step counter advanced."""
    grads = {n: laid_out_as(grads[n], p) for n, p in params.items()}
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - cfg.b1 ** t
    c2 = 1.0 - cfg.b2 ** t
    for n, p in params.items():
        mu, nu = state["mu"][n], state["nu"][n]
        g = grads[n].to(torch.float32) * scale
        mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        nu.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        del g
        den = (nu / c2).sqrt_().add_(cfg.eps)
        upd = (mu / c1).div_(den)
        del den
        pf = p.to(torch.float32)
        upd.add_(cfg.weight_decay * pf).mul_(lr)
        p.copy_(pf - upd)
    return params, dict(mu=state["mu"], nu=state["nu"], step=step)


def apply_gradients(module: torch.nn.Module, loss: torch.Tensor, state: Dict,
                    lr, cfg: AdamWConfig = AdamWConfig()) -> Dict:
    """`loss.backward()` then one `adamw_update` of every parameter of
    `module` (a parameter the loss does not reach gets a zero gradient, as
    the reference's `value_and_grad` gives it); the gradients are dropped
    after the update. Returns the new state."""
    named = dict(module.named_parameters())
    for p in named.values():
        p.grad = None
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in named.items()}
    _, state = adamw_update(named, grads, state, lr, cfg)
    for p in named.values():
        p.grad = None
    return state
