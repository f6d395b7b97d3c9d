"""Optimizer, schedule and gradient compression of the training path: the
port of the reference's `repro.optim`, on the port's named parameters."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     apply_gradients)
from repro_torch.optim.compress import ef_int8_allreduce, ef_state_init
from repro_torch.optim.schedule import cosine_warmup

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "apply_gradients",
    "cosine_warmup",
    "ef_int8_allreduce", "ef_state_init",
]
