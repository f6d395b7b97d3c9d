"""State carried across from the reference package.

MCE has no weights: the engine's device state is the packed `RootBucket`
(uint32 bitset words, bool X0 alive masks, int32 base sizes). These
helpers move one bucket's numpy arrays into the port's tensors and map
the port's enumerated bitset rows back, bit for bit, so one bucket can
be fed to both engines. Only numpy crosses over; nothing here imports
the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.engine.loop import bucket_tensors

BUCKET_KEYS = ("a", "p0", "x_rows", "x_alive0", "rsz0")


def bucket_from_reference(arrays: Dict[str, np.ndarray], device
                          ) -> Dict[str, torch.Tensor]:
    """The port's tensors for a reference bucket's arrays: `a`, `p0`,
    `x_rows` (uint32, viewed as int32), `x_alive0` (bool), `rsz0`
    (int32), keyed as given, on `device`."""
    return dict(zip(BUCKET_KEYS, bucket_tensors(
        *(arrays[k] for k in BUCKET_KEYS), device)))


def bitset_rows_to_reference(words: torch.Tensor) -> np.ndarray:
    """int32 bitset words (e.g. the port's enumerated `out_rows`) as the
    reference's uint32 words, bit for bit."""
    return words.cpu().numpy().astype(np.int32, copy=False).view(np.uint32)
