"""graph/: numpy, torch, the standard library and its siblings."""
import dataclasses

import numpy as np
import torch

from good_r1.graph import csr


def degrees(indptr):
    return torch.as_tensor(np.diff(indptr)), csr, dataclasses
