"""graph/ reaching up into the engine, and a package outside its layer."""
import numpy as np
import scipy.sparse  # EXPECT-R1

from bad_r1.core.engine import loop  # EXPECT-R1


def degrees(indptr):
    return np.diff(indptr), loop
