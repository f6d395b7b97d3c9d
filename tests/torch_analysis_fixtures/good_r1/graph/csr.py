import numpy as np

EMPTY = np.zeros(0)
