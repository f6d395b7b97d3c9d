"""The engine importing a kernel's plain version and the driver."""
from bad_r1.core import driver  # EXPECT-R1
from bad_r1.kernels.bag import ref  # EXPECT-R1
from bad_r1.kernels.bag import ops


def step(x):
    return ref.bag(x) + ops.bag(x) + driver.N
