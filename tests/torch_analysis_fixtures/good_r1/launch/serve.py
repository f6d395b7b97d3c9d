"""A launcher drives the driver and the kernels' ops."""
from good_r1.core import driver
from good_r1.kernels.bag import ops


def serve(x):
    return driver.run(x), ops.bag(x)
