"""A launcher reaching the build helper."""
from bad_r1.kernels._build import on_cpu  # EXPECT-R1
from bad_r1.kernels.bag.ref import bag  # EXPECT-R1


def serve(x):
    return on_cpu(x), bag(x)
