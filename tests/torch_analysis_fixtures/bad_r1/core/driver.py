"""The driver importing a launcher, JAX and the reference package."""
import jax  # EXPECT-R1

from bad_r1.launch import serve  # EXPECT-R1
from repro.graph import csr  # EXPECT-R1

N = 1


def run():
    return serve, jax, csr
