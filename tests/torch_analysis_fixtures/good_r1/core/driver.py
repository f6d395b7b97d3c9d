"""The driver consumes the engine."""
from good_r1.core.engine import loop


def run(x):
    return loop.step(x)
