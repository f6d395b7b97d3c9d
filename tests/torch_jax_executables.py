"""pytest plugin: drop JAX's compilation caches between test files.

Every executable XLA compiles on the CPU holds hundreds of memory maps
(a reference persistent-engine loop 400–900: one code, data and
read-only mapping per kernel), and they stay mapped while JAX's caches
hold the executable. A test worker that runs several compile-heavy files
in one process passes the kernel's limit on maps per process
(vm.max_map_count, 65,530 by default) and crashes inside the compiler;
tests/test_windowed_engine.py alone peaks near 50,000. Clearing the
caches whenever the next test belongs to another file bounds a worker
by its heaviest file, whatever files the scheduler gave it before.

The port's test modules that run the reference load it with
`pytest_plugins = ["torch_jax_executables"]`; each worker collects them,
so it applies to the whole run."""
import gc

import jax


def pytest_runtest_teardown(item, nextitem):
    if nextitem is None or nextitem.path != item.path:
        jax.clear_caches()
        gc.collect()
