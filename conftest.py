"""How the tier-1 run of ``tests/`` is held together; pytest loads this file
before ``tests/conftest.py``, which sets the JAX test platform up.

- JAX's CPU computations run inline (``jax_cpu_enable_async_dispatch``
  off), before any backend starts.
- Every test runs under ``tests/time_limit.py``'s limit: one that hangs
  prints its stacks, ends its worker and fails, and the run goes on.
- pytest-xdist's ``--dist loadfile`` hands the test files out in the order
  set below.
"""

import importlib.util
import sys
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "time_limit", Path(__file__).parent / "tests" / "time_limit.py")
time_limit = sys.modules["time_limit"] = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(time_limit)

# The files of up to a minute a test, a few minutes each: slowest first, so
# that none of them starts last and runs on after the rest.
SLOW_FIRST = ("test_spatial.py", "test_consistency.py", "test_graft.py",
              "test_train.py")


def pytest_configure(config):
    # Interpret-mode Pallas calls run io_callbacks that dispatch JAX ops of
    # their own; dispatched asynchronously, such a call's callback thread
    # and the main thread's next eager op can wait on each other for ever,
    # most often under CPU load (the callback in interpret_pallas_call.py:643
    # `store` or in shared_memory.py:589 `update_clocks_for_device_barrier`,
    # the main thread in dispatch.py:91 `apply_primitive`). The flag is read
    # from the config only, not from the environment. JAX is not imported
    # here: tests/conftest.py has, and the port's runs must not.
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update("jax_cpu_enable_async_dispatch", False)
    time_limit.install(config)
    # xdist's own order, by count of tests, would put the slow files of a
    # few tests last. This overrides --loadscope-reorder too.
    config.option.loadscopereorder = False


def pytest_collection_modifyitems(items):
    # The slow files first; then the JAX reference's other files; then the
    # port's (test_torch_*), many and short, which even out the workers'
    # ends. sort is stable: the order within a file is kept.
    def rank(item):
        name = item.path.name
        if name in SLOW_FIRST:
            return SLOW_FIRST.index(name)
        return len(SLOW_FIRST) + name.startswith("test_torch_")

    items.sort(key=rank)
