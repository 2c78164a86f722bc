"""The priority of the heavy port test modules.

The port's heavy test modules (every one whose JAX references compile or
run for more than a few seconds) import `below_the_jax_files`, an autouse
module fixture: they run below the priority of the JAX package's tests,
with which they share the machine's cores. The longest JAX file,
`tests/test_runtime.py`, sets the run's wall, and it slows by up to a third
when every core is busy; lowering two modules only left it there. Threads
started inside a module inherit the lower priority, and every thread of the
process is set back after the module. This module imports neither jax nor
the port, so a spawned rank that imports a test module stays light. The
modules with timing-bound tests (the runner's, the stream's, the command
line's) keep the normal priority.
"""

import os
import threading

import pytest

NICENESS = 5


def _renice(value: int) -> None:
    for tid in os.listdir("/proc/self/task"):
        try:
            os.setpriority(os.PRIO_PROCESS, int(tid), value)
        except OSError:  # a thread that has ended meanwhile
            pass


@pytest.fixture(scope="module", autouse=True)
def below_the_jax_files():
    base = os.getpriority(os.PRIO_PROCESS, 0)
    _renice(base + NICENESS)
    yield base
    _renice(base)


def test_a_module_runs_below_and_its_threads_inherit(below_the_jax_files):
    """Inside the module this thread and a thread it starts run NICENESS
    below the priority the process had."""
    seen = []
    t = threading.Thread(target=lambda: seen.append(os.getpriority(os.PRIO_PROCESS, 0)))
    t.start()
    t.join(timeout=10)
    assert os.getpriority(os.PRIO_PROCESS, 0) == below_the_jax_files + NICENESS
    assert seen == [below_the_jax_files + NICENESS]
