"""One thread budget for each pytest-xdist worker.

Each worker's torch (and every process a test spawns) would otherwise
start its OpenMP pool at the machine's core count: under ``-n 6`` on eight
cores that is several spinning threads per core, and the many small ops of
the CPU tests wait on threads the scheduler has switched out. Under xdist
this gives each worker ``cpu_count // workers`` threads (at least one),
before any test module imports torch; the spawned processes inherit it. A
caller's own settings win, and a run without xdist keeps every core. A
library loaded before this file (numpy, by a pytest plugin) keeps its pool
in the worker. ``tests/conftest.py`` (XLA's flags) loads after this file.
"""
import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    _threads = str(max(1, (os.cpu_count() or 1) // int(_workers)))
    for _key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(_key, _threads)
