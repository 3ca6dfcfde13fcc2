"""One intra-op thread for the worker processes the port's fleet tests
spawn.

A spawned worker is a fresh interpreter: it imports torch afresh and
takes its intra-op thread count from ``OMP_NUM_THREADS`` (and MKL's from
``MKL_NUM_THREADS``) at import, else one thread a core. Several test
files spawn fleets at once under ``pytest -n``, so without a limit the
host runs many times more compute threads than it has cores, and
heartbeat-timed cases stretch. ``one_thread_workers`` sets both
variables for a test module (workers inherit the environment) and
restores them afterwards; import it into the module to apply it.
"""
import os

import pytest

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")


@pytest.fixture(scope="module", autouse=True)
def one_thread_workers():
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    os.environ.update({k: "1" for k in THREAD_VARS})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
