import os
import sys

# tests see the single real CPU device (the 512-device override is ONLY for
# launch/dryrun.py, which sets XLA_FLAGS itself before importing jax)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# make _hypothesis_fallback importable from test modules
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Hard per-test timeout (seconds), enabled by REPRO_TEST_TIMEOUT (CI sets
# it; unset locally).  A hung XLA dispatch never returns control to the
# Python signal machinery, so a plain SIGALRM handler cannot fail the test
# — faulthandler's watchdog thread dumps every stack and kills the process
# instead, which is exactly the "fail fast with a traceback" CI wants.
#
# Tests that legitimately need longer (big one-off compiles, e.g. the
# Pallas interpret-mode kernels) mark themselves with
# ``@pytest.mark.slow_compile`` (timeout × 3) or
# ``@pytest.mark.timeout_factor(k)`` — the budget scales instead of the
# watchdog being disabled, so a genuine hang still dies, just later.
_TEST_TIMEOUT = float(os.environ.get("REPRO_TEST_TIMEOUT", "0") or 0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow_compile: triple the REPRO_TEST_TIMEOUT watchdog "
        "budget (one-off heavy jit/interpret compiles)")
    config.addinivalue_line(
        "markers", "timeout_factor(k): scale the REPRO_TEST_TIMEOUT "
        "watchdog budget by k for this test")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture(autouse=_TEST_TIMEOUT > 0)
def _per_test_timeout(request):
    import faulthandler

    budget = _TEST_TIMEOUT
    if request.node.get_closest_marker("slow_compile") is not None:
        budget *= 3.0
    factor = request.node.get_closest_marker("timeout_factor")
    if factor is not None and factor.args:
        budget *= float(factor.args[0])
    faulthandler.dump_traceback_later(budget, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
