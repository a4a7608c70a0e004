import os

# Smoke tests and benches must see ONE device — the 512-device override
# belongs to launch/dryrun.py exclusively (see the multi-pod dry-run spec).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running system/perf tests excluded from the CI tier-1 "
        'lane (run with -m "not slow"); the full suite stays available '
        "locally via plain pytest")
    config.addinivalue_line(
        "markers",
        "gpu: runs the port's CUDA kernels; skips where no CUDA GPU is "
        "visible (run on the card with: python -m pytest -m gpu "
        "tests/test_torch_*.py)")


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)
