import os

# Tests run on the single real CPU device (the 512-device forcing is ONLY
# for the dry-run process; see src/repro/launch/dryrun.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest


@pytest.fixture
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)"
    )
