import os

# smoke tests and benches must see ONE device; only launch/dryrun.py (its own
# process) sets xla_force_host_platform_device_count.  Tests that need a
# multi-device host mesh spawn subprocesses or use their own env (see
# test_distributed.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running (dry-run compiles)")
    config.addinivalue_line("markers", "gpu: needs a CUDA device (skips without one)")
