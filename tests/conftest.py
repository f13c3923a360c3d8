"""Shared fixtures.  NOTE: no XLA_FLAGS device-count override here — the
smoke tests must see the real single CPU device (the 512-device override
belongs exclusively to repro.launch.dryrun)."""
import jax
import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _seed_global_rngs():
    """Deterministic runs: pin NumPy's global RNG before every test (JAX
    randomness is already explicit via PRNGKey fixtures below)."""
    np.random.seed(0)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (a hand-written CUDA "
        "kernel has no CPU mode); skips where there is no card")
