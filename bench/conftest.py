"""pytest settings for the benchmark's own tests (no JAX here)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where there is no card)")
