"""The benchmark's own tests: the marker for tests that need a CUDA card."""


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one)")
