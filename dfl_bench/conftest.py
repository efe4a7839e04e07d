"""The benchmark's tests share the repository's marker for tests that need
the card (``-m cuda``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (and nvcc); skips with a reason elsewhere",
    )
