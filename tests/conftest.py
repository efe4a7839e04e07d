import os
import sys

# Tests run single-device (the 512-device override lives ONLY in dryrun.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# Make the `_proptest` hypothesis-fallback shim importable regardless of the
# pytest import mode in use.
sys.path.insert(0, os.path.dirname(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (and nvcc); skips with a reason elsewhere",
    )
