import os
import sys

# Tests run single-device (the dry-run subprocess sets its own XLA_FLAGS).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, os.path.abspath(SRC))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs a CUDA kernel on the card; skips without one")
