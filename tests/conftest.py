"""Shared test configuration. NOTE: no XLA_FLAGS here — smoke tests and
benches must see the host's real (single) device; only launch/dryrun.py
sets the 512-placeholder-device flag, in its own process."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

# The property-based tests want hypothesis (see requirements-dev.txt); when
# it is not installed, fall back to a tiny deterministic stub so those
# modules still collect and exercise their assertions.
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub
    sys.modules["hypothesis.strategies"] = _hypothesis_stub.strategies

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); skips "
        "without one")
