# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# single real CPU device; only launch/dryrun.py (and subprocess-based mesh
# tests) force a host-platform device count.
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "card: needs an NVIDIA card; the test itself skips when none is "
        "visible (run them on the card with `python3 -m pytest -m card "
        "tests/test_torch_dataplane_card.py`)")
