import os
import sys

# Make `python -m pytest` work from the repo root (or anywhere) without an
# explicit PYTHONPATH: the src/ layout is injected here, before test modules
# import `repro`. Tests run on the host's real device list (1 CPU device) —
# the dry-run (and only the dry-run) forces 512 host devices in its own
# process.
_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

import jax
import pytest


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped where there is none")
