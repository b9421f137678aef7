"""pytest settings for the benchmark's own tests (``portbench/tests``).

They run on the CPU with the port's plain paths; a test that needs the
card carries the ``gpu`` marker and skips inside the test where there is
none (never while a module is imported). The benchmark's package
(``pbench``), the program (``src``) and the tests' helpers are put on the
path here.
"""
import os
import sys

import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.join(_HERE, "tests"), _HERE,
           os.path.join(os.path.dirname(_HERE), "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped where there is none")


@pytest.fixture(autouse=True)
def _one_thread():
    """The benchmark's CPU tests run their serving loops on one thread, so
    that a worker running them leaves the other workers' cores alone."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
