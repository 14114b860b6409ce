"""The benchmark's own tests: ``python -m pytest kbench/tests -q`` from the
root of the checkout.  They run on the CPU at tiny sizes; a test marked
``cuda`` needs the card and skips, deciding inside the test, where there
is none."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (the card)")
