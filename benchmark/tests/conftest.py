"""The benchmark's own tests: the repository root on the path, and the
``cuda`` marker for tests that need the card (each decides inside the
test whether there is one)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on the card (skips without one)")
