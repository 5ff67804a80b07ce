"""Test settings of the benchmark's own tests (`python -m pytest
benchmark/tests`): the `cuda` marker for tests that need a card, which
decide inside the test whether one is there."""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")
