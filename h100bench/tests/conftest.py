"""The benchmark's own tests: on the CPU, at sizes a test run holds (the
card's runs are the benchmark itself)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from h100bench.tests import tiny  # noqa: E402


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with small bodies and spacings."""
    return tiny.make(tmp_path_factory.mktemp("bench"))
