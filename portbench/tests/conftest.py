"""Fixtures of the benchmark's tests: small copies of the configurations,
and the card, decided inside a fixture."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL_ROWS = {"x": 20_000}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


def small(config, rows=SMALL_ROWS, k=10):
    """A configuration cut to a test's size: its tables' rows, the H2O
    keys' K and the high-cardinality keys with them."""
    config = copy.deepcopy(config)
    for name, table in config["tables"].items():
        full, n = int(table["rows"]), rows[name]
        table["rows"] = n
        for spec in table["columns"].values():
            if spec["kind"] != "randint":
                continue
            lo, hi = spec["range"]
            if hi == 100:
                spec["range"] = [lo, k]
            elif hi >= 1000:  # a key spanning the rows / 100
                spec["range"] = [lo, max(lo + 1, hi * n // full)]
    return config


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
