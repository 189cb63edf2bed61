"""The general table maker: the same tables from the same seed, each
column drawn by its kind's module."""

import json
import os

import pytest
import torch

from conftest import ROOT, small
from portbench import tables

CONFIGS = os.path.join(ROOT, "portbench", "configs")


def config(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def test_same_seed_same_tables():
    cfg = small(config("h2o_g1_1e8_k100"))
    seed = 2 ** 31 + 12345  # past 32 signed bits
    a = tables.make(cfg, seed, "cpu")
    b = tables.make(cfg, seed, "cpu")
    c = tables.make(cfg, seed + 1, "cpu")
    for col in a["x"]:
        assert torch.equal(a["x"][col], b["x"][col])
    assert not torch.equal(a["x"]["id3"], c["x"]["id3"])


def test_columns_follow_their_specs():
    cfg = small(config("h2o_g1_1e8_k100"))
    x = tables.make(cfg, 5, "cpu")["x"]
    assert list(x) == ["id1", "id2", "id3", "id4", "id5", "id6", "v1", "v2", "v3"]
    assert int(x["id1"].min()) >= 1 and int(x["id1"].max()) <= 10
    assert int(x["v2"].min()) >= 1 and int(x["v2"].max()) <= 15
    assert x["v3"].dtype == torch.float64 and 0 <= float(x["v3"].min()) < float(x["v3"].max()) < 100
    assert tables.rows(cfg) == {"x": 20_000}


def test_an_unknown_kind_is_refused():
    cfg = {"tables": {"t": {"rows": 4, "columns": {"a": {"kind": "nosuch", "dtype": "int64"}}}}}
    with pytest.raises(ValueError, match="columns/nosuch.py"):
        tables.make(cfg, 1, "cpu")


def test_full_size_table_as_chip_smoke_draws_it():
    """The published size: 1e8 rows of nine 8-byte columns."""
    h2o = config("h2o_g1_1e8_k100")
    assert tables.rows(h2o) == {"x": 100_000_000}
    assert h2o["tables"]["x"]["columns"]["id3"] == {"kind": "randint", "dtype": "int64",
                                                    "range": [1, 1_000_000]}
