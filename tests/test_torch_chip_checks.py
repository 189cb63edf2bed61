"""The float checks of chip_smoke.py, on the CPU: the per-cell bound that
holds a kernel whose float adds have no fixed order (B2, B3, B5) against
its plain version (``index_add_``, no fixed order on a CUDA device either).

A relative tolerance fails two correct sums of a cell whose terms nearly
cancel (B5's corr at G = 58 071 over 1e8 rows failed it once in twelve
runs): each order rounds differently, and the difference is large against
the small result.  The bound ``RTOL * |want| + ATOL + n * 2^-52 * S`` (S the
cell's sum of |term|, n its row count) holds for any two orders, and still
refuses a sum that is off by one term.
"""

import json
import math
import re
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import vaex_tpu_torch
from vaex_tpu_torch import agg
from vaex_tpu_torch.ops import grid_moments as gm
from vaex_tpu_torch.ops import grid_window as gw


def _cancelling_cell(n=20_000, seed=11):
    """Terms x*y of one cell whose exact sum is near 0: x, y ~ N(0, 1e3),
    the last term set to minus the exact sum of the others."""
    rng = np.random.default_rng(seed)
    terms = rng.normal(0, 1e3, n) * rng.normal(0, 1e3, n)
    terms[-1] = -math.fsum(terms[:-1])
    return terms


def _ordered_sum(terms):
    """float64 sum in the order given, one add at a time."""
    total = 0.0
    for t in terms:
        total += t
    return total


def test_bound_accepts_two_orders_that_allclose_refuses():
    terms = _cancelling_cell()
    rng = np.random.default_rng(12)
    first = torch.tensor([_ordered_sum(terms)], dtype=torch.float64)
    second = torch.tensor([_ordered_sum(terms[rng.permutation(len(terms))])],
                          dtype=torch.float64)
    abs_sum = torch.tensor([np.abs(terms).sum()], dtype=torch.float64)
    count = torch.tensor([len(terms)])
    # both are correct sums of the same terms in two orders, and differ
    assert first.item() != second.item()
    assert not torch.allclose(first, second, rtol=chip_smoke.RTOL, atol=chip_smoke.ATOL)
    assert chip_smoke.within_sum_bound(first, second, abs_sum, count)
    assert chip_smoke.within_sum_bound(second, first, abs_sum, count)


def test_bound_refuses_a_sum_off_by_one_term():
    terms = _cancelling_cell()
    abs_sum = torch.tensor([np.abs(terms).sum()], dtype=torch.float64)
    count = torch.tensor([len(terms)])
    want = torch.tensor([_ordered_sum(terms)], dtype=torch.float64)
    big = int(np.argmax(np.abs(terms[:-1])))
    small = int(np.argmin(np.abs(terms[:-1]) + (np.abs(terms[:-1]) < 1) * 1e300))
    for k in (big, small):  # the largest term, and the smallest one of at least 1
        dropped = torch.tensor([_ordered_sum(np.delete(terms, k))], dtype=torch.float64)
        assert not chip_smoke.within_sum_bound(dropped, want, abs_sum, count), k


@pytest.mark.parametrize("cells", [1, 7])
def test_bound_per_cell_with_nan_and_empty_cells(cells):
    """Several cells checked at once: a NaN on both sides agrees, a NaN on
    one side does not, an empty cell holds 0 on both."""
    want = torch.zeros(2, cells + 1, dtype=torch.float64)
    abs_sums = torch.zeros_like(want)
    counts = torch.zeros(cells + 1, dtype=torch.int64)
    want[0, 0] = float("nan")
    got = want.clone()
    assert chip_smoke.within_sum_bound(got, want, abs_sums, counts)
    got[1, -1] = float("nan")
    assert not chip_smoke.within_sum_bound(got, want, abs_sums, counts)


def test_the_chip_checks_run_the_plain_versions_over_abs_terms():
    """``additive_floats_ok`` and ``moment_sums_ok`` take S from the plain
    version over |values|: on the CPU the plain version against itself, on
    reversed rows (another order), passes, and one row's value more fails."""
    gen = torch.Generator().manual_seed(5)
    n, G = 50_000, 7
    idx = torch.randint(-1, G + 1, (n,), generator=gen, dtype=torch.int32)
    x = torch.randn(n, generator=gen, dtype=torch.float64) * 1e3
    y = torch.randn(n, generator=gen, dtype=torch.float64) * 1e3
    x[::97] = float("nan")
    want_i, want_f = gw.grid_window_reference(idx, [], [x], G, True)
    got_i, got_f = gw.grid_window_reference(idx.flip(0), [], [x.flip(0)], G, True)
    assert torch.equal(got_i, want_i)
    assert chip_smoke.additive_floats_ok(gw.grid_window_reference, idx, [x], G, got_f, want_f,
                                         want_i[0])
    off = got_f.clone()
    off[0, 3] += 1.0
    assert not chip_smoke.additive_floats_ok(gw.grid_window_reference, idx, [x], G, off, want_f,
                                             want_i[0])
    plain = gm.grid_moments_window_reference
    want = plain(idx, [x, y], agg.CORR_TERMS, G)
    got = plain(idx.flip(0), [x.flip(0), y.flip(0)], agg.CORR_TERMS, G)
    assert chip_smoke.moment_sums_ok(plain, idx, [x, y], agg.CORR_TERMS, G, got, want)
    got[1][0, 2] += 1.0
    assert not chip_smoke.moment_sums_ok(plain, idx, [x, y], agg.CORR_TERMS, G, got, want)


@pytest.mark.parametrize("n", [3_000, 20_000])
def test_the_config3_phase_on_the_cpu(n):
    """Phase 17 of chip_smoke.py (BASELINE config 3) at a small size on the
    CPU: the ten H2O questions through the port's plain versions, each held
    to its plain torch answer; q10 on the one-sort route (packed at this
    size: the keys' span product is far below 2^62)."""
    import vaex_tpu_torch
    cols = chip_smoke.config3_columns(n, "cpu")
    df = vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays(cols))
    df = df.to_device("cpu")
    routes = chip_smoke.config3_drive(vaex_tpu_torch, df, n, "cpu")
    assert routes["q10"]["groupby"] == "one-sort" and routes["q10"]["mode"] == "packed"
    assert routes["q6"][0]["percentile_exact"] == "sort" and routes["q8"][0]["topk"] == "sort"


@pytest.mark.parametrize("question,column,how", [
    ("q1", "v1", "one more"), ("q5", "v3", "one more"), ("q3", "v3", "one more"),
    ("q6", "median_v3", "next value"), ("q6", "sd_v3", "relative"), ("q9", "r2", "relative"),
    ("q8", "largest2_v3", "next value"), ("q10", "id6", "one more")])
def test_the_config3_checks_refuse_a_wrong_answer(question, column, how):
    """Each check of phase 17 refuses an answer that is off: by one term in
    a sum or a key, by the next value in a median or a top-k, by 1e-6 of a
    sd or an r2."""
    import vaex_tpu_torch
    n = 20_000
    cols = chip_smoke.config3_columns(n, "cpu")
    df = vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays(cols)).to_device("cpu")
    out = chip_smoke.config3_questions(vaex_tpu_torch)[question](df)
    want = chip_smoke.config3_plain(cols, n)[question]()
    chip_smoke.config3_check(question, out, want, "cpu")
    values = out.dataset[column].clone()
    if how == "one more":
        values[0] += 1 if not values.is_floating_point() else cols["v3"][0]
    elif how == "next value":
        values[0] = torch.nextafter(values[0], torch.tensor(torch.inf, dtype=values.dtype))
    else:
        values[0] *= 1 + 1e-6
    out.dataset = vaex_tpu_torch.DatasetArrays({**dict(out.dataset.items()), column: values})
    with pytest.raises(RuntimeError, match=f"{question} {column}"):
        chip_smoke.config3_check(question, out, want, "cpu")


def _config4_frames(n_fact, n_dim):
    import vaex_tpu_torch
    fact_cols, dim_cols, ids = chip_smoke.config4_tables(n_fact, n_dim, "cpu")
    return (vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays(fact_cols)),
            vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays(dim_cols)), ids)


def test_the_config4_phase_on_the_cpu():
    """Phase 18 of chip_smoke.py (BASELINE config 4) at a small size on the
    CPU: the edges of the join against its plain torch join (every how,
    gapped and doubled keys, masked and NaN keys), then J1-J5 through the
    port's plain versions, each held to its plain torch answer."""
    import vaex_tpu_torch
    routes = chip_smoke.config4_edges(vaex_tpu_torch, "cpu", n=20_000, m=3_000)
    assert routes <= {"b6", "b6-wide"}
    fact, dim, ids = _config4_frames(50_000, 5_000)
    fact._tile_rows = 7_000  # several tiles a pass
    joined, plain, route, dtoh_ms, launches = chip_smoke.config4_drive(
        vaex_tpu_torch, fact, dim, ids, "cpu")
    assert route == "b6" and dtoh_ms is None and launches == 0
    assert len(joined) == 50_000 and int((plain < 0).sum()) == 0


@pytest.mark.parametrize("query", ["J2 sum(label)", "J3 groupby(label)", "J4 isin 10",
                                   "J5 value_counts(label)"])
def test_the_config4_checks_refuse_a_wrong_answer(query):
    """Each check of phase 18 refuses an answer off by one row or one term."""
    import vaex_tpu_torch
    fact, dim, ids = _config4_frames(20_000, 2_000)
    joined = fact.join(dim, on="key")
    plain = chip_smoke.plain_lookup(fact.dataset["key"], dim.dataset["key"])
    want = chip_smoke.config4_plain(fact.dataset, dim.dataset, plain, ids)[query]()
    got = chip_smoke.config4_queries(vaex_tpu_torch, ids)[query](fact, joined)
    chip_smoke.config4_check(query, got, want)
    if query.startswith(("J2", "J4")):
        got = got + 1
    elif query.startswith("J3"):
        x = got.dataset["x"].clone()
        x[0] += 0.5
        got.dataset = vaex_tpu_torch.DatasetArrays({**dict(got.dataset.items()), "x": x})
    else:
        got.iloc[0] += 1
    with pytest.raises(RuntimeError, match=f"config 4 {query.split()[0]}"):
        chip_smoke.config4_check(query, got, want)


# phase 19 at a small size: B3's partition cut to 64 buckets and the
# resident budget to 64 KiB, so that each grid takes the route it takes at
# full size on the card ("sort", and "b3×2" for the four std's)
PHASE19_SHAPES = {"count 12000^2": 1100, "mean 12000^2": 1100, "std 12000^2": 1100,
                  "max 8192^2": 800, "count 512^3": 100, "std of four 4096^2": 400}


@pytest.fixture
def phase19(monkeypatch):
    import vaex_tpu_torch
    from vaex_tpu_torch.ops import grid_partition as gp
    monkeypatch.setattr(gp, "P_MAX", 64)
    monkeypatch.setattr(gp, "RESIDENT_BYTES", 1 << 16)
    cols = chip_smoke.phase19_columns(20_000, "cpu")
    df = chip_smoke.phase19_frame(vaex_tpu_torch, cols)
    df._tile_rows = 7_000  # several tiles a pass, each scattered into one grid
    return vaex_tpu_torch, df, cols


def test_the_phase19_grids_on_the_cpu(phase19):
    """Phase 19 (a) of chip_smoke.py on the CPU: every grid on the route it
    takes at full size, held to its second computation."""
    vt, df, cols = phase19
    routes = chip_smoke.phase19_grids(vt, df, cols, PHASE19_SHAPES)
    assert routes == {name: grid[4] for name, grid in chip_smoke.PHASE19_GRIDS.items()}
    assert set(routes.values()) == {"sort", "b3×2"}


def test_the_phase19_row_operations_on_the_cpu(phase19):
    """Phase 19 (b) on the CPU: drops, fill, materialize, sample, shuffle,
    split_random, evaluate with a selection, to_arrays, vrange."""
    vt, df, cols = phase19
    times = chip_smoke.phase19_rows(vt, df, cols, n_sample=2_000, n_eval=5_000,
                                    n_arrays=3_000, n_range=10 ** 6)
    assert {"dropna count", "materialize", "sample sum", "vrange sum count"} <= set(times)


@pytest.mark.parametrize("name", list(PHASE19_SHAPES))
def test_the_phase19_checks_refuse_a_wrong_grid(phase19, name):
    """Each grid check of phase 19 refuses a grid one count, one value or
    one empty cell off."""
    vt, df, cols = phase19
    shape = PHASE19_SHAPES[name]
    want = chip_smoke.phase19_plain(cols, name, shape)
    got = np.array(chip_smoke.phase19_query(df, name, shape))
    chip_smoke.phase19_check(name, got, want)
    flat = got.reshape(-1)
    stat = chip_smoke.PHASE19_GRIDS[name][0]
    if stat == "count":
        flat[int(np.argmax(flat))] += 1
    elif stat == "max":
        empty = np.flatnonzero(flat == -np.inf)
        flat[empty[0]] = 0.0
    else:
        full = np.flatnonzero(~np.isnan(flat) & (flat > 0))
        flat[full[len(full) // 2]] *= 1 + 1e-6
    with pytest.raises(RuntimeError, match=re.escape(f"phase 19 {name}")):
        chip_smoke.phase19_check(name, got, want)


# phase 20 at a small size: id6 in 1..2000, and the presence cap lowered so
# that nunique of id6 per id4 (206 000 cells) takes the sorted pairs, as at
# full size, while id6 binned by id4 (126 000) stays on the presence grid
PHASE20_N, PHASE20_K6 = 20_000, 2_000


@pytest.fixture
def phase20(monkeypatch):
    import vaex_tpu_torch
    monkeypatch.setattr(agg, "NUNIQUE_PRESENCE_MAX", 150_000)
    cols = chip_smoke.phase20_columns(PHASE20_N, "cpu", k6=PHASE20_K6)
    df = chip_smoke.phase20_frame(vaex_tpu_torch, cols).to_device("cpu")
    df._tile_rows = 7_000  # several tiles a pass: the sorted pairs merge
    return vaex_tpu_torch, df, cols


def test_the_phase20_queries_on_the_cpu(phase20):
    """Phase 20 of chip_smoke.py on the CPU: every query held to its plain
    computation; the kinds of aggregation each pass recorded are the ones it
    records on the card (the routes differ at this size)."""
    vt, df, cols = phase20
    routes = chip_smoke.phase20_drive(vt, df, cols, k6=PHASE20_K6, expect_routes=False)
    assert set(routes) == set(chip_smoke.phase20_queries(vt))
    for name, expect in chip_smoke.PHASE20_EXPECT.items():
        strategies, _, _ = routes[name]
        assert set(expect) <= set(strategies[0]), (name, strategies)
    for name in chip_smoke.PHASE20_PROBES:
        assert routes[name][1] == "b6", name
    assert routes["stat mean/std by id4"][2] == 1


def _perturbed(name, answer):
    """The answer with one value off: a count by one, a float by a part in
    1e6 (a lone float also by 1e-3), a mode centre by a bin, describe's mean
    of v3."""
    if isinstance(answer, dict) and "keys" in answer:
        values = answer["values"].copy()
        values[3] += 1
        return {**answer, "values": values}
    if isinstance(answer, dict):
        k = answer["columns"].index("v3")
        mean = list(answer["mean"])
        mean[k] *= 1 + 1e-6
        return {**answer, "mean": mean}
    if np.ndim(answer) == 0:  # a float also by 1e-3: a diff's sum cancels to near 0
        if isinstance(answer, (int, np.integer)):
            return answer + 1
        return answer * (1 + 1e-6) + 1e-3
    flat = np.array(answer).reshape(-1)
    if flat.dtype.kind == "f":
        at = int(np.flatnonzero(flat != 0)[0])
        flat[at] = flat[at] + (flat[1] - flat[0] if name == "mode" else flat[at] * 1e-6)
    else:
        flat[1] += 1
    return flat.reshape(np.shape(answer))


@pytest.mark.parametrize("name", [
    "nunique id5 by id4", "nunique id6 by id4", "nunique id6 binby id4", "cov", "cov by id4",
    "mode", "mutual information", "describe", "healpix", "shift sum", "diff sum",
    "rolling sum", "rolling max", "u sum", "u minmax", "u max by id4", "u groupby count",
    "u isin", "stat mean/std by id4"])
def test_the_phase20_checks_refuse_a_wrong_answer(phase20, name):
    """Each check of phase 20 takes the port's answer and refuses it one
    count, one bin or a part in 1e6 off."""
    vt, df, cols = phase20
    answer = chip_smoke.phase20_answer(name, chip_smoke.phase20_queries(vt)[name](df))
    want = chip_smoke.phase20_plain(cols, name, PHASE20_K6)
    chip_smoke.phase20_check(name, answer, want)
    with pytest.raises(RuntimeError, match=re.escape(f"phase 20 {name}")):
        chip_smoke.phase20_check(name, _perturbed(name, answer), want)


# phase 21 at a small size: H2O's string keys, benchmarks/strings.py's
# cases, the unstaged frame and the datetimes, on the CPU
PHASE21_N = 20_000


@pytest.fixture(scope="module")
def phase21():
    from vaex_tpu_torch import settings
    previous, settings.DEVICE = settings.DEVICE, "cpu"  # the unstaged frames' passes
    host, codes, labels = chip_smoke.phase21_columns(PHASE21_N)
    df = vaex_tpu_torch.from_arrays(**host).to_device("cpu")
    plain = chip_smoke.phase21_plain_columns(host, codes, "cpu")
    strings = chip_smoke.phase21_strings_columns(PHASE21_N)
    yield df, plain, labels, strings
    settings.DEVICE = previous


def test_the_phase21_h2o_questions_on_the_cpu(phase21):
    df, plain, labels, _ = phase21
    routes = chip_smoke.phase21_h2o(vaex_tpu_torch, df, plain, labels, PHASE21_N, "cpu",
                                    expect_routes=False)
    assert routes["q10"]["groupby"] == "one-sort"
    assert routes["q1"][0]["additive"] == "b1"


@pytest.mark.parametrize("staged", [True, False])
def test_the_phase21_string_cases_on_the_cpu(phase21, staged, monkeypatch):
    from vaex_tpu_torch import settings
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    host, codes, labels = phase21[3]
    df = vaex_tpu_torch.from_arrays(**host)
    df = df.to_device("cpu") if staged else df
    stages = chip_smoke.phase21_string_cases(vaex_tpu_torch, df, torch.as_tensor(codes),
                                             torch.as_tensor(host["x"]), labels, "cpu")
    assert stages["str_len_sum"] == ["str_len(s)"]
    assert bool(stages["groupby_str_sum"]) is not staged  # the set grouper's host stage


def test_the_phase21_datetimes_on_the_cpu(monkeypatch):
    from vaex_tpu_torch import settings
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    d = chip_smoke.phase21_datetimes(PHASE21_N)
    df = vaex_tpu_torch.from_arrays(**d).to_device("cpu")
    stages = chip_smoke.phase21_datetime_cases(vaex_tpu_torch, df,
                                               torch.as_tensor(d["t"].view(np.int64)),
                                               torch.as_tensor(d["v3"]))
    assert all(stages.values())


def _label_swapped(col):
    """A dictionary column with its first two labels swapped."""
    import pyarrow as pa
    from vaex_tpu_torch.column import ColumnDictionary
    labels = col.labels.to_pylist()
    labels[0], labels[1] = labels[1], labels[0]
    return ColumnDictionary(col.codes, pa.array(labels, type=col.labels.type))


@pytest.mark.parametrize("question", ["q1", "q2", "q3", "q10"])
@pytest.mark.parametrize("how", ["swap a label", "count off by one"])
def test_the_phase21_h2o_checks_refuse_a_wrong_answer(phase21, question, how):
    df, plain, labels, _ = phase21
    out = chip_smoke.config3_questions(vaex_tpu_torch)[question](df)
    columns = {name: out.dataset[name] for name in out.get_column_names()}
    if how == "swap a label":
        columns["id1" if "id1" in columns else "id3"] = _label_swapped(
            columns["id1" if "id1" in columns else "id3"])
    else:
        name = "v1"
        columns[name] = columns[name].clone()
        columns[name][0] += 1
    wrong = vaex_tpu_torch.from_dict(columns)
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.config3_check(question, chip_smoke.phase21_as_ints(
            vaex_tpu_torch, wrong, labels, "cpu"), chip_smoke.config3_plain(
            plain, PHASE21_N)[question](), "cpu")


@pytest.mark.parametrize("name", ["groupby_str_sum", "value_counts_str", "unique_str",
                                  "isin_str_500", "str_upper", "str_contains", "str_len_sum"])
def test_the_phase21_string_checks_refuse_a_wrong_answer(phase21, name):
    import pyarrow as pa
    host, codes, labels = phase21[3]
    df = vaex_tpu_torch.from_arrays(**host).to_device("cpu")
    got = chip_smoke.phase21_string_queries(labels)[name](df)
    if name == "groupby_str_sum":
        got = vaex_tpu_torch.from_dict({"s": _label_swapped(got.dataset["s"]),
                                        "x": got.dataset["x"]})
    elif name == "value_counts_str":
        got = got.copy()
        got.iloc[0] += 1
    elif name == "unique_str":
        got = got[1:]
    elif name in ("isin_str_500", "str_len_sum"):
        got = int(got) + 1
    elif name == "str_upper":  # a wrong upper-cased label
        labels_up = got.dictionary.to_pylist()
        labels_up[0] = labels_up[0].lower()
        got = pa.DictionaryArray.from_arrays(got.indices, pa.array(labels_up))
    else:
        got = np.asarray(got).copy()
        got[0] = not got[0]
    plain = chip_smoke.phase21_string_plain(torch.as_tensor(codes), torch.as_tensor(host["x"]),
                                            labels, name)
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.phase21_string_check(name, got, plain, torch.as_tensor(codes), labels, "cpu")


@pytest.mark.parametrize("name", ["groupby_hour_mean", "year_value_counts",
                                  "days_since_min_sum", "min_astype_day"])
def test_the_phase21_datetime_checks_refuse_a_wrong_answer(name, monkeypatch):
    from vaex_tpu_torch import settings
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    d = chip_smoke.phase21_datetimes(2000)
    df = vaex_tpu_torch.from_arrays(**d).to_device("cpu")
    got = chip_smoke.phase21_datetime_queries(vaex_tpu_torch)[name](df)
    if name == "groupby_hour_mean":
        got = vaex_tpu_torch.from_dict({got.get_column_names()[0]: got.dataset[
            got.get_column_names()[0]], "v3": got.dataset["v3"] * 1.001})
    elif name == "year_value_counts":
        got = got.copy()
        got.iloc[0] -= 1
    elif name == "days_since_min_sum":
        got = got + 1
    else:
        got = got + np.timedelta64(1, "D")
    want = chip_smoke.phase21_datetime_plain(torch.as_tensor(d["t"].view(np.int64)),
                                             torch.as_tensor(d["v3"]), name)
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.phase21_datetime_check(name, got, want)


# phase 22 at a small size on the CPU: the state, the cache, progress and
# cancelling, UDFs, pickling and uint64 expressions
PHASE22_N = 20_000


def test_the_phase22_state_on_the_cpu(tmp_path):
    cols = chip_smoke.config2_columns(PHASE22_N, "cpu")
    df = chip_smoke.config2_frame(vaex_tpu_torch, cols).categorize("i", labels=range(1000))
    got, want = chip_smoke.phase22_state(vaex_tpu_torch, df, cols, str(tmp_path / "s.json"))
    chip_smoke.phase22_state_check(got, want)
    chip_smoke.config2_check(got, chip_smoke.config2_plain(cols))


def test_the_phase22_state_check_refuses_a_state_that_lost_its_filter(tmp_path):
    import json
    cols = chip_smoke.config2_columns(PHASE22_N, "cpu")
    df = chip_smoke.config2_frame(vaex_tpu_torch, cols).categorize("i", labels=range(1000))
    state = df.state_get()
    del state["selections"]["__filter__"]
    path = tmp_path / "lost.json"
    path.write_text(json.dumps(state))
    fresh = vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays(dict(cols)))
    fresh.state_load(str(path))
    with pytest.raises(RuntimeError, match="phase 22 state"):
        chip_smoke.phase22_state_check(chip_smoke.phase22_state_stats(fresh),
                                       chip_smoke.phase22_state_stats(df))


def _wide_key_frame(seed=0, n=PHASE22_N):
    rng = np.random.default_rng(seed)
    cols = {"k": torch.as_tensor(rng.integers(0, 3000, n) * chip_smoke.WIDE_FACTOR),
            "v1": torch.as_tensor(rng.integers(1, 6, n))}
    return vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays(cols)), cols


def _set_plain_check(cols):
    keys, inverse = np.unique(cols["k"].numpy(), return_inverse=True)
    sums = np.bincount(inverse, weights=cols["v1"].numpy()).astype(np.int64)

    def plain_check(out):
        chip_smoke.check(np.array_equal(out.evaluate("k"), keys)
                         and np.array_equal(out.evaluate("v1"), sums), "set grouper sums")
    return plain_check


def _set_query(df):
    return df.groupby("k").agg({"v1": "sum"})


@pytest.mark.parametrize("on,builds", [(False, [1, 1]), (True, [1, 0])])
def test_the_phase22_cache_on_the_cpu(on, builds):
    from vaex_tpu_torch import cache
    cache.clear()
    df, cols = _wide_key_frame()
    results, got = chip_smoke.phase22_twice(df, _set_query, "set-create", cache_on=on)
    chip_smoke.phase22_cache_check("set", results, got, builds, _set_plain_check(cols))
    n = 30_000
    cols3 = chip_smoke.config3_columns(n, "cpu")
    df3 = vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays(cols3))
    q10 = chip_smoke.config3_questions(vaex_tpu_torch)["q10"]
    want = chip_smoke.config3_plain(cols3, n)["q10"]()
    results, got = chip_smoke.phase22_twice(df3, q10, "one-sort", cache_on=on)
    chip_smoke.phase22_cache_check("q10", results, got, builds, lambda out: (
        chip_smoke.config3_check("q10", out, want, "cpu")))
    cache.clear()


def test_the_phase22_cache_check_refuses_a_hit_across_two_tables(monkeypatch):
    """A cache whose key aliased two tables (as a sampled fingerprint does)
    serves the first table's groupby to the second, which differs in one
    row: the check holds each run to its own table's plain answer."""
    from vaex_tpu_torch import cache
    cache.clear()
    first, _ = _wide_key_frame()
    second, cols = _wide_key_frame()
    cols["k"][4321] = 7 * chip_smoke.WIDE_FACTOR + 1  # a key no other row has
    monkeypatch.setattr(cache, "key", lambda *parts, content=True: cache.Key("aliased"))
    with cache.memory():
        _set_query(first)
    results, builds = chip_smoke.phase22_twice(second, _set_query, "set-create")
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.phase22_cache_check("set", results, builds, builds, _set_plain_check(cols))
    cache.clear()


def _progress(cancel_after=chip_smoke.PHASE22_CANCEL_AFTER):
    df, i1, x = chip_smoke.make_table(PHASE22_N, vaex_tpu_torch, "cpu")
    df._tile_rows = 3_000
    want_c, want_s = chip_smoke.plain_query(i1, x)

    def plain_ok(out):
        chip_smoke.check(torch.equal(torch.as_tensor(out["c"].tolist()), want_c)
                         and torch.allclose(torch.as_tensor(out["s"].tolist(),
                                                            dtype=torch.float64), want_s),
                         "progress groupby")
    return chip_smoke.phase22_progress(vaex_tpu_torch, df, cancel_after), plain_ok


def test_the_phase22_progress_on_the_cpu():
    got, plain_ok = _progress()
    assert got["tiles"] == 7 and got["fractions"][-1] == 1.0
    chip_smoke.phase22_progress_check(got, plain_ok)


def test_the_phase22_progress_check_refuses_a_cancelled_pass_counted_as_done():
    got, plain_ok = _progress()
    with pytest.raises(RuntimeError, match="phase 22 cancelled pass"):
        chip_smoke.phase22_progress_check({**got, "aborted": None}, plain_ok)
    with pytest.raises(RuntimeError, match="phase 22 progress fractions"):
        chip_smoke.phase22_progress_check({**got, "fractions": got["fractions"][:-1]}, plain_ok)


def test_the_phase22_udf_on_the_cpu(monkeypatch):
    from vaex_tpu_torch import multiprocessing as port_mp
    from vaex_tpu_torch import settings
    monkeypatch.setattr(settings, "NUM_PROCESSES", 2)
    cols = chip_smoke.phase22_udf_columns(PHASE22_N, "cpu")
    dfu = chip_smoke.phase22_udf_frame(vaex_tpu_torch, cols)
    got = chip_smoke.phase22_udf_answer(chip_smoke.phase22_udf_query(dfu))
    chip_smoke.phase22_udf_check(got, chip_smoke.phase22_udf_plain(cols))
    try:
        dfm = chip_smoke.phase22_udf_frame(vaex_tpu_torch, cols, multiprocessing=True)
        got_mp = chip_smoke.phase22_udf_answer(chip_smoke.phase22_udf_query(dfm))
        assert port_mp._pool._ctx.get_start_method() == "forkserver"
    finally:
        port_mp.close_pool()
    assert all(got_mp[k].tobytes() == got[k].tobytes() for k in got)
    dfu._tile_rows = 6_000
    chip_smoke.phase22_map_reduce_check(
        dfu.map_reduce(chip_smoke.phase22_tile_sum, chip_smoke.phase22_add, ["x"]), cols["x"])


def test_the_phase22_udf_check_refuses_a_result_off_by_one_row():
    cols = chip_smoke.phase22_udf_columns(PHASE22_N, "cpu")
    got = chip_smoke.phase22_udf_answer(chip_smoke.phase22_udf_query(
        chip_smoke.phase22_udf_frame(vaex_tpu_torch, cols)))
    shifted = {"x": torch.roll(cols["x"], 1), "k": cols["k"]}
    with pytest.raises(RuntimeError, match="phase 22 udf"):
        chip_smoke.phase22_udf_check(got, chip_smoke.phase22_udf_plain(shifted))
    with pytest.raises(RuntimeError, match="phase 22 map_reduce"):
        chip_smoke.phase22_map_reduce_check((float(cols["x"].sum()), PHASE22_N - 1), cols["x"])


def test_the_phase22_pickle_on_the_cpu():
    cols = chip_smoke.phase22_udf_columns(PHASE22_N, "cpu")
    df = chip_smoke.phase22_pickle_frame(vaex_tpu_torch, cols, "cpu")
    size, back = chip_smoke.phase22_pickle(df)
    assert size > PHASE22_N * 16
    chip_smoke.phase22_pickle_check(back, df, "cpu")
    lost = back.filter("x < 5", mode="replace")
    with pytest.raises(RuntimeError, match="phase 22 pickle"):
        chip_smoke.phase22_pickle_check(lost, df, "cpu")


@pytest.fixture(scope="module")
def phase22_uint64():
    cols = chip_smoke.phase20_columns(PHASE22_N, "cpu", k6=2000)
    df = chip_smoke.phase22_a14_frame(vaex_tpu_torch, cols)
    host = {"u": cols["u"].numpy().view(np.uint64), "id4": cols["id4"].numpy()}
    return df, host


@pytest.mark.parametrize("name", chip_smoke.PHASE22_A14)
def test_the_phase22_uint64_expressions_on_the_cpu(phase22_uint64, name):
    df, host = phase22_uint64
    got = chip_smoke.phase22_a14_answer(name, chip_smoke.phase22_a14_queries()[name](df))
    want = chip_smoke.phase22_a14_plain(host, name)
    chip_smoke.phase22_a14_check(name, got, want)
    if isinstance(got, dict):
        wrong = {**got, "counts": got["counts"] + np.eye(len(got["counts"]), dtype=np.int64)[1]}
    elif got.dtype.kind == "f":
        wrong = got * (1 + 1e-6)
    else:
        wrong = got + np.uint64(1)
    with pytest.raises(RuntimeError, match=re.escape(f"phase 22 {name}")):
        chip_smoke.phase22_a14_check(name, wrong, want)


# phase 23: files and the streamed pass, at a small size on the CPU

PHASE23_N = 60_001
PHASE23_TILE = 4096


@pytest.fixture
def phase23(tmp_path, monkeypatch):
    """Config 1's table on the CPU (staged), its answers, and its file
    (HDF5) opened and categorized, at 4096-row tiles."""
    from vaex_tpu_torch import settings, stream
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    stream.clear_proofs()
    vt = vaex_tpu_torch
    staged, i1, x = chip_smoke.make_table(PHASE23_N, vt, "cpu")
    values = chip_smoke.phase23_values()
    wants = chip_smoke.phase23_wants(vt, staged, values)
    path = str(tmp_path / "config1.hdf5")
    chip_smoke.phase23_export(staged, path)
    fdf = vt.open(path).categorize("i1", labels=range(chip_smoke.K))
    fdf._tile_rows = PHASE23_TILE
    return {"vt": vt, "staged": staged, "i1": i1, "x": x, "values": values, "wants": wants,
            "path": path, "fdf": fdf, "tmp": tmp_path}


@pytest.mark.parametrize("ext", ["hdf5", "arrow", "parquet"])
def test_the_phase23_queries_stream_from_each_file_on_the_cpu(phase23, ext):
    p = phase23
    path = str(p["tmp"] / f"config1.{ext}")
    chip_smoke.phase23_export(p["staged"], path)
    fdf = p["vt"].open(path).categorize("i1", labels=range(chip_smoke.K))
    fdf._tile_rows = PHASE23_TILE
    records = chip_smoke.phase23_drive(p["vt"], fdf, p["wants"], p["values"])
    assert records["groupby"]["wire"] == {"i1": "int32", "x": "float64"}
    assert records["groupby"]["ring"] == 3 and not records["groupby"]["pinned"]


def test_the_phase23_ring_key_and_formats_on_the_cpu(phase23):
    p = phase23
    vt = p["vt"]
    tiles, ring = chip_smoke.phase23_ring(vt, p["fdf"], p["wants"]["groupby"], tile_rows=257)
    assert tiles == -(-PHASE23_N // 257) and ring == 3
    chip_smoke.phase23_key_check(*chip_smoke.phase23_key_reads(vt, p["path"]))
    chip_smoke.phase23_rewrite_check(*chip_smoke.phase23_rewrite(
        vt, p["i1"].numpy()[:5000], p["x"].numpy()[:5000], str(p["tmp"] / "key.hdf5")))
    assert set(chip_smoke.phase23_formats(vt, str(p["tmp"]), "cpu", n_text=3000,
                                          n_small=2000)) == {"csv", "json", "fits", "vot"}


def test_the_phase23_checks_refuse_a_slot_read_before_its_copy(phase23, monkeypatch):
    """A tile whose slot was read before its copy landed carries the rows of
    the tile before it: the counts move."""
    from vaex_tpu_torch import stream
    real = stream.TileStream._transfer_ahead

    def stale(self):
        previous = None
        for i1, i2, columns, event in real(self):
            if previous is not None and i1 > 0 and len(previous[0]) == len(columns):
                columns = previous[1]
            previous = (columns, {k: tuple(None if t is None else t.clone() for t in v)
                                  for k, v in columns.items()})
            yield i1, i2, columns, event
    monkeypatch.setattr(stream.TileStream, "_transfer_ahead", stale)
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.phase23_drive(phase23["vt"], phase23["fdf"], phase23["wants"],
                                 phase23["values"])


def test_the_phase23_checks_refuse_a_key_narrowed_past_its_proof(phase23):
    """A proof that leaves out a raw value past 2^31 narrows it on the wire,
    where it wraps into a valid bin."""
    from vaex_tpu_torch import column, stream
    p = phase23
    vt = p["vt"]
    i1 = p["i1"].numpy().copy()
    i1[11] = 2 ** 32 + 7  # wraps to 7 as an int32
    x = p["x"].numpy()
    path = str(p["tmp"] / "wide.hdf5")
    vt.from_arrays(i1=i1, x=x).export(path)
    staged = vt.from_arrays(i1=i1, x=x).to_device("cpu").categorize(
        "i1", labels=range(chip_smoke.K))
    want = chip_smoke.phase23_answer("groupby", chip_smoke.run_query(staged, vt))
    fdf = vt.open(path).categorize("i1", labels=range(chip_smoke.K))
    fdf._tile_rows = PHASE23_TILE
    for _ in range(2):  # the true proof keeps i1 wide
        chip_smoke.phase23_check("groupby", chip_smoke.phase23_answer(
            "groupby", chip_smoke.run_query(fdf, vt)), want)
    assert chip_smoke.phase23_stream(fdf)["wire"]["i1"] == "int64"
    key = column.registered_key(fdf.dataset["i1"])[0]
    stream._proofs[key] = {"min": 0, "max": chip_smoke.K - 1}  # a proof of too little
    got = chip_smoke.phase23_answer("groupby", chip_smoke.run_query(fdf, vt))
    assert chip_smoke.phase23_stream(fdf)["wire"]["i1"] == "int32"
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.phase23_check("groupby", got, want)


def test_the_phase23_checks_refuse_a_cached_answer_after_the_file_changed(phase23,
                                                                           monkeypatch):
    """A key that names the file by its path alone serves the old file's
    answer for the rewritten one."""
    from vaex_tpu_torch import dataset
    from vaex_tpu_torch.io import arrow, hdf5
    for m in (dataset, hdf5, arrow):
        monkeypatch.setattr(m, "file_identity", lambda path, fd=None: ("file", str(path)))
    p = phase23
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.phase23_rewrite_check(*chip_smoke.phase23_rewrite(
            p["vt"], p["i1"].numpy()[:5000], p["x"].numpy()[:5000], str(p["tmp"] / "k.hdf5")))


def test_the_phase23_checks_refuse_a_cancelled_stream_that_leaves_its_thread(phase23,
                                                                             monkeypatch):
    from vaex_tpu_torch import stream
    left = []
    real = stream.TileStream.close
    monkeypatch.setattr(stream.TileStream, "close", lambda self: left.append(self))
    try:
        with pytest.raises(RuntimeError, match="check failed"):
            chip_smoke.phase23_ring(phase23["vt"], phase23["fdf"], phase23["wants"]["groupby"],
                                    tile_rows=257)
    finally:
        for s in left:
            real(s)
    assert not chip_smoke.phase23_threads()


def test_the_phase23_checks_refuse_a_file_key_that_reads_the_column(phase23, monkeypatch):
    """A column keyed by its bytes (no file key) is hashed by the cache."""
    from vaex_tpu_torch import column
    monkeypatch.setattr(column, "registered_key", lambda col: None)
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.phase23_key_check(*chip_smoke.phase23_key_reads(phase23["vt"],
                                                                   phase23["path"]))


def test_phase23_counts_only_the_launches_inside_a_streamed_query():
    """Launches outside a counted query (a staged pass) are not read; a
    streamed query whose own kernel was not launched on its tiles (a pass
    that fell to plain torch) is refused."""
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_plan as plan
    from vaex_tpu_torch.ops import probe
    counted = chip_smoke.phase23_counted(plan, gp, probe)
    b1 = plan.KERNELS[plan.B1]

    def streamed(df):
        b1.launches += 2
        return df
    b1.launches += 5  # a staged pass between two streamed ones
    assert counted("groupby", streamed, "out") == "out"
    assert counted.launches[plan.B1] == 2 and counted.launches[plan.B4] == 0
    with pytest.raises(RuntimeError, match="was not launched on the streamed tiles"):
        counted("std", streamed, "out")
    chip_smoke.zero_launches(plan, gp)


def test_the_phase23_checks_refuse_a_streamed_pass_on_the_plain_versions(phase23):
    """On the CPU every wrapper takes its plain version: no kernel counts a
    launch, so the counted drive fails at its first query."""
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_plan as plan
    from vaex_tpu_torch.ops import probe
    p = phase23
    with pytest.raises(RuntimeError, match="b1 was not launched on the streamed tiles"):
        chip_smoke.phase23_drive(p["vt"], p["fdf"], p["wants"], p["values"],
                                 run=chip_smoke.phase23_counted(plan, gp, probe))


@pytest.fixture
def wide_frame(monkeypatch):
    from vaex_tpu_torch import settings, stream
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    monkeypatch.setattr(stream, "RING_TILE_ROWS_MIN", 1)
    return chip_smoke.phase23_wide_frame(vaex_tpu_torch, n=20_001, c=30)


def test_the_phase23_wide_pass_keeps_its_ring_within_the_budget_on_the_cpu(wide_frame):
    df, names, a = wide_frame
    budget = 3 * 30 * 9 * 3000  # 3 slots of 30 columns (8 B and a mask byte) x 3000 rows
    rec = chip_smoke.phase23_wide_pass(df, names, a, budget)
    assert rec["tile_rows"] == 2048 and rec["tiles"] == -(-len(a) // 2048)
    assert 0 < rec["ring_bytes"] <= budget and not rec["pinned"]
    assert rec["rss_peak_gb"] >= rec["rss_before_gb"] > 0


def test_the_phase23_checks_refuse_a_ring_past_its_budget(wide_frame, monkeypatch):
    from vaex_tpu_torch import execution
    monkeypatch.setattr(execution, "ring_tile_rows", lambda dataset, names, rows: rows)
    df, names, a = wide_frame
    df._tile_rows = 8192
    with pytest.raises(RuntimeError, match="past its budget"):
        chip_smoke.phase23_wide_pass(df, names, a, 3 * 30 * 9 * 3000)


# ------------------------------------------------------------------ phase 24
@pytest.fixture(scope="module")
def phase24():
    frames = chip_smoke.phase24_frames(vaex_tpu_torch, "cpu", n=20_000, n_fact=20_000,
                                       n_dim=2_000)
    return frames, chip_smoke.phase24_mesh("cpu")


@pytest.mark.parametrize("shuffle_min_g", [10, 150])
def test_phase24_drive_on_the_cpu(phase24, monkeypatch, shuffle_min_g):
    """Every query of phase 24 over four CPU shards equals the single
    device's (150: config 1's groupby on the sharded pass, config 3's q3
    and q7 through the exchange, as on the card)."""
    from vaex_tpu_torch import groupby
    monkeypatch.setattr(groupby, "SHUFFLE_MIN_G", shuffle_min_g)
    frames, mesh = phase24
    records = chip_smoke.phase24_drive(vaex_tpu_torch, frames, mesh)
    assert set(records) == set(chip_smoke.PHASE24_OWN) - {"nccl c1 groupby"}
    assert records["q3"]["route"] == records["q7"]["route"] == "shuffle"
    assert records["q10"]["route"] == records["q6"]["route"] == "fused exchange"
    assert records["J1"]["route"] == "mesh" and records["J1"]["probe"] == "b6"
    assert records["c1 groupby"]["route"] == ("shuffle" if shuffle_min_g == 10
                                               else "sharded pass")


def _phase24_answers(phase24, name):
    frames, mesh = phase24
    frame, query = chip_smoke.phase24_queries(vaex_tpu_torch, frames["ids"])[name]
    want = chip_smoke.phase24_answer(query(frames[frame]))
    got = chip_smoke.phase24_answer(query(chip_smoke.phase24_sharded(frames[frame], mesh)))
    return got, want, chip_smoke.phase24_scales(frames["cols"], name, frames["n"])


@pytest.mark.parametrize("name, column", [("c1 groupby", "c"), ("c1 groupby", "s"),
                                          ("q3", "v3"), ("q6-sd", "sd_v3"), ("q7", "max_v1"),
                                          ("c1 std", "value"), ("q10", "v3")])
def test_the_phase24_checks_refuse_a_wrong_answer(phase24, name, column):
    got, want, scales = _phase24_answers(phase24, name)
    chip_smoke.phase24_check(name, got, want, scales)
    bad = dict(got)
    wrong = got[column].clone().reshape(-1)
    wrong[-1] = wrong[-1] + (1 if not wrong.is_floating_point() else 1e-6 * (1 + wrong[-1].abs()))
    bad[column] = wrong.reshape(got[column].shape)
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.phase24_check(name, bad, want, scales)


def test_phase24_counts_only_the_launches_inside_a_sharded_query():
    """Launches outside a counted query (a single-device reference) are not
    read; a sharded query whose own kernel was not launched on its shard
    tiles (a pass that fell to plain torch) is refused."""
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_plan as plan
    from vaex_tpu_torch.ops import probe
    counted = chip_smoke.phase24_counted(plan, gp, probe)
    b1 = plan.KERNELS[plan.B1]

    def sharded(df):
        b1.launches += 4
        return df
    b1.launches += 5  # a single-device reference between two sharded queries
    assert counted("c1 groupby", sharded, "out") == "out"
    assert counted.launches[plan.B1] == 4 and counted.launches[plan.B4] == 0
    with pytest.raises(RuntimeError, match="none of .*b4"):
        counted("c1 std", sharded, "out")
    assert counted("q10", lambda df: df, "out") == "out"  # the fused exchange: torch sorts
    chip_smoke.zero_launches(plan, gp)


def test_the_phase24_checks_refuse_sharded_passes_on_the_plain_versions(phase24):
    """On the CPU every wrapper takes its plain version: no kernel counts a
    launch, so the counted drive fails at its first sharded query."""
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_plan as plan
    from vaex_tpu_torch.ops import probe
    frames, mesh = phase24
    with pytest.raises(RuntimeError, match="c1 groupby: none of .*b1"):
        chip_smoke.phase24_drive(vaex_tpu_torch, frames, mesh,
                                 run=chip_smoke.phase24_counted(plan, gp, probe))


def test_the_phase24_record_refuses_exchange_bytes_off_the_formula():
    entry = {"shuffle": True, "rows_per_device": 5000, "slack": 4, "row_bytes": 24,
             "capacity": 5000, "alltoall_bytes_per_device": 4 * 5000 * 24, "strategies": {}}
    mesh = chip_smoke.phase24_mesh("cpu")
    rec = chip_smoke.phase24_record("q3", [entry], mesh, True)
    assert rec["alltoall_bytes_per_device"] == 480_000 and rec["retries"] == 0
    with pytest.raises(RuntimeError, match="exchange bytes"):
        chip_smoke.phase24_record("q3", [dict(entry, alltoall_bytes_per_device=1)], mesh, True)
    with pytest.raises(RuntimeError, match="no shuffle ran"):
        chip_smoke.phase24_record("q3", [], mesh, True)


def test_phase24_gloo_runs_two_processes_on_the_cpu():
    """The gloo leg's two processes as phase 24 starts them, on CPU tensors:
    every collective takes them, the groupby merges across the processes
    and its answer passes the verdict."""
    records = chip_smoke.phase24_gloo(n=2000, timeout=120, device="cpu")
    assert chip_smoke.phase24_gloo_verdict(records) == {"ran": True}
    assert all(set(r["collectives"].values()) == {"ok"} for r in records)
    assert all(r["merge_world"] == 2 for r in records)


_GLOO_OK = {"collectives": dict.fromkeys(
    ("reduce", "total", "extreme", "gather", "objects", "broadcast", "all_to_all"), "ok"),
    "merge_world": 2, "counts_exact": True, "sums_within_bound": True, "rc": 0}


@pytest.mark.parametrize("bad, message", [
    ({"counts_exact": False}, "is wrong"),
    ({"sums_within_bound": False}, "is wrong"),
    ({"counts_exact": None}, "is wrong"),
    ({"merge_world": 1}, "did not cross"),
    ({"rc": 1}, "a process failed"),
    ("failed", "a process failed"),
    ("missing", "records of 2"),
    ("one refuses", "refused the tensors"),
])
def test_the_phase24_gloo_verdict_refuses(bad, message):
    """A wrong count or sum, a merge that stayed in one process, a worker
    that crashed or exited non-zero, a missing worker, or a refusal one
    process alone saw: each fails phase 24."""
    if bad == "failed":
        records = [_GLOO_OK, {"failed": "Traceback ... RuntimeError", "rc": -6}]
    elif bad == "missing":
        records = [_GLOO_OK]
    elif bad == "one refuses":
        refused = dict(_GLOO_OK["collectives"], all_to_all="RuntimeError: no CUDA")
        records = [_GLOO_OK, {"collectives": refused, "rc": 0}]
    else:
        records = [_GLOO_OK, {**_GLOO_OK, **bad}]
    with pytest.raises(RuntimeError, match=message):
        chip_smoke.phase24_gloo_verdict(records)


def test_the_phase24_gloo_verdict_names_a_refused_collective():
    """A collective that refused the card's tensors in both processes fails
    the phase, named in the failure: the port's collectives carry a CUDA
    tensor through host memory under gloo, so the leg is never left out."""
    refused = dict(_GLOO_OK["collectives"], all_to_all="RuntimeError: no CUDA")
    records = [{"collectives": refused, "rc": 0}] * 2
    with pytest.raises(RuntimeError, match="refused the tensors.*all_to_all"):
        chip_smoke.phase24_gloo_verdict(records)
    assert chip_smoke.phase24_gloo_verdict([_GLOO_OK, _GLOO_OK])["ran"] is True


# ------------------------------------------------------------------ phase 28
@pytest.fixture(scope="module")
def phase28():
    """Phase 28's two processes on CPU tensors at a small size, the
    all-to-all groupby reached at its 200 groups."""
    return chip_smoke.phase28_run(n=20_000, n_fact=20_000, n_dim=2_000, device="cpu", reps=0,
                                  timeout=240, env={"VAEX_TPU_TORCH_SHUFFLE_MIN_G": "10"})


def test_phase28_runs_two_processes_on_the_cpu(phase28):
    """Every query of phase 28 in both processes equals the single device's
    over the whole tables and took its route with world 2; on the CPU no
    kernel counts a launch, so the card's verdict refuses it."""
    assert chip_smoke.phase28_verdict(phase28, kernels=False) == {"ok": True}
    for r in phase28:
        assert r["rc"] == 0 and set(r["collectives"].values()) == {"ok"}
        assert {n: q["route"] for n, q in r["queries"].items()} == chip_smoke.PHASE28_ROUTES
        assert all(q["worlds"] == [2] and q["ok"] for q in r["queries"].values())
    with pytest.raises(RuntimeError, match="launched none of"):
        chip_smoke.phase28_verdict(phase28)


def _phase28_bad(phase28, bad):
    import copy
    records = copy.deepcopy(phase28)
    r = records[1]
    if bad == "refused":
        r["collectives"]["all_to_all"] = "RuntimeError: no CUDA"
    elif bad == "exit":
        r["rc"] = 1
    elif bad == "no result":
        records[1] = {"failed": "Traceback ... RuntimeError", "rc": -6}
    elif bad == "wrong row":
        r["queries"]["J1 left"].update(ok=False, error="check failed: the rows differ")
    elif bad == "world 1":
        r["queries"]["q3"]["worlds"] = [1]
    elif bad == "fallback":
        r["queries"]["J1 inner"]["fallback"] = [{"join": "broadcast", "reason": "skew"}]
    elif bad == "missing query":
        del r["queries"]["q10"]
    return records


@pytest.mark.parametrize("bad, message", [
    ("refused", "refused the tensors"), ("exit", "a process failed"),
    ("no result", "a process failed"), ("wrong row", "J1 left"),
    ("world 1", "did not take its route"), ("fallback", "did not take its route"),
    ("missing query", "ran"),
])
def test_the_phase28_verdict_refuses(phase28, bad, message):
    """A refused collective, a worker's non-zero exit or missing result, a
    wrong row, a route that stayed in one process or fell back, a query not
    run: each fails phase 28."""
    with pytest.raises(RuntimeError, match=message):
        chip_smoke.phase28_verdict(_phase28_bad(phase28, bad), kernels=False)


@pytest.mark.parametrize("column", ["key", "x", "label", "mask"])
def test_the_phase28_join_check_refuses_a_wrong_row(column):
    """The join's rows against the single device's, row for row: one wrong
    key, value or label, or one row matched where it was not, fails; the
    inner join keeps the matched rows alone."""
    rng = np.random.default_rng(3)
    want = {"key": torch.as_tensor(rng.integers(0, 50, 40)), "x": torch.as_tensor(rng.random(40)),
            "label": torch.as_tensor(rng.integers(0, 9, 40)),
            "mask": torch.as_tensor(rng.random(40) < 0.2)}
    got = {k: v.clone() for k, v in want.items()}
    chip_smoke.phase28_check_join("J1 left", got, want)
    keep = ~want["mask"]
    chip_smoke.phase28_check_join("J1 inner", {"key": want["key"][keep], "x": want["x"][keep],
                                               "label": want["label"][keep], "mask": None}, want)
    row = int(torch.nonzero(keep)[0])
    if column == "mask":
        got["mask"][row] = True
    else:
        got[column][row] += 1
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.phase28_check_join("J1 left", got, want)


def test_compare_smoke_logs_reads_every_time_and_flags_a_move(tmp_path):
    """scripts/compare_smoke_logs.py: a text line's repetitions, a phase's
    and a kernel's ms read from each log; a time past max(tol, the parents'
    spread) flagged, one inside it not."""
    import importlib.util
    import json
    spec = importlib.util.spec_from_file_location(
        "compare_smoke_logs", chip_smoke.HERE + "/scripts/compare_smoke_logs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def log(name, q_s, phase_ms, kernel_ms):
        path = tmp_path / name
        path.write_text(
            f"[card, 700.00 W] config 3 q1 N=100: median {q_s} s (port) vs 0.1 s (plain torch), "
            f"reps 3; port s [{q_s}, {q_s}, {q_s}]; plain s [0.1, 0.1, 0.1]\n"
            + json.dumps({"phase23": {"queries": {"std": {"streamed_ms": phase_ms}}}}) + "\n"
            + json.dumps({"kernels": [{"name": "grid_additive", "ms": kernel_ms}]}) + "\n")
        return str(path)
    parents = [log("p1", 0.010, 50.0, 0.55), log("p2", 0.010, 52.0, 0.56)]
    changes = [log("c1", 0.013, 51.0, 0.555), log("c2", 0.013, 51.5, 0.555)]
    rows = {r["name"]: r for r in mod.compare([mod.times(p) for p in parents],
                                              [mod.times(c) for c in changes], 0.05)}
    assert set(rows) == {"text/config 3 q1 N=100", "phase23/queries/std/streamed_ms",
                         "kernels/grid_additive/ms"}
    assert rows["text/config 3 q1 N=100"]["moved"]
    assert abs(rows["text/config 3 q1 N=100"]["ratio"] - 1.3) < 1e-9
    assert not rows["phase23/queries/std/streamed_ms"]["moved"]
    assert not rows["kernels/grid_additive/ms"]["moved"]
    assert rows["text/config 3 q1 N=100"]["change_wins"] == 0
    assert rows["phase23/queries/std/streamed_ms"]["change_wins"] == 1
    # scripts/time_queries.py's line, four pairs
    sets = []
    for i, ms in enumerate([10.0, 9.9, 10.5, 10.8, 10.2, 10.1, 10.4, 10.6]):
        path = tmp_path / f"q{i}"
        path.write_text(json.dumps({"card": "c", "set": "pass", "queries": {
            "staged std": {"median_ms": ms, "ms": [ms, ms]}}}) + "\n")
        sets.append(mod.times(str(path)))
    row, = mod.compare(sets[0::2], sets[1::2], 0.05)
    assert row["name"] == "pass/staged std/median_ms"
    assert row["change_wins"] == 2 and row["pairs"] == 4 and row["parent_iqr"] > 0


# ------------------------------------------------------------------ phase 25
@pytest.fixture(scope="module")
def phase25():
    from vaex_tpu_torch import cache
    cols = chip_smoke.phase25_columns(20_000, "cpu")
    df = chip_smoke.phase25_frame(vaex_tpu_torch, cols)
    with cache.off():
        answers, reqs, extra = chip_smoke.phase25_drive(vaex_tpu_torch, df, cols, "cpu")
    return cols, df, answers, reqs, extra


def test_phase25_drive_on_the_cpu(phase25):
    """Every request of phase 25 through the server and the accessors on
    the CPU equals plain torch (phase25_drive raises where one does not)."""
    cols, df, answers, reqs, _ = phase25
    assert set(answers) == set(reqs) == set(PHASE25_REQUESTS)
    assert answers["linked views"]["passes"] == 1
    assert answers["progress"][-1] == 1.0
    assert answers["401"] == 401 and answers["dataset"]["rows"] == 20_000
    assert answers["400"] == [400, 0]
    assert sum(map(sum, answers["heatmap ra dec"]["values"])) >= 20_000 - 2
    from vaex_tpu_torch.ops import grid_partition, grid_plan
    assert set(chip_smoke.PHASE25_KERNELS) <= set(chip_smoke.launch_counts(grid_plan,
                                                                          grid_partition))


def _wrong(name, got):
    """``got`` with one thing wrong in it, the way a fault would show."""
    got = json.loads(json.dumps(got, default=lambda a: a.tolist())) if name in (
        "dataset", "histogram x", "histogram x filtered", "heatmap ra dec", "heatmap POST",
        "graphql") else got
    if name == "dataset":
        got["rows"] += 1
    elif name == "401":
        got = 200
    elif name == "400":
        got = [200, 1]
    elif name.startswith("histogram"):
        got["values"][int(np.argmax(got["values"]))] += 1
    elif name.startswith("heatmap"):
        got["values"][3][4] += 1
    elif name in ("count r", "astro count l b", "_what_grid"):
        got = np.array(got)
        got.flat[int(np.argmax(got))] -= 1
    elif name == "minmax r":
        got = np.array(got) * (1 + 2.0 ** -50)
    elif name in ("geo inside_polygon", "cancel then count"):
        got = got + 1
    elif name in ("std parallax", "mean r"):
        got = got * (1 + 1e-7)
    elif name == "correlation":
        got = got + 1e-8
    elif name == "groupby":
        got = dict(got, n=np.array(got["n"]) + np.eye(len(got["n"]), dtype=np.int64)[5])
    elif name == "graphql":
        got["df"]["groupby"]["key"]["mean"]["x"][7] *= 1 + 1e-7
    elif name == "progress":
        got = [0.5, 0.25, 1.0]
    elif name == "linked views":
        got = dict(got, passes=2)
    return got


PHASE25_REQUESTS = ["dataset", "401", "400", "histogram x", "histogram x filtered", "heatmap ra dec",
                    "heatmap POST", "std parallax", "groupby", "count r", "mean r", "minmax r",
                    "correlation", "progress", "cancel then count", "graphql", "linked views",
                    "astro count l b", "geo inside_polygon", "_what_grid"]


@pytest.mark.parametrize("name", PHASE25_REQUESTS)
def test_the_phase25_checks_refuse_a_wrong_answer(phase25, name):
    cols, _, answers, _, extra = phase25
    want = (chip_smoke.phase25_linked_plain(cols) if name == "linked views" else None
            if name == "progress" else chip_smoke.phase25_plain(cols, name, extra.get(name)))
    chip_smoke.phase25_check(name, answers[name], want)
    with pytest.raises(RuntimeError, match="phase 25"):
        chip_smoke.phase25_check(name, _wrong(name, answers[name]), want)


def test_the_phase25_checks_refuse_more(phase25):
    cols, _, answers, _, extra = phase25
    groupby = answers["groupby"]
    want = chip_smoke.phase25_plain(cols, "groupby")
    off = np.array(groupby["s"], dtype=np.float64)
    off[3] += 1e-6 * abs(off[3]) + 1e-9
    with pytest.raises(RuntimeError, match="sums"):
        chip_smoke.phase25_check("groupby", dict(groupby, s=off), want)
    with pytest.raises(RuntimeError, match="progress"):
        chip_smoke.phase25_check("progress", [0.5], None)
    l_, b_ = extra["astro count l b"]
    want = chip_smoke.phase25_eq2gal(cols["ra"], cols["dec"])
    chip_smoke.phase25_check("astro l b", (l_, b_), want)
    with pytest.raises(RuntimeError, match="1e-12 rad"):
        chip_smoke.phase25_check("astro l b", (l_, b_ + 1e-9), want)
    views = answers["linked views"]
    hist = views["hist"].copy()
    hist[1, 10] += 1
    with pytest.raises(RuntimeError, match="hist"):
        chip_smoke.phase25_check("linked views", dict(views, hist=hist),
                                 chip_smoke.phase25_linked_plain(cols))


def test_phase25_times_cli_and_optional_parts_on_the_cpu(phase25, monkeypatch, capsys):
    cols, df, _, reqs, extra = phase25
    from vaex_tpu_torch import cache
    with cache.off():
        times = chip_smoke.phase25_time(reqs, cols, extra, reps=1)
    assert set(times) == set(reqs) - {"401", "400", "progress", "cancel then count"}
    assert all(t["served_ms"] > 0 and t["plain_ms"] > 0 for t in times.values())
    assert "direct_ms" in times["linked views"] and "direct_ms" not in times["_what_grid"]
    seconds = chip_smoke.phase25_cli(vaex_tpu_torch, cols, n=2_000, device="cpu")
    assert set(seconds) == {"meta", "stat", "convert"}
    monkeypatch.setattr(chip_smoke, "PHASE25_COLUMNS", {**chip_smoke.PHASE25_COLUMNS, "z": "f8"})
    with pytest.raises(RuntimeError, match="CLI meta"):
        chip_smoke.phase25_cli(vaex_tpu_torch, cols, n=2_000, device="cpu")
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "tornado", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = chip_smoke.phase25_optional(vaex_tpu_torch, df, cols, "cpu")
    assert out == {"tornado": "not installed: tornado", "matplotlib": "not installed: matplotlib"}
    assert "phase 25 tornado: not installed: tornado" in capsys.readouterr().out


# ------------------------------------------------------------------ phase 26
@pytest.fixture(scope="module")
def phase26():
    from vaex_tpu_torch import cache
    n = 20_000
    cols = chip_smoke.phase26_columns(n, "cpu")
    df = chip_smoke.phase26_frame(vaex_tpu_torch, cols)
    with cache.off():
        st, steps, answers = chip_smoke.phase26_drive(vaex_tpu_torch, df, cols, n)
    return st, steps, answers


PHASE26_STEPS = ["standard_scaler", "pca", "kmeans", "predict", "scalers", "encoders",
                 "target encoders", "metrics"]


def test_phase26_drive_on_the_cpu(phase26):
    """Every step of phase 26 on the CPU equals plain torch (phase26_drive
    raises where one does not); the pipeline's columns went through the
    state."""
    st, steps, answers = phase26
    assert list(steps) == PHASE26_STEPS and set(answers) == set(PHASE26_STEPS) | {"state"}
    assert 1 < answers["kmeans"]["iterations"] <= chip_smoke.PHASE26_KMEANS["max_iter"]
    assert answers["predict"]["rows differing without a tie"] == 0
    assert answers["predict"]["counts"].sum() == st["n"]
    assert answers["encoders"]["labels key"] == list(range(chip_smoke.PHASE26_K))
    assert answers["state"]["columns"] == 34
    assert all(isinstance(t, torch.Tensor) for t in st["cols"].values())


def _wrong26(value):
    """``value`` with its first number (or string) off by more than any rule
    of phase26_check allows."""
    if isinstance(value, str):
        return value + "x"
    if isinstance(value, (int, np.integer)):
        return value + 1
    if isinstance(value, (float, np.floating)):
        return value + 1e-3 * (1 + abs(value))
    if isinstance(value, dict):
        raise TypeError(value)
    out = np.array(value, dtype=object if isinstance(value, list) and isinstance(
        np.ravel(np.asarray(value, dtype=object))[0], str) else None)
    flat = out.reshape(-1)
    flat[0] = _wrong26(flat[0].item() if hasattr(flat[0], "item") else flat[0])
    return out


@pytest.mark.parametrize("name", PHASE26_STEPS)
def test_the_phase26_checks_refuse_a_wrong_answer(phase26, name):
    _, steps, answers = phase26
    want = steps[name][1]()
    chip_smoke.phase26_check(name, answers[name], want)
    for key in want:
        wrong = dict(answers[name], **{key: _wrong26(answers[name][key])})
        with pytest.raises(RuntimeError, match=f"phase 26 {name}: {key}"):
            chip_smoke.phase26_check(name, wrong, want)
    with pytest.raises(RuntimeError, match="no "):
        chip_smoke.phase26_check(name, {}, want)


def test_the_phase26_state_check_refuses_a_wrong_sum(phase26):
    st, _, _ = phase26
    names = [c for c in st["df"].get_column_names()
             if c not in st["cols"] and not c.startswith("__")]
    got = chip_smoke.phase26_state(vaex_tpu_torch, st["df"], st["cols"], names)
    want = {"sums": (got["sums"], "close")}
    chip_smoke.phase26_check("state", got, want)
    with pytest.raises(RuntimeError, match="phase 26 state: sums"):
        chip_smoke.phase26_check("state", {"sums": _wrong26(got["sums"])}, want)


def test_phase26_host_legs_and_times_on_the_cpu(phase26, monkeypatch):
    from vaex_tpu_torch import settings
    monkeypatch.setattr(settings, "DEVICE", "cpu")  # where KMeans's transform assigns
    st, steps, _ = phase26
    legs, missing = chip_smoke.phase26_host_legs(vaex_tpu_torch, st, n_host=5_000,
                                                 n_sklearn=3_000, batch=1_000)
    assert list(legs) == ["kmeans transform", "river predict", "sklearn predict"]
    assert missing == []
    times = chip_smoke.phase26_time({**legs, "standard_scaler": steps["standard_scaler"]},
                                    reps=1)
    assert all(t["port_ms"] > 0 and t["plain_ms"] > 0 for t in times.values())
    monkeypatch.setitem(sys.modules, "sklearn", None)
    legs, missing = chip_smoke.phase26_host_legs(vaex_tpu_torch, st, n_host=5_000,
                                                 n_sklearn=3_000, batch=1_000)
    assert missing == ["sklearn"] and "sklearn predict" not in legs


def test_phase26_lloyd_refuses_centroids_off_by_one_row(phase26):
    """The centroid bound (the plain sums' bound over the count) refuses a
    centroid that moved by one row's share."""
    st, steps, answers = phase26
    want = steps["kmeans"][1]()
    got = dict(answers["kmeans"])
    centroids = np.array(got["centroids"])
    counts = answers["predict"]["counts"]
    centroids[0] += np.abs(centroids[0]).max() / max(int(counts.max()), 1)
    with pytest.raises(RuntimeError, match="centroids"):
        chip_smoke.phase26_check("kmeans", dict(got, centroids=centroids), want)


def test_the_phase27_drive_on_the_cpu():
    """Phase 27 at a small size: a write through ``.data`` seen by the next
    unique, int means, stds, corr and cov far from zero against plain
    torch, the std by g on B4's plain version and the corr by g2 on B5's."""
    cols = chip_smoke.phase27_columns(60_000, "cpu")
    df = chip_smoke.phase27_frame(vaex_tpu_torch, cols)
    strategies = chip_smoke.phase27_drive(vaex_tpu_torch, df, cols)
    assert strategies["std by g"]["moments"] == "b4"
    assert strategies["corr by g2"]["moments"] == "b5"
    assert 100 + 7 in df.unique("i1")


def test_the_phase27_checks_refuse_a_stale_unique(monkeypatch):
    cols = chip_smoke.phase27_columns(5_000, "cpu")
    df = chip_smoke.phase27_frame(vaex_tpu_torch, cols)
    stale = torch.unique(cols["i1"]).tolist()
    monkeypatch.setattr(type(df), "unique", lambda self, *args, **kwargs: list(stale))
    with pytest.raises(RuntimeError, match="after a write through .data"):
        chip_smoke.phase27_drive(vaex_tpu_torch, df, cols)
    with pytest.raises(RuntimeError, match="phase 27 std"):
        chip_smoke.phase27_check("std", [1.0], [1.0 + 2e-6])


def test_the_phase27_old_channels_are_the_old_ones():
    """The timing's old channels give the old answers: the wrapped int mean
    and the raw-moment std far from zero."""
    cols = chip_smoke.phase27_columns(5_000, "cpu")
    df = chip_smoke.phase27_frame(vaex_tpu_torch, cols)
    new_mean, new_std = float(df.mean("x62")), float(df.std("y"))
    with chip_smoke.phase27_old_channels():
        old_mean, old_std = float(df.mean("x62")), float(df.std("y"))
    assert abs(old_mean - new_mean) > 1e18 and abs(old_std / new_std - 1) > 1e-3
    assert float(df.mean("x62")) == new_mean


def test_the_phase29_drive_on_the_cpu():
    """Phase 29 at a small size: every call with vaex_tpu's keyword
    arguments bit-equal to the call without them and equal to plain torch;
    the delayed groupby, then the two delayed statistics in one pass."""
    cols = chip_smoke.phase29_columns(20_000, "cpu")
    df = chip_smoke.phase29_frame(vaex_tpu_torch, cols)
    assert chip_smoke.phase29_drive(vaex_tpu_torch, df, cols) == 2  # the groupby's, the stats'


@pytest.mark.parametrize("name", ["minmax progress", "groupby agg delay", "binby agg merge",
                                  "unique delay axis progress"])
def test_the_phase29_checks_refuse_a_call_unlike_its_no_argument_form(name, monkeypatch):
    """A call whose answer with the arguments is not the no-argument call's
    fails the phase, though each alone is right."""
    cols = chip_smoke.phase29_columns(5_000, "cpu")
    df = chip_smoke.phase29_frame(vaex_tpu_torch, cols)
    calls = chip_smoke.phase29_calls(vaex_tpu_torch)
    with_arguments, without = calls[name]

    def nudged(frame):
        out = chip_smoke.phase29_value(with_arguments(frame))
        if isinstance(out, dict):
            return {k: (v + 1 if v.dtype.kind in "iu" else v) for k, v in out.items()}
        return np.nextafter(np.asarray(out, dtype=np.float64), np.inf) if np.asarray(
            out).dtype.kind == "f" else np.asarray(out) + 1
    monkeypatch.setattr(chip_smoke, "phase29_calls",
                        lambda vt: {name: (nudged, without)})
    with pytest.raises(RuntimeError, match=f"phase 29 {name}: with the arguments"):
        chip_smoke.phase29_drive(vaex_tpu_torch, df, cols)
    for got, alone in ((np.float64(1.0), np.float64(1.0 + 2 ** -52)),
                       (np.array([0.0]), np.array([-0.0])), (np.int64(3), np.int32(3)),
                       ({"c": np.arange(3)}, {"c": np.arange(1, 4)}), ("float64", "float32")):
        with pytest.raises(RuntimeError, match="phase 29 x: with the arguments"):
            chip_smoke.phase29_check_same("x", got, alone)
    chip_smoke.phase29_check_same("x", {"c": np.arange(3)}, {"c": np.arange(3)})


def test_the_phase29_checks_refuse_a_wrong_answer():
    with pytest.raises(RuntimeError, match="phase 29 count"):
        chip_smoke.phase29_check("count", 99, 100, 0, 0)
    with pytest.raises(RuntimeError, match="phase 29 std"):
        chip_smoke.phase29_check("std", 1.0 + 2e-9, 1.0)
    chip_smoke.phase29_check("std", 1.0 + 5e-10, 1.0)


@pytest.mark.parametrize("missing", [None, "b1", "b2", "b4", "b6", "all"])
def test_the_phase29_verdict_refuses_a_phase_without_its_kernels(missing):
    launches = {"b1": 3, "b2": 2, "b3": 0, "b4": 4, "b5": 0, "b6": 1, "b6-wide": 0}
    if missing is None:
        chip_smoke.phase29_verdict(launches)
        return
    launches = {k: 0 for k in launches} if missing == "all" else dict(launches, **{missing: 0})
    with pytest.raises(RuntimeError, match="phase 29"):
        chip_smoke.phase29_verdict(launches)


def test_the_phase30_drive_on_the_cpu():
    """Phase 30 at a small size: every query on one device and the one-sort
    ones over four CPU shards against plain torch, NaN and infinities
    exact, then each kernel's plain version on the same columns."""
    from vaex_tpu_torch import cache
    from vaex_tpu_torch.ops import grid_extreme as ge
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_plan as plan
    n = 20_000
    cols = chip_smoke.phase30_columns(n, "cpu")
    frames = chip_smoke.phase30_frames(vaex_tpu_torch, cols)
    with cache.off():
        routes = chip_smoke.phase30_drive(vaex_tpu_torch, frames, cols, n, "cpu",
                                          mesh=chip_smoke.phase24_mesh("cpu"),
                                          expect_routes=False)
    assert routes["q10 keys"]["mode"] == "packed" and routes["k1e6"]["groups"] == n // 100
    assert routes["k1e6 on the mesh"]["fused_mesh_groupby"] is True
    assert set(routes) == set(chip_smoke.PHASE30_QUERIES) | {
        f"{q} on the mesh" for q in chip_smoke.PHASE30_SORTED}
    chip_smoke.phase30_kernels_vs_plain(plan, gp, ge, gm, agg, cols)


def test_the_phase30_plain_answers_are_numpy_s():
    """phase30_plain per group against numpy's nan-functions over the
    special floats the tests use (the same strides as phase30_special)."""
    from torch_port_helpers import assert_special, numpy_stat, special_floats
    rng = np.random.default_rng(30)
    n, G = 3000, 200
    key = rng.integers(0, G, n)
    for dtype in (np.float64, np.float32):
        x = special_floats(n, dtype, seed=30)
        t = torch.from_numpy(rng.normal(0, 10, n).astype(dtype))
        assert np.array_equal(np.isnan(chip_smoke.phase30_special(t).numpy()), np.isnan(x))
        cell, observed = torch.from_numpy(key), torch.arange(G)
        for stat in chip_smoke.PHASE30_STATS:
            got = chip_smoke.phase30_plain(cell, observed, torch.from_numpy(x), stat)
            assert_special(got.numpy(), [numpy_stat(x[key == g], stat) for g in range(G)],
                           f"{dtype.__name__} {stat}")


def test_the_phase30_checks_refuse_a_wrong_special_value():
    inf, nan = float("inf"), float("nan")
    want = torch.tensor([nan, inf, -inf, 1.0, 0.0], dtype=torch.float64)
    chip_smoke.phase30_check("x", want.clone(), want)
    chip_smoke.phase30_check("x", want.clone().to(torch.float32), want)
    chip_smoke.phase30_check("x", torch.tensor([nan, inf, -inf, 1.0 + 5e-10, -0.0]), want)
    for wrong in ([1.0, inf, -inf, 1.0, 0.0], [nan, -inf, -inf, 1.0, 0.0],
                  [nan, inf, -1.7976931348623157e308, 1.0, 0.0], [nan, inf, -inf, 1.0 + 2e-9, 0.0],
                  [nan, inf, -inf, 1.0, 1e-300], [nan, nan, -inf, 1.0, 0.0]):
        with pytest.raises(RuntimeError, match="phase 30 x"):
            chip_smoke.phase30_check("x", torch.tensor(wrong, dtype=torch.float64), want)
    with pytest.raises(RuntimeError, match="phase 30 n: ints"):
        chip_smoke.phase30_check("n", torch.tensor([1, 2]), torch.tensor([1, 3]))
    # a sum whose finite terms overflow beside -inf: NaN or -inf, never finite
    ambiguous = torch.tensor([False, False, True, False, False])
    chip_smoke.phase30_check("x", torch.tensor([nan, inf, nan, 1.0, 0.0]), want, ambiguous)
    with pytest.raises(RuntimeError, match="phase 30 x"):
        chip_smoke.phase30_check("x", torch.tensor([nan, inf, 5.0, 1.0, 0.0]), want, ambiguous)


def test_the_phase30_ambiguous_cells():
    """A cell of two largest floats and -inf is order-dependent; one largest
    float and -inf, or two largest and no infinity, is not."""
    big = float(np.finfo(np.float64).max)
    x = torch.tensor([big, big, float("-inf"), big, float("-inf"), big, big, 1.0],
                     dtype=torch.float64)
    cell = torch.tensor([0, 0, 0, 1, 1, 2, 2, 2])
    got = chip_smoke.phase30_ambiguous(cell, torch.arange(3), x)
    assert got.tolist() == [True, False, False]
    assert not chip_smoke.phase30_ambiguous(cell, torch.arange(3), x.to(torch.float32)).any()


@pytest.mark.parametrize("missing", [None, *chip_smoke.PHASE30_KERNELS])
def test_the_phase30_verdict_refuses_a_phase_without_its_kernels(missing):
    launches = {name: 2 for name in chip_smoke.PHASE30_KERNELS}
    if missing is None:
        chip_smoke.phase30_verdict(launches)
        return
    with pytest.raises(RuntimeError, match=f"phase 30: \\['{missing}'\\]"):
        chip_smoke.phase30_verdict(dict(launches, **{missing: 0}))


def test_the_phase31_drive_on_the_cpu(monkeypatch):
    """Phase 31 at a small size: std, var and cov of the columns at per-group
    offsets from 0 to 1e12 (an outlier of 1e10 in row 0) binned, per group
    and over four CPU shards on the all-to-all, each taking a second pass
    and held to plain torch's two-pass answer within 1e-6; config 2's group,
    df.std, q6-sd and q9 take none; B4 and B5 with a table a cell against
    their plain versions."""
    from vaex_tpu_torch import cache, groupby
    from vaex_tpu_torch.ops import grid_plan as plan
    monkeypatch.setattr(groupby, "SHUFFLE_MIN_G", 1)  # the card's id3 passes it
    n = 20_000
    cols = chip_smoke.phase31_columns(n, "cpu")
    df = chip_smoke.phase31_frame(vaex_tpu_torch, cols)
    with cache.off():
        routes = chip_smoke.phase31_drive(vaex_tpu_torch, df, cols, n, "cpu",
                                          mesh=chip_smoke.phase24_mesh("cpu"),
                                          expect_routes=False)
        well = chip_smoke.phase31_well_conditioned(vaex_tpu_torch, df,
                                                   chip_smoke.config2_columns(n, "cpu"))
    assert len(routes) == 6 and all(passes > 0 for _, passes in routes.values())
    assert set(well) == {"config 2 group", "df.std(v3)", "q6-sd", "q9"}
    chip_smoke.phase31_kernels_vs_plain(plan, cols)


def test_the_phase31_checks_refuse_a_wrong_answer():
    """phase31_check refuses a cell one part in 1e5 off, and the plain
    covariance is numpy's."""
    rng = np.random.default_rng(31)
    cell = torch.from_numpy(rng.integers(0, 5, 500))
    x, y = (torch.from_numpy(rng.normal(1e6, 1, 500)) for _ in range(2))
    want = chip_smoke.phase31_plain_cov(cell, torch.arange(5), x, y)
    for g in range(5):
        keep = (cell == g).numpy()
        assert np.isclose(float(want[g]), np.cov(x.numpy()[keep], y.numpy()[keep], ddof=0)[0, 1],
                          rtol=1e-9)
    chip_smoke.phase31_check("same", want.clone(), want)
    with pytest.raises(RuntimeError, match="phase 31"):
        chip_smoke.phase31_check("off", want * (1 + 1e-5), want)


def test_the_phase31_reproducers_on_the_cpu():
    """C26-C28 at a small size: std of x binned by k, std and var per group
    on one device, by a wide key (the one-sort plan) and through the
    all-to-all over four CPU shards, each held to plain torch's answer with
    no absolute slack; C26 takes a further pass on every classic route,
    C28's clock no second one (its shift subtracts exactly), and no cell is
    left unsettled."""
    from vaex_tpu_torch import cache
    with cache.off():
        out = chip_smoke.phase31_cases(vaex_tpu_torch, 20_000, "cpu",
                                       mesh=chip_smoke.phase24_mesh("cpu"), reps=0)
    assert set(out) == set(chip_smoke.PHASE31_CASES)
    assert all(set(q) == {"binned std", "groupby", "groupby by kw", "groupby, all-to-all"}
               for q in out.values())
    # the one-sort plan (by kw) takes two passes a segment, never a table
    classic = [label for label in out["c26"] if label != "groupby by kw"]
    assert all(out["c26"][label]["further_passes"] > 0 for label in classic)
    assert all(out["c27 int64"][label]["second_passes"] > 0 for label in classic)
    assert all(q["second_passes"] == 0 for q in out["c28 uint64"].values())


def test_the_phase31_case_turns_on_the_cpu(monkeypatch):
    """The turns run each query: C26 at the bound of one pass past the
    first leaves groups 1 and 2 NaN (the old turns), at the code's bound
    none; C28's uint64 clock and its int64 copy give one std."""
    answers = []

    def median_s(fn, reps):
        answers.append(np.asarray(fn(), dtype=np.float64))
        return 0.0, []
    monkeypatch.setattr(chip_smoke, "median_s", median_s)
    out = chip_smoke.phase31_case_turns(vaex_tpu_torch, 20_000, "cpu")
    assert set(out) == {"c26 std binned, 3 passes / 2", "c28 std binned, uint64 / int64"}
    turns = chip_smoke.PHASE31_CASE_TURNS
    c26, c28 = answers[:len(turns)], answers[len(turns):]
    for which, got in zip(turns, c26):
        assert np.isnan(got[1:3]).all() == (which == "old") and np.isfinite(got[[0, 3]]).all()
    assert all(np.array_equal(got, c28[0]) for got in c28) and (c28[0] > 28).all()


def test_the_phase31_case_checks_refuse_a_lost_spread():
    """phase31_case_check refuses C26's lost 0.0 (within PHASE31_ATOL of
    the std of 1e-7), and the plain answers of the integer cases are the
    exact ones."""
    from fractions import Fraction
    k, x = chip_smoke.phase31_case_columns("c26", 20_000, "cpu")
    want = chip_smoke.phase31_case_plain("c26", k, x, "std")
    chip_smoke.phase31_case_check("same", want.clone(), want)
    with pytest.raises(RuntimeError, match="phase 31"):
        chip_smoke.phase31_case_check("lost", torch.where(want < 1e-3, 0.0, want), want)
    for name in ("c27 int64", "c27 datetime", "c28 uint64", "c28 uint64 past 2^63"):
        k, x = chip_smoke.phase31_case_columns(name, 3_000, "cpu")
        got = chip_smoke.phase31_case_plain(name, k, x, "var")
        top = 2 ** 64 if name.startswith("c28") else None  # uint64 bits as int64
        for g in range(chip_smoke.PHASE31_CASES[name][0]):
            v = [int(a) % top if top else int(a) for a in x[k == g].tolist()]
            exact = Fraction(len(v) * sum(a * a for a in v) - sum(v) ** 2, len(v) ** 2)
            assert abs(float(got[g]) - float(exact)) <= 1e-9 * float(exact), (name, g)
