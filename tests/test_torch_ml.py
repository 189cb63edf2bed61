"""The port's machine learning (vaex_tpu_torch.ml) against vaex_tpu.ml on the
CPU: the same seeded frames through both packages (tests/torch_port_helpers.py),
each transformer's fitted state and transformed columns, the state carried
from one package to the other, KMeans, the metrics (also against
sklearn.metrics), the sklearn, river and booster wrappers, and the faults
of vaex_tpu.ml that the port does not copy (ROADMAP, known problems of the
reference): each test names the reference's file and line and holds the
port to sklearn, numpy or Python.

Tolerances: ints and codes exact; floats rtol 1e-6 and atol 1e-7 (the
contract of tests/torch_port_helpers.py) unless a case states otherwise;
KMeans's centroids and inertia rtol 1e-9.
"""

import numpy as np
import pandas as pd
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from vaex_tpu_torch import settings
from torch_port_helpers import ATOL, RTOL, same_frames

N = 600


def ml_arrays(seed=3, n=N):
    """x, y float64; k an int64 key in 0..5; cat strings of four labels (one
    with a space); xm a masked float64 (10% masked); km a masked int64 key;
    target 0 / 1 from x; w float64; catn strings of three labels with nulls
    (10%)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, n)
    cat = np.asarray(["a", "b", "c", "d e"], dtype=object)[rng.integers(0, 4, n)]
    catn = np.asarray(["p", "q", "r"], dtype=object)[rng.integers(0, 3, n)]
    catn[rng.random(n) < 0.1] = None
    return {
        "catn": catn,
        "x": x,
        "y": x ** 2 + rng.normal(0, 1, n),
        "k": rng.integers(0, 6, n).astype(np.int64),
        "cat": cat.astype(object),
        "xm": np.ma.MaskedArray(rng.normal(5, 2, n), rng.random(n) < 0.1),
        "km": np.ma.MaskedArray(rng.integers(0, 4, n).astype(np.int64), rng.random(n) < 0.1),
        "target": (x + rng.normal(0, 1, n) > 0).astype("f8"),
        "w": rng.normal(0, 1, n),
    }


@pytest.fixture(scope="module")
def frames():
    return same_frames(ml_arrays())


@pytest.fixture
def on_cpu(monkeypatch):
    """Passes of unstaged frames and the functions a transform registers
    (KMeans's) run on the CPU."""
    monkeypatch.setattr(settings, "DEVICE", "cpu")


def _column(df, name):
    """A column as a float array, NaN where missing."""
    values = df[name].tolist()
    return np.asarray([np.nan if v is None else v for v in values], dtype=np.float64)


def _same_value(got, want, rtol=RTOL, atol=ATOL):
    """Two fitted values: lists and dicts item by item, floats to the
    tolerance (NaN equal to NaN), the rest exactly."""
    if isinstance(want, dict):
        assert list(got) == list(want) or set(map(repr, got)) == set(map(repr, want)), (got, want)
        for key in want:
            match = [k for k in got if k == key or repr(k) == repr(key)]
            assert match, key
            _same_value(got[match[0]], want[key], rtol, atol)
        return
    if isinstance(want, (list, tuple, np.ndarray)):
        got, want = list(got), list(want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_value(g, w, rtol, atol)
        return
    if isinstance(want, (float, np.floating)) or isinstance(got, (float, np.floating)):
        if want is None or got is None:
            assert got is want
            return
        npt.assert_allclose(float(got), float(want), rtol=rtol, atol=atol)
        return
    assert got == want, (got, want)


# (class name, constructor arguments, the fitted keys to compare)
TRANSFORMERS = {
    "standard_scaler": ("StandardScaler", {"features": ["x", "y", "xm"]}, ["mean_", "std_"]),
    "standard_scaler_no_mean": ("StandardScaler", {"features": ["x", "k"], "with_mean": False},
                                ["mean_", "std_"]),
    "minmax_scaler": ("MinMaxScaler", {"features": ["x", "xm", "k"], "feature_range": (-1, 2)},
                      ["fmin_", "fmax_"]),
    "max_abs_scaler": ("MaxAbsScaler", {"features": ["x", "xm"]}, ["absmax_"]),
    "robust_scaler": ("RobustScaler", {"features": ["x", "xm"]}, ["center_", "scale_"]),
    "robust_scaler_range": ("RobustScaler", {"features": ["y"], "percentile_range": (10, 90),
                                             "with_centering": False}, ["center_", "scale_"]),
    "label_encoder": ("LabelEncoder", {"features": ["cat", "k"]}, ["labels_"]),
    "label_encoder_masked": ("LabelEncoder", {"features": ["km", "xm"], "allow_unseen": True},
                             ["labels_"]),
    "one_hot_encoder": ("OneHotEncoder", {"features": ["cat", "k"]}, ["uniques_"]),
    "one_hot_encoder_masked": ("OneHotEncoder", {"features": ["km"], "one": 1.0, "zero": -1.0},
                               ["uniques_"]),
    "one_hot_encoder_string_null": ("OneHotEncoder", {"features": ["catn"]}, ["uniques_"]),
    "multi_hot_encoder": ("MultiHotEncoder", {"features": ["cat"]}, ["uniques_"]),
    "frequency_encoder": ("FrequencyEncoder", {"features": ["cat", "k", "km"]}, ["mappings_"]),
    "cycle_transformer": ("CycleTransformer", {"features": ["k"], "n": 6}, []),
    "pca": ("PCA", {"features": ["x", "y", "w"], "n_components": 2},
            ["means_", "eigen_values_", "eigen_vectors_"]),
    "pca_masked": ("PCA", {"features": ["x", "xm"]}, ["means_", "eigen_values_",
                                                       "eigen_vectors_"]),
    "kbins_uniform": ("KBinsDiscretizer", {"features": ["x", "xm"], "n_bins": 4},
                      ["bin_edges_"]),
    "kbins_quantile": ("KBinsDiscretizer", {"features": ["y"], "n_bins": 5,
                                            "strategy": "quantile"}, ["bin_edges_"]),
    "bayesian_target_encoder": ("BayesianTargetEncoder", {"features": ["cat", "k"],
                                                          "target": "target", "weight": 10},
                                ["mappings_", "global_mean_"]),
    "woe_encoder": ("WeightOfEvidenceEncoder", {"features": ["cat", "k"], "target": "target"},
                    ["mappings_"]),
}


def _fit_both(frames, name):
    ref, port = frames
    cls, kwargs, keys = TRANSFORMERS[name]
    t_ref = getattr(vaex_tpu.ml, cls)(**kwargs).fit(ref)
    t_port = getattr(vaex_tpu_torch.ml, cls)(**kwargs).fit(port)
    return t_ref, t_port, keys


def _aligned_vectors(got, want):
    """``got``'s eigenvectors with each column's sign turned to ``want``'s:
    an eigenvector is defined up to its sign."""
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    signs = np.where(np.sum(got * want, axis=0) < 0, -1.0, 1.0)
    return got * signs, signs


def _same_state(t_ref, t_port, keys):
    s_ref, s_port = t_ref.state_get(), t_port.state_get()
    assert s_port.keys() == s_ref.keys()
    assert s_port["class"] == s_ref["class"]
    for key in keys:
        if key == "eigen_vectors_":  # up to one sign a column
            got, _ = _aligned_vectors(s_port[key], s_ref[key])
            npt.assert_allclose(got, np.asarray(s_ref[key]), rtol=RTOL, atol=ATOL)
        else:
            _same_value(s_port[key], s_ref[key])


# the cases held to pandas, not vaex_tpu: a masked number's missing row is
# missing in every value column of vaex_tpu's OneHotEncoder (its ``where``
# on a missing comparison; ROADMAP, known problems of the reference), zero
# in pandas' get_dummies(dummy_na=True)
PANDAS_CASES = {"one_hot_encoder_masked"}


def _pandas_one_hot(series, feature, one, zero):
    """Per column name the values of pandas' one-hot encoding of
    ``series``: ``<feature>_<value>``, and ``<feature>_missing`` for the
    missing rows."""
    dummies = pd.get_dummies(series, dummy_na=True)
    return {f"{feature}_{'missing' if pd.isna(v) else v}":
            np.where(dummies[v].to_numpy(), one, zero).astype(np.float64) for v in dummies}


def _want_columns(name, out_ref, new):
    """The expected values of the columns ``new`` of case ``name``:
    vaex_tpu's, or pandas' for the :data:`PANDAS_CASES`."""
    if name not in PANDAS_CASES:
        return {c: _column(out_ref, c) for c in new}
    _, kwargs, _ = TRANSFORMERS[name]
    [feature] = kwargs["features"]
    km = ml_arrays()[feature]
    series = pd.Series(km.data).astype("Int64").mask(np.ma.getmaskarray(km))
    want = _pandas_one_hot(series, feature, kwargs["one"], kwargs["zero"])
    for c in new:  # the reference's fault: missing in the value columns
        if not c.endswith("_missing"):
            assert np.isnan(_column(out_ref, c)[np.ma.getmaskarray(km)]).all(), c
    return want


def _same_columns(ref, port, out_ref, out_port, signs=None, name=None):
    """The columns a transform added: the same names and values (a PCA
    column up to its eigenvector's sign), those of a case of
    :data:`PANDAS_CASES` held to pandas."""
    new = [c for c in out_ref.get_column_names() if c not in ref.get_column_names()]
    assert new and [c for c in out_port.get_column_names()
                    if c not in port.get_column_names()] == new
    wants = _want_columns(name, out_ref, new)
    for c in new:
        got, want = _column(out_port, c), wants[c]
        if signs is not None and c.startswith("PCA_"):
            got = got * signs[int(c[4:])]
        npt.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=c)
    return new


@pytest.mark.parametrize("name", [n for n in TRANSFORMERS if n != "cycle_transformer"])
def test_fitted_state_equals_vaex_tpu(frames, name):
    t_ref, t_port, keys = _fit_both(frames, name)
    _same_state(t_ref, t_port, keys)


@pytest.mark.parametrize("name", list(TRANSFORMERS))
def test_transformed_columns_equal_vaex_tpu(frames, name):
    ref, port = frames
    t_ref, t_port, keys = _fit_both(frames, name)
    signs = None
    if "eigen_vectors_" in keys:
        _, signs = _aligned_vectors(t_port.eigen_vectors_, t_ref.eigen_vectors_)
    _same_columns(ref, port, t_ref.transform(ref), t_port.transform(port), signs, name)


@pytest.mark.parametrize("name", list(TRANSFORMERS))
def test_state_fitted_in_vaex_tpu_transforms_a_port_frame(frames, name):
    """The state carries the weights across: vaex_tpu's fitted state, put on
    the port's transformer by ``state_set``, transforms a port frame to the
    values vaex_tpu's transform gives."""
    ref, port = frames
    cls, kwargs, _ = TRANSFORMERS[name]
    t_ref = getattr(vaex_tpu.ml, cls)(**kwargs).fit(ref)
    t_port = getattr(vaex_tpu_torch.ml, cls)().state_set(t_ref.state_get())
    _same_columns(ref, port, t_ref.transform(ref), t_port.transform(port), name=name)


@pytest.mark.parametrize("name", list(TRANSFORMERS))
def test_state_round_trip_in_the_port(frames, name):
    """A port transformer's ``state_get``, put on a new one by
    ``state_set``, transforms to the same columns.  vaex_tpu's
    ``state_set`` (vaex_tpu/ml/transformations.py:43-47) turns the fitted
    lists into numpy arrays, and its transforms then write numpy 2's
    ``np.float64(...)`` into their expressions, which fail (KeyError: 'np');
    the port writes Python floats."""
    _, port = frames
    cls, kwargs, _ = TRANSFORMERS[name]
    fitted = getattr(vaex_tpu_torch.ml, cls)(**kwargs).fit(port)
    loaded = getattr(vaex_tpu_torch.ml, cls)().state_set(fitted.state_get())
    a, b = fitted.transform(port), loaded.transform(port)
    for c in [c for c in a.get_column_names() if c not in port.get_column_names()]:
        npt.assert_array_equal(_column(b, c), _column(a, c), err_msg=c)


def test_groupby_transformer_equals_vaex_tpu(frames):
    ref, port = frames
    agg_ref = {"xs": vaex_tpu.agg.sum("x"), "xm_mean": vaex_tpu.agg.mean("xm")}
    agg_port = {"xs": vaex_tpu_torch.agg.sum("x"), "xm_mean": vaex_tpu_torch.agg.mean("xm")}
    t_ref = vaex_tpu.ml.GroupByTransformer(by="k", agg=agg_ref).fit(ref)
    t_port = vaex_tpu_torch.ml.GroupByTransformer(by="k", agg=agg_port).fit(port)
    out_ref, out_port = t_ref.transform(ref), t_port.transform(port)
    for c in ("xs", "xm_mean"):
        npt.assert_allclose(_column(out_port, c), _column(out_ref, c), rtol=RTOL, atol=ATOL)
    assert out_port.get_column_names() == out_ref.get_column_names()


def test_filtered_frame(frames):
    """A filtered frame fits on the rows its filter keeps."""
    ref, port = frames
    ref, port = ref[ref.x > 0], port[port.x > 0]
    for cls, kwargs in (("StandardScaler", {"features": ["x", "xm"]}),
                        ("LabelEncoder", {"features": ["cat"]}),
                        ("PCA", {"features": ["x", "y"]}),
                        ("RobustScaler", {"features": ["y"]})):
        t_ref = getattr(vaex_tpu.ml, cls)(**kwargs).fit(ref)
        t_port = getattr(vaex_tpu_torch.ml, cls)(**kwargs).fit(port)
        s_ref, s_port = t_ref.state_get(), t_port.state_get()
        for key in s_ref:
            if key == "eigen_vectors_":
                got, signs = _aligned_vectors(s_port[key], s_ref[key])
                npt.assert_allclose(got, np.asarray(s_ref[key]), rtol=RTOL, atol=ATOL)
            elif key.endswith("_"):
                _same_value(s_port[key], s_ref[key])
        _same_columns(ref, port, t_ref.transform(ref), t_port.transform(port),
                      signs if cls == "PCA" else None)


def test_frame_state_of_a_port_pipeline_loads_in_vaex_tpu(frames):
    """A port frame's state after expression-only transforms (a scaler, a
    PCA, a label encoder, a frequency encoder) loads in vaex_tpu by
    ``state_set`` and gives the same columns there."""
    ref, port = frames
    df = port
    for t in (vaex_tpu_torch.ml.StandardScaler(features=["x", "y"]),
              vaex_tpu_torch.ml.PCA(features=["x", "y"], n_components=1),
              vaex_tpu_torch.ml.LabelEncoder(features=["cat"], allow_unseen=True),
              vaex_tpu_torch.ml.FrequencyEncoder(features=["k"])):
        df = t.fit_transform(df)
    fresh = vaex_tpu.from_arrays(**ml_arrays())
    fresh.state_set(df.state_get())
    for c in ("standard_scaled_x", "standard_scaled_y", "PCA_0", "label_encoded_cat",
              "frequency_encoded_k"):
        npt.assert_allclose(_column(fresh, c), _column(df, c), rtol=RTOL, atol=ATOL, err_msg=c)


def test_frame_state_round_trip_in_the_port(frames):
    _, port = frames
    df = vaex_tpu_torch.ml.StandardScaler(features=["x"]).fit_transform(port)
    df = vaex_tpu_torch.ml.BayesianTargetEncoder(features=["cat"], target="target").fit_transform(df)
    fresh = vaex_tpu_torch.from_arrays(**ml_arrays()).to_device("cpu")
    fresh.state_set(df.state_get())
    for c in ("standard_scaled_x", "mean_encoded_cat"):
        npt.assert_array_equal(_column(fresh, c), _column(df, c))


# ------------------------------------------------------------------ test_ml.py
# every case of tests/test_ml.py, through both packages

X10 = np.arange(10, dtype="f8")


@pytest.fixture
def df_ml():
    arrays = dict(x=X10.copy(), y=X10 ** 2,
                  cat=np.asarray(["a", "b", "a", "c", "b", "a", "a", "c", "b", "a"], dtype=object),
                  target=(X10 > 4).astype("f8"))
    return same_frames(arrays)


@pytest.mark.parametrize("method,kwargs,column", [
    ("standard_scaler", {"features": ["x"]}, "standard_scaled_x"),
    ("minmax_scaler", {"features": ["x"]}, "minmax_scaled_x"),
    ("max_abs_scaler", {"features": ["x"]}, "absmax_scaled_x"),
    ("label_encoder", {"features": ["cat"]}, "label_encoded_cat"),
    ("one_hot_encoder", {"features": ["cat"]}, "cat_a"),
    ("frequency_encoder", {"features": ["cat"]}, "frequency_encoded_cat"),
    ("kbins_discretizer", {"features": ["x"], "n_bins": 5}, "binned_x"),
    ("cycle_transformer", {"features": ["x"], "n": 10}, "x_x"),
    ("robust_scaler", {"features": ["x"]}, "robust_scaled_x"),
    ("pca", {"features": ["x", "y"], "n_components": 2}, "PCA_0"),
])
def test_df_ml_accessor(df_ml, method, kwargs, column):
    """``df.ml.<transformer>`` (tests/test_ml.py's cases) fits in one call and
    gives vaex_tpu's column."""
    ref, port = df_ml
    got = _column(getattr(port.ml, method)(**kwargs).transform(port), column)
    want = _column(getattr(ref.ml, method)(**kwargs).transform(ref), column)
    if method == "pca":
        got = got * np.sign(got @ want)
    npt.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_test_ml_properties(df_ml):
    """The properties tests/test_ml.py asserts, on the port."""
    _, df = df_ml
    v = _column(df.ml.standard_scaler(["x"]).transform(df), "standard_scaled_x")
    npt.assert_allclose([v.mean(), v.std()], [0, 1], atol=1e-12)
    v = _column(df.ml.minmax_scaler(["x"]).transform(df), "minmax_scaled_x")
    assert v.min() == 0 and v.max() == 1
    assert _column(df.ml.max_abs_scaler(["x"]).transform(df), "absmax_scaled_x").max() == 1.0
    codes = df.ml.label_encoder(["cat"]).transform(df)["label_encoded_cat"].tolist()
    assert set(codes) == {0, 1, 2}
    out = df.ml.one_hot_encoder(["cat"]).transform(df)
    assert {"cat_a", "cat_b", "cat_c"} <= set(out.get_column_names())
    assert _column(out, "cat_a").sum() == 5
    npt.assert_allclose(_column(df.ml.frequency_encoder(["cat"]).transform(df),
                                "frequency_encoded_cat")[0], 0.5)
    pca_df = df.copy()
    pca_df["z"] = pca_df.x * 2 + 1
    out = pca_df.ml.pca(["x", "z"], n_components=2).transform(pca_df)
    assert _column(out, "PCA_1").std() < 1e-8 and _column(out, "PCA_0").std() > 1
    bins = _column(df.ml.kbins_discretizer(["x"], n_bins=5).transform(df), "binned_x")
    assert bins.min() == 0 and bins.max() == 4
    out = df.ml.cycle_transformer(["x"], n=10).transform(df)
    npt.assert_allclose(_column(out, "x_x") ** 2 + _column(out, "x_y") ** 2, 1.0)
    t = vaex_tpu_torch.ml.BayesianTargetEncoder(features=["cat"], target="target", weight=0)
    npt.assert_allclose(_column(t.fit_transform(df), "mean_encoded_cat")[0], 0.6)
    t = vaex_tpu_torch.ml.GroupByTransformer(by="cat", agg={"xs": vaex_tpu_torch.agg.sum("x")})
    assert _column(t.fit_transform(df), "xs")[0] == 0 + 2 + 5 + 6 + 9


def test_state_roundtrip_pipeline(df_ml):
    """tests/test_ml.py:test_state_roundtrip_pipeline on the port."""
    _, df = df_ml
    out = df.ml.standard_scaler(["x"]).transform(df)
    df2 = vaex_tpu_torch.from_arrays(x=X10.copy(), y=X10 ** 2,
                                     cat=np.asarray(["a"] * 10, dtype=object),
                                     target=np.zeros(10)).to_device("cpu")
    df2.state_set(out.state_get())
    npt.assert_allclose(_column(df2, "standard_scaled_x").mean(), 0, atol=1e-12)


def test_df_ml_is_registered_on_port_frames(df_ml):
    _, df = df_ml
    assert type(df.ml).__module__ == "vaex_tpu_torch.ml"
    assert isinstance(df.ml.metrics, vaex_tpu_torch.ml.metrics.DataFrameAccessorMetrics)


# ----------------------------------------------------------------------- KMeans
def blobs(seed=0, per=200, scale=0.5, nan_row=None):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 5.0]])
    X = np.concatenate([rng.normal(c, scale, size=(per, 2)) for c in centers])
    return {"a": X[:, 0], "b": X[:, 1], "c": rng.normal(0, 1, len(X))}


@pytest.mark.parametrize("kwargs", [
    {"n_clusters": 3, "n_init": 1, "random_state": 1},
    {"n_clusters": 3, "n_init": 3, "random_state": 42, "chunk_size": 150},
    {"n_clusters": 4, "n_init": 3, "random_state": 7, "max_iter": 2},
    {"n_clusters": 5, "n_init": 2, "random_state": 3, "tol": 1e-1, "chunk_size": 250},
    {"n_clusters": 3, "init": [[1.0, 1.0], [9.0, 9.0], [-9.0, 4.0]], "n_init": 2},
    {"n_clusters": 2, "n_init": 3, "random_state": 5, "features": ["a", "b", "c"]},
], ids=["n_init1", "n_init3_chunks", "max_iter", "tol", "init_list", "three_features"])
def test_kmeans_equals_vaex_tpu(kwargs, on_cpu):
    kwargs = dict(kwargs)
    features = kwargs.pop("features", ["a", "b"])
    ref, port = same_frames(blobs())
    km_ref = vaex_tpu.ml.KMeans(features=features, **kwargs).fit(ref)
    km_port = vaex_tpu_torch.ml.KMeans(features=features, **kwargs).fit(port)
    npt.assert_allclose(km_port.cluster_centers_, km_ref.cluster_centers_, rtol=1e-9, atol=1e-12)
    npt.assert_allclose(km_port.inertia_, km_ref.inertia_, rtol=1e-9)
    assert len(km_port.inertias_) == len(km_ref.inertias_)
    npt.assert_allclose(km_port.inertias_, km_ref.inertias_, rtol=1e-9)
    if "max_iter" in kwargs:
        assert len(km_port.inertias_) == kwargs["max_iter"]
    if "tol" in kwargs:
        assert len(km_port.inertias_) < km_port.max_iter
    pred = km_port.predict(port)
    assert pred.dtype == np.int64
    npt.assert_array_equal(pred, km_ref.predict(ref))
    out = km_port.transform(port)
    npt.assert_array_equal(out.evaluate("prediction_kmeans"), pred)


def test_kmeans_walks_the_frame_each_iteration_past_keep_bytes(on_cpu, monkeypatch):
    """Features past ``KEEP_BYTES`` are evaluated again every iteration, tile
    by tile, instead of kept on the device: the same fit."""
    from vaex_tpu_torch.ml import cluster
    ref, port = same_frames(blobs(seed=3))
    kw = dict(features=["a", "b"], n_clusters=3, n_init=3, random_state=42, chunk_size=150)
    km_ref = vaex_tpu.ml.KMeans(**kw).fit(ref)
    monkeypatch.setattr(cluster, "KEEP_BYTES", 0)
    walks = []
    real = cluster.KMeans._walk

    def counted(self, df):
        walks.append(1)
        return real(self, df)
    monkeypatch.setattr(cluster.KMeans, "_walk", counted)
    km_port = vaex_tpu_torch.ml.KMeans(**kw).fit(port)
    assert len(walks) == 1 + len(km_port.inertias_)  # the init's, then one an iteration
    npt.assert_allclose(km_port.cluster_centers_, km_ref.cluster_centers_, rtol=1e-9, atol=1e-12)
    npt.assert_array_equal(km_port.predict(port), km_ref.predict(ref))


def test_kmeans_state_fitted_in_vaex_tpu_predicts_in_the_port(on_cpu):
    ref, port = same_frames(blobs(seed=4))
    km_ref = vaex_tpu.ml.KMeans(features=["a", "b"], n_clusters=3, n_init=3,
                                random_state=42).fit(ref)
    km_port = vaex_tpu_torch.ml.KMeans().state_set(km_ref.state_get())
    npt.assert_array_equal(km_port.predict(port), km_ref.predict(ref))
    npt.assert_array_equal(km_port.transform(port)["prediction_kmeans"].tolist(),
                           km_ref.transform(ref)["prediction_kmeans"].tolist())


def test_kmeans_clusters_and_transform(on_cpu):
    """tests/test_ml.py:test_kmeans_clusters_and_transform on the port: the
    blobs' centres found, each blob one cluster, the state round-trips, the
    same bits when fitted twice."""
    _, df = same_frames(blobs())
    km = vaex_tpu_torch.ml.KMeans(features=["a", "b"], n_clusters=3, n_init=3,
                                  random_state=42, chunk_size=150).fit(df)
    npt.assert_allclose(np.sort(np.asarray(km.cluster_centers_), axis=0),
                        np.sort([[0.0, 0.0], [10.0, 10.0], [-10.0, 5.0]], axis=0), atol=0.3)
    assert km.inertia_ < 600 * 2 * 0.5 ** 2 * 3
    pred = np.asarray(km.transform(df).evaluate("prediction_kmeans", array_type="numpy"))
    assert pred.shape == (600,)
    for blob in range(3):
        assert len(np.unique(pred[blob * 200:(blob + 1) * 200])) == 1
    km2 = vaex_tpu_torch.ml.KMeans().state_set(km.state_get())
    npt.assert_array_equal(km2.predict(df), km.predict(df))
    again = vaex_tpu_torch.ml.KMeans(features=["a", "b"], n_clusters=3, n_init=3,
                                     random_state=42, chunk_size=150).fit(df)
    assert again.cluster_centers_ == km.cluster_centers_ and again.inertia_ == km.inertia_


def test_kmeans_filtered_frame(on_cpu):
    ref, port = same_frames(blobs(seed=2))
    ref, port = ref[ref.c > -0.5], port[port.c > -0.5]
    kw = dict(features=["a", "b"], n_clusters=3, n_init=2, random_state=9, chunk_size=100)
    km_ref, km_port = vaex_tpu.ml.KMeans(**kw).fit(ref), vaex_tpu_torch.ml.KMeans(**kw).fit(port)
    npt.assert_allclose(km_port.cluster_centers_, km_ref.cluster_centers_, rtol=1e-9, atol=1e-12)
    npt.assert_array_equal(km_port.predict(port), km_ref.predict(ref))


def test_kmeans_sums_go_through_the_grid_plan(on_cpu, monkeypatch):
    """The per-cluster counts and sums are one additive grid a run through
    grid_plan.grid_sums (B1 on the card), over an int32 index; no one-hot."""
    from vaex_tpu_torch.ops import grid_plan
    calls = []
    real = grid_plan.grid_sums

    def spy(idx, int_cols, float_cols, G, count, out=None):
        calls.append((idx.dtype, len(int_cols), len(float_cols), G, count,
                      grid_plan.strategy(idx.shape[0], G, len(int_cols), len(float_cols), count)))
        return real(idx, int_cols, float_cols, G, count, out)
    monkeypatch.setattr(grid_plan, "grid_sums", spy)
    _, df = same_frames(blobs())
    km = vaex_tpu_torch.ml.KMeans(features=["a", "b", "c"], n_clusters=3, n_init=2,
                                  random_state=1, max_iter=3, chunk_size=250).fit(df)
    # three tiles, two runs, three iterations
    assert len(calls) == 3 * 2 * len(km.inertias_)
    assert set(calls) == {(torch.int32, 0, 3, 3, True, grid_plan.B1)}


# ---------------------------------------------------------------------- metrics
def _metric_frames(seed=1, n=5000):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    p = np.where(rng.random(n) < 0.8, y, 1 - y)
    yr = rng.normal(0, 2, n)
    y3 = rng.integers(0, 3, n)
    return {"y": y.astype("i8"), "p": p.astype("i8"), "yr": yr, "pr": yr + rng.normal(0, 0.5, n),
            "y3": y3.astype("i8"), "p3": np.where(rng.random(n) < 0.7, y3, (y3 + 1) % 3),
            "s": rng.normal(0, 1, n)}


def test_metrics_equal_vaex_tpu_and_sklearn():
    from sklearn import metrics as skm
    arrays = _metric_frames()
    ref, port = same_frames(arrays)
    y, p, yr, pr = (arrays[c] for c in ("y", "p", "yr", "pr"))
    m, r = port.ml.metrics, ref.ml.metrics
    cases = [
        ("accuracy_score", ("y", "p"), skm.accuracy_score(y, p)),
        ("precision_score", ("y", "p"), skm.precision_score(y, p)),
        ("recall_score", ("y", "p"), skm.recall_score(y, p)),
        ("f1_score", ("y", "p"), skm.f1_score(y, p)),
        ("matthews_correlation_coefficient", ("y", "p"), skm.matthews_corrcoef(y, p)),
        ("mean_absolute_error", ("yr", "pr"), skm.mean_absolute_error(yr, pr)),
        ("mean_squared_error", ("yr", "pr"), skm.mean_squared_error(yr, pr)),
        ("r2_score", ("yr", "pr"), skm.r2_score(yr, pr)),
    ]
    for name, args, want in cases:
        got = getattr(m, name)(*args)
        npt.assert_allclose(got, want, rtol=1e-9, err_msg=name)
        npt.assert_allclose(got, getattr(r, name)(*args), rtol=1e-9, err_msg=name)
    npt.assert_array_equal(m.confusion_matrix("y", "p"), skm.confusion_matrix(y, p))
    npt.assert_array_equal(m.confusion_matrix("y", "p"), r.confusion_matrix("y", "p"))
    y3, p3 = arrays["y3"], arrays["p3"]
    got = m.precision_recall_fscore("y3", "p3", average="macro")
    npt.assert_allclose(got, skm.precision_recall_fscore_support(y3, p3, average="macro")[:3],
                        rtol=1e-9)
    npt.assert_allclose(got, r.precision_recall_fscore("y3", "p3", average="macro"), rtol=1e-9)
    npt.assert_allclose(m.matthews_correlation_coefficient("y3", "p3"),
                        skm.matthews_corrcoef(y3, p3), rtol=1e-9)
    report = m.classification_report("y", "p")
    assert report == r.classification_report("y", "p")


def test_metrics_with_a_selection_and_on_a_filtered_frame():
    from sklearn import metrics as skm
    arrays = _metric_frames(seed=5)
    ref, port = same_frames(arrays)
    keep = arrays["s"] > 0
    y, p, yr, pr = (arrays[c][keep] for c in ("y", "p", "yr", "pr"))
    m = port.ml.metrics
    npt.assert_allclose(m.accuracy_score("y", "p", selection="s > 0"),
                        skm.accuracy_score(y, p), rtol=1e-12)
    npt.assert_allclose(m.r2_score("yr", "pr", selection="s > 0"), skm.r2_score(yr, pr),
                        rtol=1e-9)
    npt.assert_array_equal(m.confusion_matrix("y", "p", selection="s > 0"),
                           skm.confusion_matrix(y, p))
    filtered = port[port.s > 0].ml.metrics
    npt.assert_allclose(filtered.f1_score("y", "p"), skm.f1_score(y, p), rtol=1e-12)
    npt.assert_allclose(filtered.mean_squared_error("yr", "pr"),
                        skm.mean_squared_error(yr, pr), rtol=1e-9)


# --------------------------------------------------------------------- wrappers
def test_sklearn_predictor_equals_vaex_tpu(df_ml):
    pytest.importorskip("sklearn")
    from sklearn.linear_model import LinearRegression
    ref, port = df_ml
    outs = []
    for pkg, df in ((vaex_tpu, ref), (vaex_tpu_torch, port)):
        p = pkg.ml.Predictor(model=LinearRegression(), features=["x"], target="y",
                             prediction_name="pred")
        p.fit(df)
        out = p.transform(df)
        assert out.count("pred") == 10
        outs.append((_column(out, "pred"), p.predict(df)))
    npt.assert_allclose(outs[1][0], outs[0][0], rtol=RTOL, atol=ATOL)
    npt.assert_allclose(outs[1][1], outs[0][1], rtol=RTOL, atol=ATOL)
    assert np.corrcoef(outs[1][0], X10 ** 2)[0, 1] > 0.95


def test_sklearn_incremental_equals_vaex_tpu(df_ml):
    pytest.importorskip("sklearn")
    from sklearn.linear_model import SGDRegressor
    ref, port = df_ml
    preds = []
    for pkg, df in ((vaex_tpu, ref), (vaex_tpu_torch, port)):
        p = pkg.ml.IncrementalPredictor(model=SGDRegressor(random_state=0), features=["x"],
                                        target="y", batch_size=4, num_epochs=30)
        p.fit(df)
        out = p.transform(df)
        assert out.count("prediction") == 10
        preds.append(_column(out, "prediction"))
    npt.assert_allclose(preds[1], preds[0], rtol=RTOL, atol=ATOL)


def _river_frames(seed, classify):
    rng = np.random.default_rng(seed)
    n = 20_000
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    y = ((x1 - x2 > 0).astype("i8") if classify
         else 3.0 * x1 - 2.0 * x2 + 0.5 + rng.normal(0, 0.01, n))
    return same_frames({"x1": x1, "x2": x2, "y": y}), y


def test_river_regressor_equals_vaex_tpu():
    (ref, port), y = _river_frames(8, classify=False)
    models = []
    for pkg, df in ((vaex_tpu, ref), (vaex_tpu_torch, port)):
        m = pkg.ml.RiverModel(model=pkg.ml.OnlineSGDRegressor(learning_rate=0.2),
                              features=["x1", "x2"], target="y", batch_size=4096, num_epochs=8)
        m.fit(df)
        models.append((m, _column(m.transform(df), "prediction")))
    (m_ref, p_ref), (m_port, p_port) = models
    npt.assert_allclose(m_port.model.weights, m_ref.model.weights, rtol=1e-12)
    npt.assert_allclose(m_port.model.intercept, m_ref.model.intercept, rtol=1e-12)
    npt.assert_allclose(p_port, p_ref, rtol=1e-12, atol=1e-12)
    assert np.abs(p_port - y).mean() < 0.1
    npt.assert_allclose(m_port.model.weights, [3.0, -2.0], atol=0.05)


def test_river_classifier_equals_vaex_tpu():
    (ref, port), y = _river_frames(9, classify=True)
    out = []
    for pkg, df in ((vaex_tpu, ref), (vaex_tpu_torch, port)):
        m = pkg.ml.RiverModel(model=pkg.ml.OnlineSGDClassifier(learning_rate=0.5),
                              features=["x1", "x2"], target="y", batch_size=4096, num_epochs=6)
        m.fit(df)
        pred = m.predict(df)
        m.prediction_type = "predict_proba"
        out.append((pred, _column(m.transform(df), "prediction")))
    npt.assert_array_equal(out[1][0], out[0][0])
    npt.assert_allclose(out[1][1], out[0][1], rtol=1e-12)
    assert (out[1][0] == y).mean() > 0.97
    assert ((out[1][1] >= 0.5).astype("i8") == out[1][0]).all()


def test_boosting_wrappers_state_roundtrip():
    """tests/test_ml.py's case: unfitted state round-trips without the
    libraries, the same state as vaex_tpu's."""
    from vaex_tpu_torch.ml.boosting import (CatBoostModel, KerasModel, LightGBMModel,
                                            XGBoostModel)
    for cls in (LightGBMModel, XGBoostModel, CatBoostModel):
        m = cls(features=["a", "b"], target="y", params={"objective": "mse"},
                num_boost_round=7, prediction_name="p")
        state = m.state_get()
        ref_cls = getattr(vaex_tpu.ml.boosting, cls.__name__)
        assert state == ref_cls(features=["a", "b"], target="y", params={"objective": "mse"},
                                num_boost_round=7, prediction_name="p").state_get()
        m2 = cls().state_set(state)
        assert m2.features == ["a", "b"] and m2.target == "y"
        assert m2.num_boost_round == 7 and m2.prediction_name == "p" and m2.model is None
    assert KerasModel(features=["a"], target="y").state_get()["model"] is None


def test_boosting_wrapper_stub_predict_column():
    from vaex_tpu_torch.ml.boosting import LightGBMModel

    class StubBooster:
        def predict(self, X):
            return X[:, 0] * 2 + X[:, 1]

    df = vaex_tpu_torch.from_arrays(a=np.arange(5.0), b=np.ones(5)).to_device("cpu")
    m = LightGBMModel(features=["a", "b"], target="b")
    m.model = StubBooster()
    npt.assert_allclose(_column(m.transform(df), "prediction"), np.arange(5.0) * 2 + 1)
    npt.assert_allclose(m.predict(df), np.arange(5.0) * 2 + 1)


@pytest.mark.parametrize("module,cls", [("lightgbm", "LightGBMModel"),
                                        ("xgboost", "XGBoostModel"),
                                        ("catboost", "CatBoostModel")])
def test_boosting_requires_its_library(module, cls):
    import importlib.util
    m = getattr(vaex_tpu_torch.ml, cls)(features=["a"], target="y")
    df = vaex_tpu_torch.from_arrays(a=np.arange(4.0), y=np.arange(4.0)).to_device("cpu")
    if importlib.util.find_spec(module) is None:
        with pytest.raises(ImportError, match=module):
            m.fit(df)
        with pytest.raises(ImportError, match=module):
            m._model_from_bytes(b"x")


@pytest.mark.parametrize("module,cls,params", [
    ("lightgbm", "LightGBMModel", {"objective": "regression", "verbose": -1,
                                   "min_data_in_leaf": 1}),
    ("xgboost", "XGBoostModel", {"objective": "reg:squarederror"}),
    ("catboost", "CatBoostModel", {"loss_function": "RMSE", "verbose": False}),
])
def test_boosting_with_the_real_library(module, cls, params):
    pytest.importorskip(module)
    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=400), "b": rng.normal(size=400)}
    arrays["y"] = 2 * arrays["a"] - arrays["b"]
    _, df = same_frames(arrays)
    m = getattr(vaex_tpu_torch.ml, cls)(features=["a", "b"], target="y", params=params,
                                        num_boost_round=20).fit(df)
    pred = _column(m.transform(df), "prediction")
    assert np.corrcoef(pred, arrays["y"])[0, 1] > 0.9
    m2 = getattr(vaex_tpu_torch.ml, cls)().state_set(m.state_get())
    npt.assert_allclose(m2.predict(df), m.predict(df), rtol=1e-6)


# ------------------------------------------- the faults of vaex_tpu.ml, not copied
def test_confusion_matrix_of_an_expression():
    """vaex_tpu/ml/metrics.py:43-47 looks the groupby's output up by the
    expression's text (``out[y_pred]``) and raises KeyError for an
    expression; the port reads the key columns by position and equals
    sklearn.  Macro scores and MCC go through it too."""
    from sklearn import metrics as skm
    arrays = _metric_frames(seed=2)
    _, port = same_frames(arrays)
    m = port.ml.metrics
    y = arrays["y"]
    for expr, pred in (("p*1", arrays["p"]), ("where(s>0,1.0,0.0)", (arrays["s"] > 0) * 1.0),
                       ("s > 0", arrays["s"] > 0)):
        npt.assert_array_equal(m.confusion_matrix("y", expr), skm.confusion_matrix(y, pred))
        npt.assert_allclose(m.matthews_correlation_coefficient("y", expr),
                            skm.matthews_corrcoef(y, pred), rtol=1e-9)
        npt.assert_allclose(m.precision_recall_fscore("y", expr, average="macro"),
                            skm.precision_recall_fscore_support(y, pred, average="macro")[:3],
                            rtol=1e-9)
    npt.assert_array_equal(m.confusion_matrix("p+0", "y"), skm.confusion_matrix(arrays["p"], y))


@pytest.mark.parametrize("kind", ["int", "float", "string"])
def test_map_default_value_for_a_value_that_is_not_a_key(kind, on_cpu):
    """vaex_tpu/expression.py:323-326 fills ``default_value`` only into the
    NaN / null slots, so a value that is not a key comes back missing; the
    port gives ``default_value``, as Python's ``dict.get`` does."""
    rng = np.random.default_rng(4)
    if kind == "string":
        values = np.asarray(["a", "b", "c", "zz"], dtype=object)[rng.integers(0, 4, 200)]
        mapper, default = {"a": 1.5, "b": -2.0}, 7.25
    else:
        values = rng.integers(0, 6, 200).astype("i8" if kind == "int" else "f8")
        mapper = {0: 10, 2: 20, 5: 50} if kind == "int" else {0.0: 0.5, 2.0: 2.5}
        default = -1 if kind == "int" else np.nan
    df = vaex_tpu_torch.from_arrays(v=values)
    got = df.v.map(mapper, default_value=default).tolist()
    want = [mapper.get(v, default) for v in values.tolist()]
    npt.assert_array_equal(np.asarray(got, dtype=float), np.asarray(want, dtype=float))


def test_map_takes_the_reference_arguments(on_cpu):
    """nan_value for NaN that is not a key, missing_value for a missing
    value, default_value for a value that is not a key; the mapper's own NaN
    key before nan_value; without them the port's map is unchanged."""
    x = np.ma.MaskedArray([1.0, 2.0, np.nan, 4.0, 5.0, 1.0], [0, 0, 0, 0, 1, 0])
    df = vaex_tpu_torch.from_arrays(x=x)
    m = {1.0: 10.0, 2.0: 20.0}
    assert df.x.map(m).tolist() == [10.0, 20.0, None, None, None, 10.0]
    assert df.x.map(m, default_value=-1.0).tolist() == [10.0, 20.0, -1.0, -1.0, None, 10.0]
    assert df.x.map(m, default_value=-1.0, nan_value=99.0, missing_value=77.0,
                    allow_missing=True).tolist() == [10.0, 20.0, 99.0, -1.0, 77.0, 10.0]
    assert df.x.map(m, nan_value=99.0).tolist() == [10.0, 20.0, 99.0, None, None, 10.0]
    assert df.x.map({1.0: 10.0, np.nan: 5.0}, nan_value=99.0).tolist() == [
        10.0, None, 5.0, None, None, 10.0]
    s = vaex_tpu_torch.from_arrays(s=np.asarray(["a", "b", None, "q"], dtype=object))
    assert s.s.map({"a": "A"}, default_value="?", missing_value="-").tolist() == [
        "A", "?", "-", "?"]


def test_encoders_give_their_fallback_for_an_unseen_value(frames):
    """Through the repaired map: BayesianTargetEncoder gives ``global_mean_``
    for a category the fit did not see, FrequencyEncoder NaN
    (``unseen="nan"``) or 0.0 (``unseen="zero"``), WeightOfEvidenceEncoder
    NaN (vaex_tpu gives a missing value for all three)."""
    _, port = frames
    seen = port[port.cat != "a"]
    unseen = port.cat.tolist()
    bte = vaex_tpu_torch.ml.BayesianTargetEncoder(features=["cat"], target="target").fit(seen)
    got = bte.transform(port)["mean_encoded_cat"].tolist()
    want = [bte.mappings_["cat"].get(v, bte.global_mean_) for v in unseen]
    npt.assert_allclose(got, want, rtol=1e-15)
    for unseen_as, fill in (("nan", np.nan), ("zero", 0.0)):
        fe = vaex_tpu_torch.ml.FrequencyEncoder(features=["cat"], unseen=unseen_as).fit(seen)
        got = np.asarray(fe.transform(port)["frequency_encoded_cat"].tolist(), dtype=float)
        npt.assert_array_equal(got, [fe.mappings_["cat"].get(v, fill) for v in unseen])
    woe = vaex_tpu_torch.ml.WeightOfEvidenceEncoder(features=["cat"], target="target").fit(seen)
    got = np.asarray(woe.transform(port)["woe_encoded_cat"].tolist(), dtype=float)
    npt.assert_array_equal(got, [woe.mappings_["cat"].get(v, np.nan) for v in unseen])


@pytest.mark.parametrize("feature", ["cat", "k"])
def test_label_encoder_refuses_an_unseen_value(frames, feature):
    """vaex_tpu/ml/transformations.py:170-197 stores ``allow_unseen`` and
    never reads it: an unseen value is -1 either way.  The port's transform
    raises ValueError where the frame holds an unseen value (the rows its
    filter keeps) without ``allow_unseen``, and gives -1 with it."""
    _, port = frames
    first = port[feature].tolist()[0]
    seen = port[port[feature] != first]
    strict = vaex_tpu_torch.ml.LabelEncoder(features=[feature]).fit(seen)
    with pytest.raises(ValueError, match=f"not among its .* e.g. \\[{first!r}\\]"):
        strict.transform(port)
    assert strict.transform(seen)[f"label_encoded_{feature}"].count() == len(seen)
    lax = vaex_tpu_torch.ml.LabelEncoder(features=[feature], allow_unseen=True).fit(seen)
    codes = lax.transform(port)[f"label_encoded_{feature}"].tolist()
    labels = lax.labels_[feature]
    assert codes == [labels.index(v) if v in labels else -1 for v in port[feature].tolist()]


@pytest.mark.parametrize("fault", ["masked", "nan"])
def test_kmeans_refuses_missing_or_nan_features(fault, on_cpu):
    """vaex_tpu/ml/cluster.py:92 drops the mask (``np.asarray(...,
    dtype="f8")``) and checks no NaN: a row masked at 100.0 becomes a
    centroid of its own, one NaN row makes every centroid NaN.  The port
    raises ValueError naming the feature, as sklearn refuses NaN input; the
    same rows dropped fit as sklearn's data would."""
    arrays = blobs(seed=6)
    a = arrays["a"].copy()
    a[17] = 100.0 if fault == "masked" else np.nan
    arrays["a"] = np.ma.MaskedArray(a, np.arange(len(a)) == 17) if fault == "masked" else a
    _, port = same_frames(arrays)
    km = vaex_tpu_torch.ml.KMeans(features=["b", "a"], n_clusters=3, n_init=2, random_state=42)
    with pytest.raises(ValueError, match=r"\['a'\]"):
        km.fit(port)
    fitted = km.fit(port.dropna(["a"]))
    assert np.isfinite(fitted.cluster_centers_).all()
    assert np.abs(np.asarray(fitted.cluster_centers_)).max() < 20
    with pytest.raises(ValueError, match=r"\['a'\]"):
        fitted.predict(port)
    with pytest.raises(ValueError, match=r"\['a'\]"):
        fitted.transform(port)["prediction_kmeans"].tolist()


def test_groupby_sorts_by_an_expression_key(on_cpu):
    """``groupby(sort=True)`` over an expression key sorted the result by the
    expression's text, which the result frame does not hold, and raised
    NameError (vaex_tpu raises KeyError there too); the port sorts by the
    key columns, read by position.  Held to pandas."""
    import pandas as pd
    rng = np.random.default_rng(1)
    y, p = rng.integers(0, 3, 200), rng.normal(size=200)
    df = vaex_tpu_torch.from_arrays(y=y, p=p)
    want = pd.DataFrame({"a": y, "b": np.where(p > 0.5, 1, 0)}).groupby(
        ["a", "b"]).size().reset_index()
    for ascending in (True, [False, True]):
        out = df.groupby(["y", "where(p>0.5,1,0)"], agg={"n": "count"}, sort=True,
                         ascending=ascending)
        w = want.sort_values(["a", "b"], ascending=ascending)
        assert out.get_column_names() == ["y", "where_p_0_5_1_0_", "n"]
        npt.assert_array_equal(out["y"].tolist(), w["a"].to_numpy())
        npt.assert_array_equal(out["where_p_0_5_1_0_"].tolist(), w["b"].to_numpy())
        npt.assert_array_equal(out["n"].tolist(), w[0].to_numpy())
    out = df.groupby("y*2", agg={"n": "count"}, sort=True)
    npt.assert_array_equal(out["y_2"].tolist(), [0, 2, 4])


def test_a_batch_past_32_columns_goes_in_calls_of_32(on_cpu, monkeypatch):
    """Every grid kernel takes at most 32 columns a call; a PCA of eight
    features was one pass of 52 means (a sum and a count each), which the
    plan gave to B2 whole and B2 refused on the card.  Now the batch goes
    in calls of at most 32 columns, the count with the first, each through
    the plan, with the sums of the batch in one call; the PCA's fit is one
    pass of its eight means (B1) and its covariance's moments (B4)."""
    from vaex_tpu_torch.ops import grid_additive, grid_plan
    assert grid_plan.strategy(10 ** 6, 1, 52, 52, False) == "b1+b1+b1+b1"
    assert grid_plan.strategy(10 ** 6, 1, 0, 40, True) == "b1+b1"
    assert grid_plan.strategy(10 ** 6, 1, 0, 32, True) == "b1"
    widths = []
    real = grid_additive.grid_additive_reference

    def spy(idx, int_cols, float_cols, G, count):
        widths.append((len(int_cols), len(float_cols), bool(count)))
        return real(idx, int_cols, float_cols, G, count)
    monkeypatch.setitem(grid_plan.KERNELS, grid_plan.B1, spy)
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 5, (1000,), generator=g, dtype=torch.int32)
    ints = [torch.randint(-9, 9, (1000,), generator=g) for _ in range(10)]
    floats = [torch.randn(1000, generator=g, dtype=torch.float64) for _ in range(30)]
    name, got_i, got_f = grid_plan.grid_sums(idx, ints, floats, 5, True)
    want_i, want_f = real(idx, ints, floats, 5, True)
    assert name == "b1+b1" and widths == [(10, 22, True), (0, 8, False)]
    assert torch.equal(got_i, want_i) and torch.allclose(got_f, want_f, rtol=1e-12)
    out = ([torch.zeros(5, dtype=torch.int64) for _ in range(11)],
           [torch.zeros(5, dtype=torch.float64) for _ in range(30)])
    grid_plan.grid_sums(idx, ints, floats, 5, True, out=out)
    assert torch.equal(torch.stack(out[0]), want_i)
    assert torch.allclose(torch.stack(out[1]), want_f, rtol=1e-12)
    frame = vaex_tpu_torch.from_arrays(**{f"x{d}": np.random.default_rng(d).normal(size=500)
                                          for d in range(8)})
    vaex_tpu_torch.ml.PCA(features=[f"x{d}" for d in range(8)]).fit(frame)
    assert widths[-1][0] + widths[-1][1] <= 32
    assert frame.executor.trace_log[-1]["strategies"] == [{"additive": "b1", "moments": "b4"}]
