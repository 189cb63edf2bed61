"""Transformers: ``fit`` runs the engine's aggregation passes, ``transform``
adds virtual columns (vaex_tpu/ml/transformations.py).

Each class keeps its fitted statistics as plain Python state
(``state_get`` / ``state_set``, vaex_tpu's keys and values), so a
transformer fitted in either package transforms a frame of the other to
the same values, and ``transform`` returns a shallow copy of the frame with
added virtual columns, which the passes evaluate on the card like any other
expression.  The fits' passes: StandardScaler one delayed pass of the means
(B1) and standard deviations (B4); PCA one of ``cov`` (its shifted
moments, B4) and the means (B1), then ``eigh`` of the small matrix on the
host; RobustScaler and the
quantile KBinsDiscretizer a count grid of 16 384 cells a feature (B2,
``percentile_approx``); the encoders a set build or a groupby, their
transform ``_ordinal_values`` through the set probe (B6).
"""

from __future__ import annotations

import numpy as np


class Transformer:
    snake_name = "transformer"

    def __init__(self, features=None, prefix="", **kwargs):
        self.features = list(features) if features else []
        self.prefix = prefix
        for k, v in kwargs.items():
            setattr(self, k, v)

    def fit(self, df):
        raise NotImplementedError

    def transform(self, df):
        raise NotImplementedError

    def fit_transform(self, df):
        self.fit(df)
        return self.transform(df)

    # -- state ---------------------------------------------------------------
    def state_get(self):
        state = {"class": type(self).__name__}
        for k, v in self.__dict__.items():
            state[k] = v.tolist() if isinstance(v, np.ndarray) else v
        return state

    def state_set(self, state):
        """The fitted lists come back as numpy arrays; ``transform`` writes
        their values as Python floats (vaex_tpu writes numpy 2's
        ``np.float64(...)`` into its expressions after a ``state_set``, which
        then fail: ROADMAP, known problems)."""
        for k, v in state.items():
            if k != "class":
                setattr(self, k, np.asarray(v) if isinstance(v, list) and k.endswith("_") else v)
        return self


class StandardScaler(Transformer):
    """(x - mean) / std, the means and stds in one pass
    (vaex_tpu/ml/transformations.py:50)."""

    snake_name = "standard_scaler"

    def __init__(self, features=None, with_mean=True, with_std=True, prefix="standard_scaled_"):
        super().__init__(features, prefix)
        self.with_mean = with_mean
        self.with_std = with_std
        self.mean_ = None
        self.std_ = None

    def fit(self, df):
        means = [df.mean(f, delay=True) for f in self.features]
        stds = [df.std(f, delay=True) for f in self.features]
        df.execute()
        self.mean_ = [float(np.asarray(m.get())) for m in means]
        self.std_ = [float(np.asarray(s.get())) for s in stds]
        return self

    def transform(self, df):
        df = df.copy()
        for f, m, s in zip(self.features, self.mean_, self.std_):
            expr = str(f)
            if self.with_mean:
                expr = f"({expr} - {float(m)!r})"
            if self.with_std:
                expr = f"({expr} / {float(s)!r})"
            df[self.prefix + f] = expr
        return df


class MinMaxScaler(Transformer):
    """(vaex_tpu/ml/transformations.py:82)"""

    snake_name = "minmax_scaler"

    def __init__(self, features=None, feature_range=(0, 1), prefix="minmax_scaled_"):
        super().__init__(features, prefix)
        self.feature_range = tuple(feature_range)
        self.fmin_ = None
        self.fmax_ = None

    def fit(self, df):
        mms = [df.minmax(f, delay=True) for f in self.features]
        df.execute()
        values = [np.asarray(p.get()) for p in mms]
        self.fmin_ = [float(v[0]) for v in values]
        self.fmax_ = [float(v[1]) for v in values]
        return self

    def transform(self, df):
        df = df.copy()
        a, b = self.feature_range
        for f, lo, hi in zip(self.features, map(float, self.fmin_), map(float, self.fmax_)):
            scale = (hi - lo) or 1.0
            df[self.prefix + f] = f"({a!r} + ({b!r} - {a!r}) * (({f}) - {lo!r}) / {scale!r})"
        return df


class MaxAbsScaler(Transformer):
    """(vaex_tpu/ml/transformations.py:110)"""

    snake_name = "max_abs_scaler"

    def __init__(self, features=None, prefix="absmax_scaled_"):
        super().__init__(features, prefix)
        self.absmax_ = None

    def fit(self, df):
        mms = [df.minmax(f, delay=True) for f in self.features]
        df.execute()
        self.absmax_ = [float(np.max(np.abs(np.asarray(p.get())))) or 1.0 for p in mms]
        return self

    def transform(self, df):
        df = df.copy()
        for f, m in zip(self.features, self.absmax_):
            df[self.prefix + f] = f"(({f}) / {float(m)!r})"
        return df


class RobustScaler(Transformer):
    """Median / IQR scaling (vaex_tpu/ml/transformations.py:132): the three
    percentiles of a feature from one count grid."""

    snake_name = "robust_scaler"

    def __init__(self, features=None, with_centering=True, with_scaling=True,
                 percentile_range=(25, 75), prefix="robust_scaled_"):
        super().__init__(features, prefix)
        self.with_centering = with_centering
        self.with_scaling = with_scaling
        self.percentile_range = tuple(percentile_range)
        self.center_ = None
        self.scale_ = None

    def fit(self, df):
        self.center_ = []
        self.scale_ = []
        lo_p, hi_p = self.percentile_range
        for f in self.features:
            med, lo, hi = df.percentile_approx(f, [50.0, lo_p, hi_p])
            self.center_.append(float(med))
            self.scale_.append(float(hi - lo) or 1.0)
        return self

    def transform(self, df):
        df = df.copy()
        for f, c, s in zip(self.features, self.center_, self.scale_):
            expr = str(f)
            if self.with_centering:
                expr = f"({expr} - {float(c)!r})"
            if self.with_scaling:
                expr = f"({expr} / {float(s)!r})"
            df[self.prefix + f] = expr
        return df


class LabelEncoder(Transformer):
    """value -> its ordinal among the fitted labels
    (vaex_tpu/ml/transformations.py:170).  A value that is not a label (NaN
    and a missing value among them) is -1 with ``allow_unseen``; without it
    ``transform`` counts such rows of the frame it transforms (one pass for
    all features) and raises ValueError where there are any, as vaex-ml
    does (vaex_tpu encodes them as -1 either way: ROADMAP, known
    problems)."""

    snake_name = "label_encoder"

    def __init__(self, features=None, prefix="label_encoded_", allow_unseen=False):
        super().__init__(features, prefix)
        self.allow_unseen = allow_unseen
        self.labels_ = {}

    def fit(self, df):
        for f in self.features:
            oset = df._set(f)
            self.labels_[f] = oset.key_array(masked=False)[:oset.n_keys].tolist()
        return self

    def transform(self, df):
        from ..expression import _set_of
        df = df.copy()
        names = {f: df.add_variable(f"label_set_{f}", _set_of(self.labels_[f]), unique=True)
                 for f in self.features}
        if not self.allow_unseen:
            unseen = {f: df.count(selection=f"~isin_set({f}, {var})", delay=True)
                      for f, var in names.items()}
            df.execute()
            for f, count in unseen.items():
                if int(count.get()):
                    shown = df.filter(f"~isin_set({f}, {names[f]})").unique(f)[:5]
                    raise ValueError(f"LabelEncoder: {int(count.get())} value(s) of {f!r} are "
                                     f"not among its {len(self.labels_[f])} labels, e.g. "
                                     f"{shown}; allow_unseen=True encodes them as -1")
        for f, var in names.items():
            df[self.prefix + f] = f"_ordinal_values({f}, {var})"
        return df


class OneHotEncoder(Transformer):
    """One virtual 0/1 column per category (vaex_tpu/ml/transformations.py:200);
    on a row whose feature is missing every value column holds ``zero`` and
    the ``_missing`` column ``one``, as pandas' ``get_dummies(dummy_na=True)``
    gives, where vaex_tpu gives a missing value for a masked number (ROADMAP,
    known problems)."""

    snake_name = "one_hot_encoder"

    def __init__(self, features=None, prefix="", one=1, zero=0):
        super().__init__(features, prefix)
        self.one = one
        self.zero = zero
        self.uniques_ = {}

    def fit(self, df):
        for f in self.features:
            values = df.unique(f, dropmissing=False, array_type="list")
            self.uniques_[f] = sorted([v for v in values if v is not None],
                                      key=lambda v: (isinstance(v, str), v)) + \
                ([None] if any(v is None for v in values) else [])
        return self

    def transform(self, df):
        df = df.copy()
        for f in self.features:
            for value in self.uniques_[f]:
                if value is None:
                    column_name = self.prefix + f + "_missing"
                    expr = f"where(ismissing({f}), {self.one!r}, {self.zero!r})"
                else:
                    safe = str(value).replace(" ", "_").replace("-", "_")
                    column_name = self.prefix + f + "_" + safe
                    literal = repr(value if not isinstance(value, np.generic) else value.item())
                    # a missing row is zero in every value column (pandas'
                    # get_dummies(dummy_na=True)), not missing: its missing
                    # comparison is False (a where keeps any operand's mask)
                    expr = (f"where(fillmissing(({f} == {literal}), False), {self.one!r}, "
                            f"{self.zero!r})")
                df[column_name] = expr
        return df


class MultiHotEncoder(OneHotEncoder):
    """(vaex_tpu/ml/transformations.py:235): OneHotEncoder's columns."""

    snake_name = "multi_hot_encoder"


class FrequencyEncoder(Transformer):
    """value -> its share of the rows (vaex_tpu/ml/transformations.py:241); a
    value not seen in the fit gives NaN (``unseen="nan"``) or 0.0
    (``unseen="zero"``), where vaex_tpu gives a missing value (ROADMAP,
    known problems); a missing value stays missing."""

    snake_name = "frequency_encoder"

    def __init__(self, features=None, unseen="nan", prefix="frequency_encoded_"):
        super().__init__(features, prefix)
        self.unseen = unseen
        self.mappings_ = {}

    def fit(self, df):
        n = len(df)
        for f in self.features:
            vc = df[f].value_counts(dropna=False)
            self.mappings_[f] = {k: v / n for k, v in vc.items()}
        return self

    def transform(self, df):
        df = df.copy()
        default = 0.0 if self.unseen == "zero" else np.nan
        for f in self.features:
            mapping = {k: v for k, v in self.mappings_[f].items()
                       if not (isinstance(k, str) and k == "missing")}
            df[self.prefix + f] = df[f].map(mapping, default_value=default)
        return df


class CycleTransformer(Transformer):
    """sin / cos pair of a cyclic feature (vaex_tpu/ml/transformations.py:268)."""

    snake_name = "cycle_transformer"

    def __init__(self, features=None, n=None, prefix_x="", prefix_y="",
                 suffix_x="_x", suffix_y="_y"):
        super().__init__(features, "")
        self.n = n
        self.prefix_x = prefix_x
        self.prefix_y = prefix_y
        self.suffix_x = suffix_x
        self.suffix_y = suffix_y

    def fit(self, df):
        return self

    def transform(self, df):
        df = df.copy()
        for f in self.features:
            df[self.prefix_x + f + self.suffix_x] = f"cos(2 * 3.141592653589793 * ({f}) / {self.n!r})"
            df[self.prefix_y + f + self.suffix_y] = f"sin(2 * 3.141592653589793 * ({f}) / {self.n!r})"
        return df


class PCA(Transformer):
    """PCA from the engine's covariance matrix (vaex_tpu/ml/transformations.py:293):
    ``cov`` and the means in one pass, ``eigh`` of the small matrix on the
    host."""

    snake_name = "pca"

    def __init__(self, features=None, n_components=None, prefix="PCA_", whiten=False):
        super().__init__(features, prefix)
        self.n_components = n_components
        self.whiten = whiten
        self.means_ = None
        self.eigen_vectors_ = None
        self.eigen_values_ = None

    def fit(self, df):
        cov = df.cov(self.features, delay=True)
        means = [df.mean(f, delay=True) for f in self.features]
        df.execute()
        self.means_ = [float(np.asarray(m.get())) for m in means]
        eigen_values, eigen_vectors = np.linalg.eigh(np.asarray(cov.get()))
        order = np.argsort(eigen_values)[::-1]
        self.eigen_values_ = eigen_values[order].tolist()
        self.eigen_vectors_ = eigen_vectors[:, order].tolist()
        return self

    def transform(self, df):
        df = df.copy()
        V = np.asarray(self.eigen_vectors_)
        k = self.n_components or len(self.features)
        centered = [f"(({f}) - {float(m)!r})" for f, m in zip(self.features, self.means_)]
        for i in range(k):
            terms = [f"({float(V[j, i])!r}) * {centered[j]}" for j in range(len(self.features))]
            df[f"{self.prefix}{i}"] = " + ".join(terms)
        return df


class KBinsDiscretizer(Transformer):
    """Bins of a continuous feature (vaex_tpu/ml/transformations.py:328):
    uniform over its range, or at its percentiles from one count grid."""

    snake_name = "kbins_discretizer"

    def __init__(self, features=None, n_bins=5, strategy="uniform", prefix="binned_"):
        super().__init__(features, prefix)
        self.n_bins = n_bins
        self.strategy = strategy
        self.bin_edges_ = {}

    def fit(self, df):
        for f in self.features:
            if self.strategy == "uniform":
                vmin, vmax = df.minmax(f)
                edges = np.linspace(vmin, vmax, self.n_bins + 1)
            elif self.strategy == "quantile":
                qs = np.linspace(0, 100, self.n_bins + 1)
                edges = np.asarray(df.percentile_approx(f, [float(q) for q in qs]))
            else:
                raise ValueError(f"unknown strategy {self.strategy!r}")
            self.bin_edges_[f] = edges.tolist()
        return self

    def transform(self, df):
        df = df.copy()
        for f in self.features:
            inner = np.asarray(self.bin_edges_[f])[1:-1]
            var = df.add_variable(f"kbins_edges_{f}", inner, unique=True)
            df[self.prefix + f] = f"searchsorted({f}, {var}, side='right')"
        return df


class BayesianTargetEncoder(Transformer):
    """Each category's target mean blended with the global mean by
    ``weight`` (vaex_tpu/ml/transformations.py:362); a category not seen in
    the fit gives the global mean (vaex_tpu gives a missing value: ROADMAP,
    known problems); a missing value stays missing."""

    snake_name = "bayesian_target_encoder"

    def __init__(self, features=None, target=None, weight=100, prefix="mean_encoded_"):
        super().__init__(features, prefix)
        self.target = target
        self.weight = weight
        self.mappings_ = {}
        self.global_mean_ = None

    def fit(self, df):
        from .. import agg as agg_module
        self.global_mean_ = float(np.asarray(df.mean(self.target)))
        for f in self.features:
            gb = df.groupby(f, agg={"__count": "count",
                                    "__mean": agg_module.mean(self.target)}, sort=True)
            keys = gb[f].tolist()
            counts = np.asarray(gb["__count"].tolist(), dtype=np.float64)
            means = np.asarray(gb["__mean"].tolist(), dtype=np.float64)
            blended = (counts * means + self.weight * self.global_mean_) / (counts + self.weight)
            self.mappings_[f] = dict(zip(keys, blended.tolist()))
        return self

    def transform(self, df):
        df = df.copy()
        for f in self.features:
            mapping = {k: v for k, v in self.mappings_[f].items() if k is not None}
            df[self.prefix + f] = df[f].map(mapping, default_value=self.global_mean_)
        return df


class WeightOfEvidenceEncoder(Transformer):
    """log(share of positives / share of negatives) of each category
    (vaex_tpu/ml/transformations.py:395); NaN for a category not seen in the
    fit."""

    snake_name = "woe_encoder"

    def __init__(self, features=None, target=None, unseen="nan", epsilon=1e-9,
                 prefix="woe_encoded_"):
        super().__init__(features, prefix)
        self.target = target
        self.epsilon = epsilon
        self.mappings_ = {}

    def fit(self, df):
        from .. import agg as agg_module
        for f in self.features:
            gb = df.groupby(f, agg={"__pos": agg_module.sum(self.target), "__n": "count"},
                            sort=True)
            keys = gb[f].tolist()
            pos = np.asarray(gb["__pos"].tolist(), dtype=np.float64)
            n = np.asarray(gb["__n"].tolist(), dtype=np.float64)
            neg = n - pos
            p = np.clip(pos / np.maximum(pos.sum(), 1), self.epsilon, None)
            q = np.clip(neg / np.maximum(neg.sum(), 1), self.epsilon, None)
            woe = np.log(p / q)
            self.mappings_[f] = dict(zip(keys, woe.tolist()))
        return self

    def transform(self, df):
        df = df.copy()
        for f in self.features:
            mapping = {k: v for k, v in self.mappings_[f].items() if k is not None}
            df[self.prefix + f] = df[f].map(mapping, default_value=np.nan)
        return df


class GroupByTransformer(Transformer):
    """Fitted group aggregations joined back onto the frame
    (vaex_tpu/ml/transformations.py:429)."""

    snake_name = "groupby_transformer"

    def __init__(self, by=None, agg=None, rsuffix="_agg", df_group=None):
        super().__init__([], "")
        self.by = by
        self.agg = agg
        self.rsuffix = rsuffix
        self.df_group = df_group

    def fit(self, df):
        self.df_group = df.groupby(self.by, agg=self.agg, sort=True)
        return self

    def transform(self, df):
        return df.join(self.df_group, on=str(self.by), rsuffix=self.rsuffix,
                       allow_duplication=False)
