"""Machine learning on the frame (vaex_tpu/ml/__init__.py): ``fit`` runs
the engine's passes on the card and ``transform`` only adds virtual
columns, so a fitted pipeline is the frame's state: ``state_get`` gives it,
``state_set`` puts it onto any frame with the same columns, and the passes
evaluate it on the card like any other expression.  KMeans's Lloyd step
runs on the pass device (:mod:`.cluster`); the sklearn, river and booster
wrappers fit on host arrays, as those libraries need.  Importing this
package imports none of sklearn, lightgbm, xgboost, catboost, tensorflow or
river.
"""

from .transformations import (  # noqa: F401
    CycleTransformer,
    FrequencyEncoder,
    KBinsDiscretizer,
    LabelEncoder,
    MaxAbsScaler,
    MinMaxScaler,
    MultiHotEncoder,
    OneHotEncoder,
    PCA,
    RobustScaler,
    StandardScaler,
    Transformer,
    BayesianTargetEncoder,
    WeightOfEvidenceEncoder,
    GroupByTransformer,
)

from . import sklearn  # noqa: F401
from .sklearn import IncrementalPredictor, Predictor  # noqa: F401
from . import cluster  # noqa: F401
from .cluster import KMeans  # noqa: F401
from . import river  # noqa: F401
from .river import OnlineSGDClassifier, OnlineSGDRegressor, RiverModel  # noqa: F401
from . import boosting  # noqa: F401
from .boosting import (  # noqa: F401
    CatBoostModel,
    KerasModel,
    LightGBMModel,
    XGBoostModel,
)

from ..dataframe import register_dataframe_accessor


@register_dataframe_accessor("ml")
class DataFrameAccessorML:
    """``df.ml``: the transformers fitted in one call, and the metrics."""

    def __init__(self, df):
        self.df = df

    @property
    def metrics(self):
        """The metrics through the frame's aggregations (:mod:`.metrics`)."""
        from .metrics import DataFrameAccessorMetrics
        return DataFrameAccessorMetrics(self.df)

    def label_encoder(self, features, prefix="label_encoded_", allow_unseen=False):
        t = LabelEncoder(features=features, prefix=prefix, allow_unseen=allow_unseen)
        t.fit(self.df)
        return t

    def one_hot_encoder(self, features, prefix="", one=1, zero=0):
        t = OneHotEncoder(features=features, prefix=prefix, one=one, zero=zero)
        t.fit(self.df)
        return t

    def frequency_encoder(self, features, unseen="nan", prefix="frequency_encoded_"):
        t = FrequencyEncoder(features=features, unseen=unseen, prefix=prefix)
        t.fit(self.df)
        return t

    def standard_scaler(self, features, with_mean=True, with_std=True, prefix="standard_scaled_"):
        t = StandardScaler(features=features, with_mean=with_mean, with_std=with_std, prefix=prefix)
        t.fit(self.df)
        return t

    def minmax_scaler(self, features, feature_range=(0, 1), prefix="minmax_scaled_"):
        t = MinMaxScaler(features=features, feature_range=feature_range, prefix=prefix)
        t.fit(self.df)
        return t

    def max_abs_scaler(self, features, prefix="absmax_scaled_"):
        t = MaxAbsScaler(features=features, prefix=prefix)
        t.fit(self.df)
        return t

    def robust_scaler(self, features, with_centering=True, with_scaling=True,
                      percentile_range=(25, 75), prefix="robust_scaled_"):
        t = RobustScaler(features=features, with_centering=with_centering,
                         with_scaling=with_scaling, percentile_range=percentile_range,
                         prefix=prefix)
        t.fit(self.df)
        return t

    def pca(self, features, n_components=None, prefix="PCA_"):
        t = PCA(features=features, n_components=n_components or len(features), prefix=prefix)
        t.fit(self.df)
        return t

    def kbins_discretizer(self, features, n_bins=5, strategy="uniform", prefix="binned_"):
        t = KBinsDiscretizer(features=features, n_bins=n_bins, strategy=strategy, prefix=prefix)
        t.fit(self.df)
        return t

    def cycle_transformer(self, features, n, prefix_x="", prefix_y="", suffix_x="_x", suffix_y="_y"):
        t = CycleTransformer(features=features, n=n, prefix_x=prefix_x, prefix_y=prefix_y,
                             suffix_x=suffix_x, suffix_y=suffix_y)
        t.fit(self.df)
        return t
