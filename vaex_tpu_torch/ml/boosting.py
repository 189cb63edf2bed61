"""Boosted-tree and Keras model wrappers (vaex_tpu/ml/boosting.py).

Each wrapper keeps the transformer contract: ``fit`` trains on the
features evaluated to host arrays, ``transform`` attaches the prediction as
a virtual column over a function registered with ``add_function``, and
``state_get`` / ``state_set`` carry the fitted booster as base64 bytes.

The libraries are imported where a wrapper needs them (``_require``):
fitting, predicting or loading without the library raises ImportError
naming it, and the state of an unfitted wrapper round-trips everywhere.
"""

from __future__ import annotations

import base64

import numpy as np

from .transformations import Transformer


def _require(module_name):
    import importlib
    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(
            f"{module_name} is not installed; install it to use this wrapper"
        ) from e


class _BoosterModel(Transformer):
    """Shared shape of the boosted-tree wrappers."""

    prediction_name = "prediction"

    def __init__(self, features=None, target=None, params=None,
                 num_boost_round=100, prediction_name=None, **kwargs):
        super().__init__(features, "")
        self.target = str(target) if target is not None else None
        self.params = dict(params or {})
        self.num_boost_round = int(num_boost_round)
        if prediction_name is not None:
            self.prediction_name = prediction_name
        self.model = None
        for k, v in kwargs.items():
            setattr(self, k, v)

    def _X(self, df):
        cols = [np.asarray(df.evaluate(str(f), array_type="numpy"), dtype="f8")
                for f in self.features]
        return np.stack(cols, axis=1)

    def _y(self, df):
        return np.asarray(df.evaluate(self.target, array_type="numpy"))

    def predict(self, df):
        return self._predict_array(self._X(df))

    def transform(self, df):
        df = df.copy()
        predict = self._predict_array

        def _fn(*cols):
            X = np.stack([np.asarray(c, dtype="f8") for c in cols], axis=1)
            return np.asarray(predict(X))

        name = df.add_function(f"{self.snake_name}_predict", _fn,
                               vectorize=True, unique=True)
        df[self.prediction_name] = f"{name}({', '.join(map(str, self.features))})"
        return df

    # subclasses: _fit_arrays / _predict_array / _model_bytes / _model_from_bytes
    def fit(self, df, **kwargs):
        self._fit_arrays(self._X(df), self._y(df), **kwargs)
        return self

    def state_get(self):
        state = {"class": type(self).__name__,
                 "features": list(self.features),
                 "target": self.target,
                 "params": dict(self.params),
                 "num_boost_round": self.num_boost_round,
                 "prediction_name": self.prediction_name,
                 "model": None}
        if self.model is not None:
            state["model"] = base64.b64encode(self._model_bytes()).decode("ascii")
        return state

    def state_set(self, state):
        for k in ("features", "target", "params", "num_boost_round",
                  "prediction_name"):
            if k in state:
                setattr(self, k, state[k])
        blob = state.get("model")
        self.model = self._model_from_bytes(base64.b64decode(blob)) if blob else None
        return self


class LightGBMModel(_BoosterModel):
    """A LightGBM booster (vaex_tpu/ml/boosting.py:103)."""

    snake_name = "lightgbm_model"

    def _fit_arrays(self, X, y, valid_sets=None, **kwargs):
        lgb = _require("lightgbm")
        data = lgb.Dataset(X, label=y)
        self.model = lgb.train(self.params, data,
                               num_boost_round=self.num_boost_round, **kwargs)

    def _predict_array(self, X):
        return self.model.predict(X)

    def _model_bytes(self):
        return self.model.model_to_string().encode()

    def _model_from_bytes(self, blob):
        lgb = _require("lightgbm")
        return lgb.Booster(model_str=blob.decode())


class XGBoostModel(_BoosterModel):
    """An XGBoost booster (vaex_tpu/ml/boosting.py:126)."""

    snake_name = "xgboost_model"

    def _fit_arrays(self, X, y, evals=(), **kwargs):
        xgb = _require("xgboost")
        dtrain = xgb.DMatrix(X, label=y)
        self.model = xgb.train(self.params, dtrain,
                               num_boost_round=self.num_boost_round, **kwargs)

    def _predict_array(self, X):
        xgb = _require("xgboost")
        return self.model.predict(xgb.DMatrix(X))

    def _model_bytes(self):
        return bytes(self.model.save_raw(raw_format="ubj"))

    def _model_from_bytes(self, blob):
        xgb = _require("xgboost")
        booster = xgb.Booster()
        booster.load_model(bytearray(blob))
        return booster


class CatBoostModel(_BoosterModel):
    """A CatBoost model (vaex_tpu/ml/boosting.py:151); with ``batch_size``
    one model a chunk of rows, summed."""

    snake_name = "catboost_model"

    def __init__(self, features=None, target=None, params=None,
                 num_boost_round=100, prediction_name=None,
                 prediction_type="RawFormulaVal", batch_size=None, **kwargs):
        super().__init__(features, target, params, num_boost_round,
                         prediction_name, **kwargs)
        self.prediction_type = prediction_type
        self.batch_size = batch_size

    def _fit_arrays(self, X, y, **kwargs):
        cb = _require("catboost")
        params = dict(self.params)
        params.setdefault("iterations", self.num_boost_round)
        if self.batch_size:
            # one model a chunk, summed by sum_models
            models = []
            for i in range(0, len(X), int(self.batch_size)):
                pool = cb.Pool(X[i:i + int(self.batch_size)],
                               label=y[i:i + int(self.batch_size)])
                models.append(cb.CatBoost(params).fit(pool, **kwargs))
            self.model = cb.sum_models(models) if len(models) > 1 else models[0]
        else:
            self.model = cb.CatBoost(params).fit(cb.Pool(X, label=y), **kwargs)

    def _predict_array(self, X):
        return np.asarray(self.model.predict(X, prediction_type=self.prediction_type))

    def _model_bytes(self):
        import tempfile, os
        with tempfile.NamedTemporaryFile(suffix=".cbm", delete=False) as f:
            path = f.name
        try:
            self.model.save_model(path)
            with open(path, "rb") as f:
                return f.read()
        finally:
            os.unlink(path)

    def _model_from_bytes(self, blob):
        cb = _require("catboost")
        import tempfile, os
        with tempfile.NamedTemporaryFile(suffix=".cbm", delete=False) as f:
            f.write(blob)
            path = f.name
        try:
            model = cb.CatBoost()
            model.load_model(path)
            return model
        finally:
            os.unlink(path)


class KerasModel(_BoosterModel):
    """A Keras model (vaex_tpu/ml/boosting.py:209), fitted on the features
    evaluated to host arrays."""

    snake_name = "keras_model"

    def __init__(self, features=None, target=None, model=None,
                 prediction_name=None, fit_kwargs=None, **kwargs):
        super().__init__(features, target, None, 0, prediction_name, **kwargs)
        self.model = model
        self.fit_kwargs = dict(fit_kwargs or {})

    def fit(self, df, **kwargs):
        X = self._X(df)
        y = self._y(df)
        self.model.fit(X, y, **{**self.fit_kwargs, **kwargs})
        return self

    def _predict_array(self, X):
        return np.asarray(self.model.predict(X)).squeeze()

    def _model_bytes(self):
        _require("tensorflow")
        import tempfile, os
        with tempfile.NamedTemporaryFile(suffix=".keras", delete=False) as f:
            path = f.name
        try:
            self.model.save(path)
            with open(path, "rb") as f:
                return f.read()
        finally:
            os.unlink(path)

    def _model_from_bytes(self, blob):
        tf = _require("tensorflow")
        import tempfile, os
        with tempfile.NamedTemporaryFile(suffix=".keras", delete=False) as f:
            f.write(blob)
            path = f.name
        try:
            return tf.keras.models.load_model(path)
        finally:
            os.unlink(path)
