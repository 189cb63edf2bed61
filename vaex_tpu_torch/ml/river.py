"""Incremental learners (vaex_tpu/ml/river.py).

``RiverModel`` wraps any estimator speaking river's mini-batch protocol,
``learn_many(X: pandas.DataFrame, y: pandas.Series)`` and
``predict_many(X) -> array``, and feeds it ``batch_size`` rows at a time,
each batch evaluated by the port's passes and copied to the host, where
the model runs.  Predictions attach as a virtual column over a registered
function, as every other transformer's state does.

The river package is optional; :class:`OnlineSGDRegressor` and
:class:`OnlineSGDClassifier` are small numpy models speaking the same
protocol, so incremental learning works without it.
"""

from __future__ import annotations

import numpy as np

from .transformations import Transformer


class RiverModel(Transformer):
    """Training in batches through river's mini-batch API
    (vaex_tpu/ml/river.py:23)."""

    snake_name = "river_model"

    def __init__(self, model=None, features=None, target=None,
                 prediction_name="prediction", batch_size=1_000_000,
                 num_epochs=1, shuffle=False, prediction_type="predict"):
        super().__init__(features, "")
        self.model = model
        self.target = target
        self.prediction_name = prediction_name
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.shuffle = shuffle
        self.prediction_type = prediction_type  # 'predict' | 'predict_proba'

    def _X_frame(self, df, i1=None, i2=None):
        import pandas as pd
        cols = {}
        for f in self.features:
            v = (df.evaluate(str(f), array_type="numpy") if i1 is None
                 else df.evaluate(str(f), i1, i2, array_type="numpy"))
            cols[str(f)] = np.asarray(v, dtype="f8")
        return pd.DataFrame(cols)

    def fit(self, df, progress=None):
        import pandas as pd
        for epoch in range(self.num_epochs):
            d = df.shuffle() if self.shuffle else df
            n = len(d)
            for i1 in range(0, n, self.batch_size):
                i2 = min(i1 + self.batch_size, n)
                X = self._X_frame(d, i1, i2)
                y = pd.Series(np.asarray(
                    d.evaluate(str(self.target), i1, i2, array_type="numpy")))
                self.model.learn_many(X, y)
        return self

    def predict(self, df):
        X = self._X_frame(df)
        if self.prediction_type == "predict_proba":
            out = self.model.predict_proba_many(X)
            return np.asarray(out)
        return np.asarray(self.model.predict_many(X))

    def transform(self, df):
        df = df.copy()
        model = self.model
        feature_names = [str(f) for f in self.features]
        proba = self.prediction_type == "predict_proba"

        def _predict(*cols):
            import pandas as pd
            X = pd.DataFrame({name: np.asarray(c, dtype="f8")
                              for name, c in zip(feature_names, cols)})
            out = (model.predict_proba_many(X) if proba
                   else model.predict_many(X))
            return np.asarray(out)

        name = df.add_function("river_predict", _predict, vectorize=True,
                               unique=True)
        df[self.prediction_name] = f"{name}({', '.join(feature_names)})"
        return df


class _OnlineSGDBase:
    """A linear model trained by mini-batch SGD on the host, speaking
    river's ``learn_many`` / ``predict_many`` protocol (vaex_tpu/ml/river.py:90)."""

    def __init__(self, learning_rate=0.01, l2=0.0):
        self.learning_rate = learning_rate
        self.l2 = l2
        self.weights = None
        self.intercept = 0.0
        self._steps = 0

    def _ensure(self, n_features):
        if self.weights is None:
            self.weights = np.zeros(n_features)

    def _raw(self, X):
        self._ensure(X.shape[1])
        return X @ self.weights + self.intercept

    def _update(self, X, grad):
        n = len(X)
        self._steps += 1
        lr = self.learning_rate
        self.weights -= lr * (X.T @ grad / n + self.l2 * self.weights)
        self.intercept -= lr * float(grad.mean())


class OnlineSGDRegressor(_OnlineSGDBase):
    """Squared-loss streaming linear regression."""

    def learn_many(self, X, y):
        Xv = np.asarray(X, dtype="f8")
        yv = np.asarray(y, dtype="f8")
        self._ensure(Xv.shape[1])
        # several small steps per batch help convergence on few epochs
        for sl in np.array_split(np.arange(len(Xv)), max(1, len(Xv) // 1024)):
            grad = self._raw(Xv[sl]) - yv[sl]
            self._update(Xv[sl], grad)
        return self

    def predict_many(self, X):
        return self._raw(np.asarray(X, dtype="f8"))


class OnlineSGDClassifier(_OnlineSGDBase):
    """Log-loss streaming binary classifier (labels {0, 1})."""

    def learn_many(self, X, y):
        Xv = np.asarray(X, dtype="f8")
        yv = np.asarray(y, dtype="f8")
        self._ensure(Xv.shape[1])
        for sl in np.array_split(np.arange(len(Xv)), max(1, len(Xv) // 1024)):
            p = 1.0 / (1.0 + np.exp(-self._raw(Xv[sl])))
            self._update(Xv[sl], p - yv[sl])
        return self

    def predict_proba_many(self, X):
        return 1.0 / (1.0 + np.exp(-self._raw(np.asarray(X, dtype="f8"))))

    def predict_many(self, X):
        return (self.predict_proba_many(X) >= 0.5).astype(np.int64)
