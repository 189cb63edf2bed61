"""scikit-learn predictor wrappers (vaex_tpu/ml/sklearn.py).

``Predictor`` fits any sklearn estimator on the features evaluated to host
arrays (sklearn takes nothing else) and attaches its predictions as a
virtual column over a function registered with ``add_function``, which the
host stage of a pass runs; so a fitted model is part of the frame's state
like every other transformer.  ``IncrementalPredictor`` feeds
``partial_fit`` a chunk of rows at a time.
"""

from __future__ import annotations

import numpy as np

from .transformations import Transformer


class Predictor(Transformer):
    """An sklearn estimator over the features (vaex_tpu/ml/sklearn.py:17)."""

    snake_name = "sklearn_predictor"

    def __init__(self, model=None, features=None, target=None,
                 prediction_name="prediction"):
        super().__init__(features, "")
        self.model = model
        self.target = target
        self.prediction_name = prediction_name

    def _X(self, df):
        cols = [np.asarray(df.evaluate(f, array_type="numpy"), dtype="f8")
                for f in self.features]
        return np.stack(cols, axis=1)

    def fit(self, df, **kwargs):
        X = self._X(df)
        y = np.asarray(df.evaluate(str(self.target), array_type="numpy"))
        self.model.fit(X, y, **kwargs)
        return self

    def predict(self, df):
        return self.model.predict(self._X(df))

    def transform(self, df):
        df = df.copy()
        model = self.model

        def _predict(*cols):
            X = np.stack([np.asarray(c, dtype="f8") for c in cols], axis=1)
            return np.asarray(model.predict(X))

        name = df.add_function("sklearn_predict", _predict, vectorize=True, unique=True)
        df[self.prediction_name] = f"{name}({', '.join(map(str, self.features))})"
        return df


class IncrementalPredictor(Predictor):
    """``partial_fit`` over chunks of ``batch_size`` rows, ``num_epochs`` times
    (vaex_tpu/ml/sklearn.py:54)."""

    snake_name = "sklearn_incremental_predictor"

    def __init__(self, model=None, features=None, target=None,
                 prediction_name="prediction", batch_size=1_000_000, num_epochs=1,
                 shuffle=False, partial_fit_kwargs=None):
        super().__init__(model, features, target, prediction_name)
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.shuffle = shuffle
        self.partial_fit_kwargs = partial_fit_kwargs or {}

    def fit(self, df, progress=None):
        for epoch in range(self.num_epochs):
            d = df.shuffle() if self.shuffle else df
            for i1, i2, _ in d.evaluate_iterator(self.features[0],
                                                 chunk_size=self.batch_size):
                sub = d[i1:i2]
                X = self._X(sub)
                y = np.asarray(sub.evaluate(str(self.target), array_type="numpy"))
                self.model.partial_fit(X, y, **self.partial_fit_kwargs)
        return self
