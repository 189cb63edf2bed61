"""The port's KerasModel (vaex_tpu_torch.ml.boosting) with TensorFlow, where
it is installed: fitted on a port frame, its prediction column equal to the
model's own predict, its state (the saved model as base64 bytes) loaded
into a second wrapper that predicts the same; and vaex_tpu's wrapper on the
same frame, fitted from the same weights, predicting the same.  A file of
its own: importing TensorFlow takes seconds."""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import same_frames


def _model(tf, weights=None):
    model = tf.keras.Sequential([tf.keras.Input(shape=(2,)), tf.keras.layers.Dense(1)])
    model.compile(optimizer="sgd", loss="mse")
    if weights is not None:
        model.set_weights(weights)
    return model


def test_keras_model_fit_predict_and_state():
    tf = pytest.importorskip("tensorflow")
    tf.keras.utils.set_random_seed(0)
    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=256), "b": rng.normal(size=256)}
    arrays["y"] = 2 * arrays["a"] - arrays["b"] + 0.5
    ref, port = same_frames(arrays)
    m = vaex_tpu_torch.ml.KerasModel(features=["a", "b"], target="y", model=_model(tf),
                                     fit_kwargs={"epochs": 2, "verbose": 0})
    m.fit(port)
    X = np.stack([arrays["a"], arrays["b"]], axis=1)
    direct = np.asarray(m.model.predict(X, verbose=0)).squeeze()
    column = np.asarray(m.transform(port)["prediction"].tolist())
    npt.assert_allclose(column, direct, rtol=1e-6, atol=1e-7)
    state = m.state_get()
    assert isinstance(state["model"], str) and state["features"] == ["a", "b"]
    loaded = vaex_tpu_torch.ml.KerasModel().state_set(state)
    npt.assert_allclose(loaded.predict(port), m.predict(port), rtol=1e-6, atol=1e-7)
    r = vaex_tpu.ml.KerasModel(features=["a", "b"], target="y",
                               model=_model(tf, m.model.get_weights()))
    npt.assert_allclose(np.asarray(r.transform(ref)["prediction"].tolist()), column,
                        rtol=1e-6, atol=1e-7)
