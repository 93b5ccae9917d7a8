"""Time-series models for AutoML trials (reference
automl/model/VanillaLSTM.py, Seq2Seq.py), the JAX package's models on the
port's layers: ``VanillaLSTM`` on ``Sequential`` / ``LSTM`` / ``Dropout``
/ ``Dense``, and ``Seq2SeqForecaster`` on ``Seq2SeqBlock``, an LSTM
encoder-decoder layer whose leaves are named as the JAX block's
(``enc`` / ``dec`` sub-trees of ``wi``, ``wh``, ``b``; ``proj_w``,
``proj_b``), so weights carry across with ``convert.load_jax_params``.

``fit_eval(x, y, validation_data, **config) -> val_metric`` is the
trainable contract the search engine scores.  The models train on the
context's device (the card unless the context says ``device="cpu"``);
``save`` writes ``{"params", "state"}`` in the JAX package's archive
format (``train/checkpoint.save_pytree``), and ``restore`` reads an
archive written by either package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from analytics_zoo_tpu_torch.automl.common.metrics import Evaluator
from analytics_zoo_tpu_torch.nn.module import Layer, StatelessLayer


def _build_lstm(input_shape, config, out_dim):
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.nn.layers.core import Dense, Dropout
    from analytics_zoo_tpu_torch.nn.layers.recurrent import LSTM
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    reset_name_scope()
    m = Sequential()
    m.add(LSTM(int(config.get("lstm_1_units", 32)), return_sequences=True,
               input_shape=tuple(input_shape)))
    m.add(Dropout(float(config.get("dropout", 0.2))))
    m.add(LSTM(int(config.get("lstm_2_units", 32))))
    m.add(Dropout(float(config.get("dropout", 0.2))))
    m.add(Dense(out_dim))
    return m


class VanillaLSTM:
    """2-layer LSTM regressor (future_seq_len == 1)."""

    out_is_seq = False

    def __init__(self, check_optional_config: bool = False):
        self.model = None
        self.config: Dict = {}

    def _ensure(self, x, y, config):
        out_dim = y.shape[1] if y.ndim > 1 else 1
        self.config = dict(config)
        self.model = _build_lstm(x.shape[1:], config, out_dim)
        from analytics_zoo_tpu_torch.train.optimizers import Adam

        self.model.compile(
            optimizer=Adam(lr=float(config.get("lr", 1e-3))), loss="mse")

    def fit_eval(self, x, y, validation_data=None, metric: str = "mse",
                 **config) -> float:
        if y.ndim == 1:
            y = y[:, None]
        self._ensure(x, y, config)
        vx, vy = validation_data if validation_data is not None else (x, y)
        if vy.ndim == 1:
            vy = vy[:, None]
        self.model.fit(x, y, batch_size=int(config.get("batch_size", 32)),
                       nb_epoch=int(config.get("epochs", 1)), verbose=False)
        pred = self.model.predict(vx, batch_size=1024)
        return Evaluator.evaluate(metric, vy, pred)

    def predict(self, x) -> np.ndarray:
        return self.model.predict(x, batch_size=1024)

    def evaluate(self, x, y, metric: str = "mse") -> float:
        return Evaluator.evaluate(metric, y, self.predict(x))

    # -- persistence -------------------------------------------------------
    def state(self):
        return {"params": self.model.params(), "state": self.model.state()}

    def save(self, path: str) -> None:
        self.model.save_weights(path)

    def restore(self, path: str, x_shape, out_dim, config) -> None:
        # rebuild through _ensure so subclasses (encoder-decoder)
        # reconstruct their own architecture
        x = np.zeros((2,) + tuple(x_shape), np.float32)
        y = np.zeros((2, out_dim), np.float32)
        self._ensure(x, y, config)
        self.model.load_weights(path)


# ---------------------------------------------------------------------------
# encoder-decoder
# ---------------------------------------------------------------------------

def _glorot(generator, shape):
    from analytics_zoo_tpu_torch.nn import initializers

    return initializers.get("glorot_uniform")(generator, shape)


class _LSTMCell(Layer):
    """Leaves of one LSTM of the encoder-decoder: ``wi`` (F, 4H), ``wh``
    (H, 4H), ``b`` (4H,), gate order (i, f, o, g) as in the JAX block."""

    def __init__(self, units: int, **kw):
        super().__init__(**kw)
        self.units = units

    def build(self, generator, d_in):
        h = self.units
        self.set_leaf("wi", _glorot(generator, (d_in, 4 * h)))
        self.set_leaf("wh", _glorot(generator, (h, 4 * h)))
        self.set_leaf("b", torch.zeros((4 * h,), dtype=torch.float32))

    def step(self, carry, x):
        h_prev, c_prev = carry
        d_h = self.units
        g = x @ self.leaf("wi") + h_prev @ self.leaf("wh") + self.leaf("b")
        i = torch.sigmoid(g[..., :d_h])
        f = torch.sigmoid(g[..., d_h:2 * d_h] + 1.0)      # forget bias 1
        o = torch.sigmoid(g[..., 2 * d_h:3 * d_h])
        c = f * c_prev + i * torch.tanh(g[..., 3 * d_h:])
        return o * torch.tanh(c), c


class Seq2SeqBlock(StatelessLayer):
    """Encoder-decoder forecaster (reference automl/model/Seq2Seq.py): an
    LSTM encodes the history window; a decoder LSTM unrolls
    ``future_seq_len`` steps autoregressively from the encoder state (its
    own previous prediction as input — inference-consistent, no
    teacher-forcing/inference mismatch), each step projected to the
    target dim.  Both loops are Python loops over time; on the card the
    whole step is captured into one CUDA graph, so they cost no host
    launches."""

    def __init__(self, future_seq_len: int, latent_dim: int = 32,
                 out_dim: int = 1, **kw):
        super().__init__(**kw)
        self.future_seq_len = future_seq_len
        self.latent_dim = latent_dim
        self.out_dim = out_dim
        self.add_subtree("enc", _LSTMCell(latent_dim, name="enc"))
        self.add_subtree("dec", _LSTMCell(latent_dim, name="dec"))

    def build(self, generator, input_shape):
        self.subtree("enc").build(generator, input_shape[-1])
        self.subtree("dec").build(generator, self.out_dim)
        self.set_leaf("proj_w", _glorot(generator,
                                        (self.latent_dim, self.out_dim)))
        self.set_leaf("proj_b", torch.zeros((self.out_dim,),
                                            dtype=torch.float32))

    def output_shape(self, input_shape):
        return (input_shape[0], self.future_seq_len * self.out_dim)

    def forward(self, x):
        b = x.shape[0]
        enc, dec = self.subtree("enc"), self.subtree("dec")
        zero = torch.zeros((b, self.latent_dim), dtype=x.dtype,
                           device=x.device)
        carry = (zero, zero)
        for t in range(x.shape[1]):
            carry = enc.step(carry, x[:, t])
        y_prev = torch.zeros((b, self.out_dim), dtype=x.dtype,
                             device=x.device)
        w, bias = self.leaf("proj_w"), self.leaf("proj_b")
        ys = []
        for _ in range(self.future_seq_len):
            carry = dec.step(carry, y_prev)
            y_prev = carry[0] @ w + bias
            ys.append(y_prev)
        return torch.stack(ys, dim=1).reshape(b, -1)   # (B, F*out_dim)


class Seq2SeqForecaster(VanillaLSTM):
    """Multi-step forecaster (future_seq_len > 1) — a true LSTM
    encoder-decoder (reference automl/model/Seq2Seq.py), the decoder
    unrolled over the horizon."""

    def __init__(self, future_seq_len: int = 2, **kw):
        super().__init__(**kw)
        self.future_seq_len = future_seq_len

    def _ensure(self, x, y, config):
        from analytics_zoo_tpu_torch.nn import reset_name_scope
        from analytics_zoo_tpu_torch.nn.topology import Sequential
        from analytics_zoo_tpu_torch.train.optimizers import Adam

        reset_name_scope()
        out_dim = y.shape[1] if y.ndim > 1 else 1
        self.config = dict(config)
        m = Sequential()
        m.add(Seq2SeqBlock(
            future_seq_len=max(self.future_seq_len, 1),
            latent_dim=int(config.get("latent_dim",
                                      config.get("lstm_1_units", 32))),
            out_dim=max(1, out_dim // max(self.future_seq_len, 1)),
            input_shape=tuple(x.shape[1:])))
        self.model = m
        self.model.compile(
            optimizer=Adam(lr=float(config.get("lr", 1e-3))), loss="mse")
