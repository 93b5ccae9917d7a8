"""MTNet — the reference's flagship time-series AutoML model
(reference pyzoo/zoo/automl/model/MTNet_keras.py: MTNetKeras), the JAX
package's ``automl/model/mtnet.py`` on the port's layers.

Architecture (MTNet paper — "A Memory-Augmented Neural Network for
Multivariate Time Series Forecasting"):

- the history window splits into ``long_num`` memory chunks of
  ``time_step`` steps plus one short-term chunk of ``time_step`` steps;
- three CNN→attention-GRU encoders embed them: ``memory`` and
  ``context`` over the long chunks, ``query`` over the short chunk;
- attention of query over memory weights the context vectors; the
  concatenated [weighted context, query] feeds a dense head
  (nonlinear component);
- an autoregressive linear head on the last ``ar_window`` short-term
  steps is added (the Lintel-style AR shortcut).

The port's layout of the same computation:
- the shared-weight encoder runs over all memory chunks at once: the
  chunk dim folds into the batch, ``(B, n, T, D) -> (B·n, T, D)``, where
  the JAX package ``vmap``s the encoder over it;
- the conv (kernel spans the full feature width) is one einsum over
  unfolded windows; the attention-GRU is a Python loop over time whose
  attention term is precomputed (X·W1+b) once — on the card the training
  step and each predict batch are captured whole into a CUDA graph
  (``core/graphs.py``), so the loop costs no host launches, as
  ``nn/layers/recurrent.py``'s loops do;
- the JAX package's two corrections of the reference are kept: its
  Permute ran the GRU over the channel dim (MTNet_keras.py:425), and its
  Softmax(axis=-1) normalised a singleton axis (:335-337), which made
  attention a no-op; here the GRU runs over time and the softmax
  normalises over the ``long_num`` memories (the paper's intent).

Leaves are named as the JAX block's (``mem`` / ``ctx`` / ``query``
encoder sub-trees with ``gru{i}`` sub-trees of ``wi``, ``wh``, ``b``;
``head_w``, ``head_b``, ``ar_w``, ``ar_b``), so weights carry across with
``convert.load_jax_params``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.automl.common.metrics import Evaluator
from analytics_zoo_tpu_torch.nn.module import Layer, StatelessLayer


def _trunc_normal(generator, shape, stddev=0.1):
    """N(0, stddev²) truncated to ±2·stddev (the JAX block's law)."""
    out = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(out, 0.0, stddev, -2.0 * stddev,
                                2.0 * stddev, generator=generator)
    return out


class _GRU(Layer):
    """Leaves of one attention-GRU layer: ``wi`` (F, 3H), ``wh`` (H, 3H),
    ``b`` (3H,), gates (z, r, n) with the reset gate applied to ``h``
    before its recurrent product, ReLU candidate."""

    def __init__(self, units: int, **kw):
        super().__init__(**kw)
        self.units = units

    def build(self, generator, d_in):
        h = self.units
        self.set_leaf("wi", _trunc_normal(generator, (d_in, 3 * h)))
        self.set_leaf("wh", _trunc_normal(generator, (h, 3 * h)))
        self.set_leaf("b", torch.zeros((3 * h,), dtype=torch.float32))

    def step(self, h, x):
        r_h = self.units
        wh = self.leaf("wh")
        gi = x @ self.leaf("wi") + self.leaf("b")
        gh = h @ wh[:, :2 * r_h]
        z = torch.sigmoid(gi[..., :r_h] + gh[..., :r_h])
        r = torch.sigmoid(gi[..., r_h:2 * r_h] + gh[..., r_h:])
        n = torch.relu(gi[..., 2 * r_h:] + (r * h) @ wh[:, 2 * r_h:])
        return (1.0 - z) * n + z * h


class _Encoder(Layer):
    """Conv over time + attention-GRU: series (B, T, D) -> (B, R_last)."""

    def __init__(self, time_step: int, cnn_height: int, cnn_hid: int,
                 rnn_hid_sizes: Sequence[int], **kw):
        super().__init__(**kw)
        self.time_step = time_step
        self.cnn_height = cnn_height
        self.cnn_hid = cnn_hid
        self.rnn_hid_sizes = list(rnn_hid_sizes)
        for i, r_h in enumerate(self.rnn_hid_sizes):
            self.add_subtree(f"gru{i}", _GRU(r_h, name=f"gru{i}"))

    def build(self, generator, d_feat):
        h, r_last = self.cnn_hid, self.rnn_hid_sizes[-1]
        self.set_leaf("conv_w", _trunc_normal(
            generator, (self.cnn_height, d_feat, h)))
        self.set_leaf("conv_b", torch.full((h,), 0.1, dtype=torch.float32))
        self.set_leaf("attn_w1", _trunc_normal(generator, (h, h)))
        self.set_leaf("attn_b2", torch.zeros((h,), dtype=torch.float32))
        self.set_leaf("attn_w2", _trunc_normal(generator, (r_last, h)))
        self.set_leaf("attn_v", _trunc_normal(generator, (h, 1)))
        self.set_leaf("attn_w3", _trunc_normal(generator, (2 * h, h)))
        self.set_leaf("attn_b3", torch.zeros((h,), dtype=torch.float32))
        d_in = h
        for i, r_h in enumerate(self.rnn_hid_sizes):
            self.subtree(f"gru{i}").build(generator, d_in)
            d_in = r_h

    def forward(self, series):
        ch = self.cnn_height
        t_c = self.time_step - ch + 1
        # unfold T into t_c windows of height ch; the full-width kernel
        # is one einsum: (B, t_c, ch, D) x (ch, D, H)
        windows = series.unfold(1, ch, 1).transpose(2, 3)   # (B,t_c,ch,D)
        conv = torch.einsum("btcd,cdh->bth", windows, self.leaf("conv_w"))
        x_seq = torch.relu(conv + self.leaf("conv_b"))     # (B, t_c, H)
        # attention term precomputed once for the whole loop
        xw1 = x_seq @ self.leaf("attn_w1") + self.leaf("attn_b2")
        w2, v = self.leaf("attn_w2"), self.leaf("attn_v")
        w3, b3 = self.leaf("attn_w3"), self.leaf("attn_b3")
        grus = [self.subtree(f"gru{i}")
                for i in range(len(self.rnn_hid_sizes))]
        b = series.shape[0]
        hs = [torch.zeros((b, r), dtype=torch.float32, device=series.device)
              for r in self.rnn_hid_sizes]
        for t in range(t_c):
            e = torch.tanh(xw1 + (hs[-1] @ w2)[:, None, :])
            attn = torch.softmax(e @ v, dim=1)              # (B, t_c, 1)
            x_weighted = torch.sum(attn * x_seq, dim=1)     # (B, H)
            inp = torch.cat([x_seq[:, t], x_weighted], -1) @ w3 + b3
            for i, gru in enumerate(grus):
                inp = hs[i] = gru.step(hs[i], inp)
        return hs[-1]


class MTNetBlock(StatelessLayer):
    """The MTNet network as one layer: inputs (long, short) →
    prediction (B, output_dim).

    ``long``: (B, long_num, time_step, D); ``short``: (B, time_step, D).
    """

    def __init__(self, output_dim: int, time_step: int, long_num: int,
                 ar_window: int = 1, cnn_height: int = 1,
                 cnn_hid_size: int = 32,
                 rnn_hid_sizes: Sequence[int] = (16, 32), **kw):
        super().__init__(**kw)
        if ar_window > time_step:
            raise ValueError(f"ar_window {ar_window} must not exceed "
                             f"time_step {time_step}")
        if cnn_height > time_step:
            raise ValueError(f"cnn_height {cnn_height} must not exceed "
                             f"time_step {time_step}")
        self.output_dim = output_dim
        self.time_step = time_step
        self.long_num = long_num
        self.ar_window = ar_window
        self.cnn_height = cnn_height
        self.cnn_hid = cnn_hid_size
        self.rnn_hid_sizes = list(rnn_hid_sizes)
        for key in ("mem", "ctx", "query"):
            self.add_subtree(key, _Encoder(
                time_step, cnn_height, cnn_hid_size, self.rnn_hid_sizes,
                name=key))

    def build(self, generator, long_shape, short_shape=None):
        d_feat = long_shape[-1]
        for key in ("mem", "ctx", "query"):
            self.subtree(key).build(generator, d_feat)
        nl_in = self.rnn_hid_sizes[-1] * (self.long_num + 1)
        self.set_leaf("head_w", _trunc_normal(generator,
                                              (nl_in, self.output_dim)))
        self.set_leaf("head_b", torch.full((self.output_dim,), 0.1,
                                           dtype=torch.float32))
        if self.ar_window > 0:
            self.set_leaf("ar_w", _trunc_normal(
                generator, (self.ar_window * d_feat, self.output_dim)))
            self.set_leaf("ar_b", torch.full((self.output_dim,), 0.1,
                                             dtype=torch.float32))

    def output_shape(self, long_shape, short_shape=None):
        return (long_shape[0], self.output_dim)

    def forward(self, long, short):
        b, n = long.shape[0], self.long_num
        chunks = long.reshape(b * n, self.time_step, -1)
        # the shared-weight encoders over every memory chunk at once
        enc_m = self.subtree("mem")(chunks).reshape(b, n, -1)   # (B, n, R)
        enc_c = self.subtree("ctx")(chunks).reshape(b, n, -1)   # (B, n, R)
        query = self.subtree("query")(short)                    # (B, R)

        # attention of query over memories, softmax over long_num
        logits = torch.einsum("bnr,br->bn", enc_m, query)
        prob = torch.softmax(logits, dim=-1)                    # (B, n)
        weighted = enc_c * prob[:, :, None]                     # (B, n, R)
        flat = torch.cat([weighted, query[:, None, :]],
                         dim=1).reshape(b, -1)
        pred = flat @ self.leaf("head_w") + self.leaf("head_b")
        if self.ar_window > 0:
            ar = short[:, -self.ar_window:].reshape(b, -1)
            pred = pred + ar @ self.leaf("ar_w") + self.leaf("ar_b")
        return pred


class MTNet:
    """AutoML trainable wrapping MTNetBlock under the port's Estimator
    (fit_eval contract — automl/model/time_sequence.py).

    The feature transformer's rolling window of length
    ``(long_num + 1) * time_step`` splits into long/short inputs here
    (reference MTNetKeras._reshape_input_x).
    """

    out_is_seq = False

    def __init__(self, check_optional_config: bool = False,
                 future_seq_len: int = 1):
        self.model = None
        self.config: Dict = {}
        self.future_seq_len = future_seq_len

    # -- data layout ------------------------------------------------------
    @staticmethod
    def _cfg(config):
        """Resolve config with the reference's recipe aliases
        (filter_size→cnn_height, ar_size→ar_window —
        time_sequence_predictor.py:99-110)."""
        return {
            "time_step": int(config.get("time_step", 1)),
            "long_num": int(config.get("long_num", 7)),
            "cnn_height": int(config.get("cnn_height",
                                         config.get("filter_size", 1))),
            "ar_window": int(config.get("ar_window",
                                        config.get("ar_size", 1))),
            "cnn_hid_size": int(config.get("cnn_hid_size", 32)),
            "rnn_hid_sizes": list(config.get("rnn_hid_sizes", [16, 32])),
        }

    def _split(self, x, config):
        c = self._cfg(config)
        t, n = c["time_step"], c["long_num"]
        need = (n + 1) * t
        if x.shape[1] != need:
            raise ValueError(
                f"MTNet needs past_seq_len == (long_num+1)*time_step = "
                f"{need}, got {x.shape[1]}; set past_seq_len accordingly "
                "in the recipe")
        b, _, d = x.shape
        long = x[:, :n * t].reshape(b, n, t, d)
        short = x[:, n * t:]
        return long.astype(np.float32), short.astype(np.float32)

    def _ensure(self, x, y, config):
        from analytics_zoo_tpu_torch.nn import Input, Model, reset_name_scope
        from analytics_zoo_tpu_torch.train.optimizers import Adam

        reset_name_scope()
        c = self._cfg(config)
        t, n = c["time_step"], c["long_num"]
        d = x.shape[-1]
        out_dim = y.shape[1] if y.ndim > 1 else 1
        self.config = dict(config)
        block = MTNetBlock(
            output_dim=out_dim, time_step=t, long_num=n,
            ar_window=c["ar_window"], cnn_height=c["cnn_height"],
            cnn_hid_size=c["cnn_hid_size"],
            rnn_hid_sizes=c["rnn_hid_sizes"])
        li = Input(shape=(n, t, d))
        si = Input(shape=(t, d))
        out = block(li, si)
        self.model = Model([li, si], out)
        self.model.compile(optimizer=Adam(lr=float(config.get("lr", 1e-3))),
                           loss="mae")

    # -- trainable contract ----------------------------------------------
    def fit_eval(self, x, y, validation_data=None, metric: str = "mse",
                 **config) -> float:
        if y.ndim == 1:
            y = y[:, None]
        self._ensure(x, y, config)
        long, short = self._split(x, config)
        if validation_data is not None:
            vx, vy = validation_data
        else:
            vx, vy = x, y
        if vy.ndim == 1:
            vy = vy[:, None]
        self.model.fit([long, short], y,
                       batch_size=int(config.get("batch_size", 32)),
                       nb_epoch=int(config.get("epochs", 1)), verbose=False)
        vl, vs = self._split(vx, config)
        pred = self.model.predict([vl, vs], batch_size=1024)
        return Evaluator.evaluate(metric, vy, pred)

    def predict(self, x) -> np.ndarray:
        long, short = self._split(x, self.config)
        return self.model.predict([long, short], batch_size=1024)

    def evaluate(self, x, y, metric: str = "mse") -> float:
        if y.ndim == 1:
            y = y[:, None]
        return Evaluator.evaluate(metric, y, self.predict(x))

    # -- persistence ------------------------------------------------------
    def state(self):
        return {"params": self.model.params(), "state": self.model.state()}

    def save(self, path: str) -> None:
        self.model.save_weights(path)

    def restore(self, path: str, x_shape, out_dim, config) -> None:
        c = self._cfg(config)
        t, n = c["time_step"], c["long_num"]
        # x_shape = (past_seq_len, n_features), batch-less (pipeline
        # contract, automl/pipeline/time_sequence.py)
        x = np.zeros((2, (n + 1) * t, x_shape[-1]), np.float32)
        y = np.zeros((2, out_dim), np.float32)
        self._ensure(x, y, config)
        self.model.load_weights(path)
        self.config = dict(config)
