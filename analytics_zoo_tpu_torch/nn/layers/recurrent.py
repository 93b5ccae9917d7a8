"""Recurrent layers: SimpleRNN, LSTM, GRU, Highway, Bidirectional,
TimeDistributed, ConvLSTM2D/3D.

The JAX package's cells, gate for gate (Keras v1: LSTM gates i, f, c, o
with a unit forget bias; GRU gates z, r, h with the reset gate applied to
``h_prev`` before the recurrent product), so weights carry across by
name: leaves ``kernel`` (F, G·H), ``recurrent`` (H, G·H) and ``bias``
(G·H,).  These are not ``torch.nn.LSTM`` / ``GRU``, which compute
cuDNN's variant of the cells.

The input projection of all T steps is one matmul ``(B·T, F) @ kernel``
hoisted out of the time loop; the loop over T holds only the small
recurrent product and the gates.  On the card the training step and each
serving bucket are captured whole into a CUDA graph (``core/graphs.py``),
so the T steps cost no host launches.  A quantized leaf (int8 / int4
serving) is dequantized once per forward, not once per step.

Dtypes follow the JAX package: the carry starts as f32 zeros, and each
product runs at the promoted type of its operands, so under bf16 compute
the recurrence and the outputs are f32 while the hoisted projection
reads the bf16 input at bf16.
"""

from __future__ import annotations

import copy
import math

import torch

from analytics_zoo_tpu_torch.nn import activations, initializers
from analytics_zoo_tpu_torch.nn.layers.convolutional import conv
from analytics_zoo_tpu_torch.nn.module import Layer


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at the promoted dtype of the two (``jnp.matmul``'s
    rule)."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.matmul(a, b)


def _carry_dtype(x: torch.Tensor) -> torch.dtype:
    """The JAX package's f32 carry (f64 for an f64 input)."""
    return torch.promote_types(x.dtype, torch.float32)


class RNNBase(Layer):
    """Shared machinery: leaves, the hoisted input projection, the time
    loop, ``go_backwards`` and the initial-carry hook (``run``)."""

    num_gates = 1

    def __init__(self, output_dim: int, activation="tanh",
                 inner_activation="hard_sigmoid",
                 return_sequences: bool = False, go_backwards: bool = False,
                 init="glorot_uniform", inner_init="orthogonal", **kw):
        super().__init__(**kw)
        self.output_dim = output_dim
        self.activation = activations.get(activation)
        self.inner_activation = activations.get(inner_activation)
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self.initializer = initializers.get(init)
        self.inner_initializer = initializers.get(inner_init)

    def build(self, generator, input_shape):
        f, h, g = input_shape[-1], self.output_dim, self.num_gates
        self.set_leaf("kernel", self.initializer(generator, (f, g * h)))
        self.set_leaf("recurrent",
                      self.inner_initializer(generator, (h, g * h)))
        self.set_leaf("bias", self._init_bias(h))

    def _init_bias(self, h: int) -> torch.Tensor:
        return torch.zeros((self.num_gates * h,), dtype=torch.float32)

    def output_shape(self, input_shape):
        b, t = input_shape[0], input_shape[1]
        return ((b, t, self.output_dim) if self.return_sequences
                else (b, self.output_dim))

    def _init_carry(self, batch: int, like: torch.Tensor):
        return torch.zeros((batch, self.output_dim), dtype=_carry_dtype(like),
                           device=like.device)

    def _step(self, rec, carry, zx):
        """One timestep from the precomputed input projection ``zx``;
        returns (new carry, output)."""
        raise NotImplementedError

    def _carry_output(self, carry):
        return carry

    def run(self, x, initial_carry=None, return_state: bool = False):
        """The layer over (B, T, F) ``x`` from ``initial_carry`` (zeros
        by default; the seq2seq decoder feeds its bridge states here);
        with ``return_state`` also the last carry."""
        b, t, f = x.shape
        if self.go_backwards:
            x = torch.flip(x, dims=(1,))
        zx = (_mm(x.reshape(b * t, f), self.leaf("kernel"))
              + self.leaf("bias")).reshape(b, t, -1)
        carry = (initial_carry if initial_carry is not None
                 else self._init_carry(b, x))
        rec = self.leaf("recurrent")
        rec = rec.to(torch.promote_types(rec.dtype, _carry_dtype(x)))
        ys = []
        for s in range(t):
            carry, y = self._step(rec, carry, zx[:, s])
            ys.append(y)
        out = (torch.stack(ys, dim=1) if self.return_sequences
               else self._carry_output(carry))
        return (out, carry) if return_state else out

    def forward(self, x):
        return self.run(x)


class SimpleRNN(RNNBase):
    """h' = act(x W + h U + b)."""

    num_gates = 1

    def __init__(self, output_dim, activation="tanh", **kw):
        kw.pop("inner_activation", None)
        super().__init__(output_dim, activation=activation, **kw)

    def _step(self, rec, h, z):
        h_new = self.activation(z + _mm(h, rec))
        return h_new, h_new


class LSTM(RNNBase):
    """Keras-v1 LSTM, gate order (i, f, c, o); unit forget bias; carry
    (h, c)."""

    num_gates = 4

    def _init_bias(self, h):
        b = torch.zeros((4 * h,), dtype=torch.float32)
        b[h:2 * h] = 1.0
        return b

    def _init_carry(self, batch, like):
        z = super()._init_carry(batch, like)
        return (z, z)

    def _step(self, rec, carry, z):
        h_prev, c_prev = carry
        h = self.output_dim
        z = z + _mm(h_prev, rec)
        i = self.inner_activation(z[:, :h])
        f = self.inner_activation(z[:, h:2 * h])
        g = self.activation(z[:, 2 * h:3 * h])
        o = self.inner_activation(z[:, 3 * h:])
        c = f * c_prev + i * g
        h_new = o * self.activation(c)
        return (h_new, c), h_new

    def _carry_output(self, carry):
        return carry[0]


class GRU(RNNBase):
    """Keras-v1 GRU, gate order (z, r, h): the reset gate scales
    ``h_prev`` before its recurrent product."""

    num_gates = 3

    def _step(self, rec, h_prev, zx):
        h = self.output_dim
        zr = zx[:, :2 * h] + _mm(h_prev, rec[:, :2 * h])
        zg = self.inner_activation(zr[:, :h])
        rg = self.inner_activation(zr[:, h:])
        hh = self.activation(zx[:, 2 * h:] + _mm(rg * h_prev, rec[:, 2 * h:]))
        h_new = zg * h_prev + (1.0 - zg) * hh
        return h_new, h_new


class Highway(Layer):
    """y = t · act(x W_h + b) + (1 - t) · x, t = sigmoid(x W_t + b_t);
    ``t_bias`` starts at -2 (close to the identity)."""

    def __init__(self, activation="tanh", init="glorot_uniform", **kw):
        super().__init__(**kw)
        self.activation = activations.get(activation)
        self.initializer = initializers.get(init)

    def build(self, generator, input_shape):
        d = input_shape[-1]
        self.set_leaf("kernel", self.initializer(generator, (d, d)))
        self.set_leaf("bias", torch.zeros((d,), dtype=torch.float32))
        self.set_leaf("t_kernel", self.initializer(generator, (d, d)))
        self.set_leaf("t_bias", torch.full((d,), -2.0, dtype=torch.float32))

    def forward(self, x):
        t = torch.sigmoid(_mm(x, self.leaf("t_kernel")) + self.leaf("t_bias"))
        h = self.activation(_mm(x, self.leaf("kernel")) + self.leaf("bias"))
        return t * h + (1.0 - t) * x


MERGE_MODES = ("concat", "sum", "mul", "ave", "average")


class Bidirectional(Layer):
    """A recurrent layer run forwards (sub-tree ``fwd``) and backwards
    (sub-tree ``bwd``, a copy with ``go_backwards`` flipped), merged; the
    backward sequence is re-aligned in time before the merge."""

    def __init__(self, layer: RNNBase, merge_mode: str = "concat", **kw):
        super().__init__(**kw)
        if merge_mode not in MERGE_MODES:
            raise ValueError(f"unknown merge_mode {merge_mode!r}; known: "
                             f"{MERGE_MODES}")
        bwd = copy.deepcopy(layer)
        bwd.name = layer.name + "_reverse"
        bwd.go_backwards = not layer.go_backwards
        self.add_subtree("fwd", layer)
        self.add_subtree("bwd", bwd)
        self.merge_mode = merge_mode

    def build(self, generator, input_shape):
        self.subtree("fwd").build(generator, input_shape)
        self.subtree("bwd").build(generator, input_shape)

    def output_shape(self, input_shape):
        out = self.subtree("fwd").output_shape(input_shape)
        if self.merge_mode == "concat":
            return tuple(out[:-1]) + (2 * out[-1],)
        return out

    def forward(self, x):
        fwd, bwd = self.subtree("fwd"), self.subtree("bwd")
        yf, yb = fwd(x), bwd(x)
        if fwd.return_sequences:
            yb = torch.flip(yb, dims=(1,))
        m = self.merge_mode
        if m == "concat":
            return torch.cat([yf, yb], dim=-1)
        if m == "sum":
            return yf + yb
        if m == "mul":
            return yf * yb
        return (yf + yb) / 2.0


class TimeDistributed(Layer):
    """An inner layer applied to every timestep, by folding time into the
    batch dim: one batched op instead of T.  Its tree is the inner
    layer's, under this layer's name."""

    def __init__(self, layer: Layer, **kw):
        super().__init__(**kw)
        self.inner = layer

    @staticmethod
    def _folded(input_shape):
        return (input_shape[0] * input_shape[1],) + tuple(input_shape[2:])

    def build(self, generator, input_shape):
        self.inner.build(generator, self._folded(input_shape))

    def output_shape(self, input_shape):
        out = self.inner.output_shape(self._folded(input_shape))
        return tuple(input_shape[:2]) + tuple(out[1:])

    def params(self):
        return self.inner.params()

    def state(self):
        return self.inner.state()

    def set_leaf(self, name, value) -> None:
        self.inner.set_leaf(name, value)

    def set_state(self, name, value) -> None:
        self.inner.set_state(name, value)

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        y = self.inner(x.reshape((b * t,) + tuple(x.shape[2:])))
        return y.reshape((b, t) + tuple(y.shape[1:]))


class ConvLSTMND(Layer):
    """Convolutional LSTM over (B, T, spatial..., C), channels last.  The
    input convolution of all T steps is one batched convolution over
    (B·T, ...), hoisted out of the loop; the recurrent convolution on the
    carry runs in it.  Gates (i, f, c, o), unit forget bias, TensorFlow
    SAME padding (``nn/layers/convolutional.py``), so the carry keeps its
    shape; leaves ``kernel`` (*k, C, 4F), ``recurrent`` (*k, F, 4F) and
    ``bias`` (4F,)."""

    spatial = 2

    def __init__(self, nb_filter: int, kernel_size, activation="tanh",
                 inner_activation="hard_sigmoid", return_sequences=False,
                 go_backwards=False, border_mode: str = "same",
                 subsample=1, init="glorot_uniform",
                 inner_init="orthogonal", **kw):
        super().__init__(**kw)
        if border_mode != "same":
            raise ValueError("ConvLSTM requires border_mode='same' (the "
                             "carry must keep a step-invariant shape)")
        self.nb_filter = nb_filter
        self.kernel_size = ((kernel_size,) * self.spatial
                            if isinstance(kernel_size, int)
                            else tuple(kernel_size))
        self.strides = ((subsample,) * self.spatial
                        if isinstance(subsample, int) else tuple(subsample))
        self.activation = activations.get(activation)
        self.inner_activation = activations.get(inner_activation)
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self.initializer = initializers.get(init)
        self.inner_initializer = initializers.get(inner_init)

    def build(self, generator, input_shape):
        cin, f = input_shape[-1], self.nb_filter
        self.set_leaf("kernel", self.initializer(
            generator, self.kernel_size + (cin, 4 * f)))
        self.set_leaf("recurrent", self.inner_initializer(
            generator, self.kernel_size + (f, 4 * f)))
        bias = torch.zeros((4 * f,), dtype=torch.float32)
        bias[f:2 * f] = 1.0
        self.set_leaf("bias", bias)

    def output_shape(self, input_shape):
        b, t = input_shape[0], input_shape[1]
        sizes = tuple(math.ceil(n / s) for n, s in
                      zip(input_shape[2:2 + self.spatial], self.strides))
        tail = sizes + (self.nb_filter,)
        return (b, t) + tail if self.return_sequences else (b,) + tail

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        f, s = self.nb_filter, self.spatial
        if self.go_backwards:
            x = torch.flip(x, dims=(1,))
        ones = (1,) * s
        # (B·T, C, *S) channels first, one convolution for every step
        xf = x.reshape((b * t,) + tuple(x.shape[2:])).movedim(-1, 1)
        zx = conv(xf, self.leaf("kernel"), self.strides, ones, "same")
        zx = zx + self.leaf("bias").to(zx.dtype).reshape((1, 4 * f) + ones)
        zx = zx.reshape((b, t) + tuple(zx.shape[1:]))
        h = torch.zeros((b, f) + tuple(zx.shape[3:]), dtype=_carry_dtype(x),
                        device=x.device)
        c = h
        rec = self.leaf("recurrent")
        ys = []
        for step in range(t):
            z = zx[:, step] + conv(h, rec, ones, ones, "same")
            i = self.inner_activation(z[:, :f])
            fg = self.inner_activation(z[:, f:2 * f])
            g = self.activation(z[:, 2 * f:3 * f])
            o = self.inner_activation(z[:, 3 * f:])
            c = fg * c + i * g
            h = o * self.activation(c)
            ys.append(h)
        if self.return_sequences:
            return torch.stack(ys, dim=1).movedim(2, -1)
        return h.movedim(1, -1)


class ConvLSTM2D(ConvLSTMND):
    """Input (B, T, H, W, C)."""

    spatial = 2


class ConvLSTM3D(ConvLSTMND):
    """Input (B, T, D, H, W, C)."""

    spatial = 3

