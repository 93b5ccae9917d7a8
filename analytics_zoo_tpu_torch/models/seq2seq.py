"""Seq2seq: RNNEncoder, Bridge, RNNDecoder, the ``Seq2seqNet`` program
and the ``Seq2seq`` model with greedy (``infer``) and beam-search
(``infer_beam``) decoding.

The net's tree is the JAX package's: ``embed`` (one table for both
sides), ``enc`` and ``dec`` (one sub-tree per stacked cell,
``seq2seq_enc_l0``, ...), ``bridge`` (``w{i}`` / ``b{i}`` per leaf of the
encoder's final states, in the JAX package's ``tree_leaves`` order: ``[h0,
c0, h1, c1, ...]`` for LSTM cells, whose carry is ``(h, c)``) and ``gen``,
so ``convert.load_jax_params`` carries its weights across.

Training is teacher-forced through ``compile`` / ``fit`` on
``[encoder_ids, decoder_ids]``.  The decoders are fixed-length loops
with no host read inside: greedy decoding runs ``max_seq_len`` steps of
argmax, beam search ``max_seq_len`` steps of ``topk`` over (B, K·V), then
a backtrace.  Each decoder signature (the ids' shape and the static
arguments) is one serving program (``deploy/inference.py``'s bucket
program): its first call runs eagerly, later ones replay it as one CUDA
graph on the card, as the JAX package jits them with static arguments.
"""

from __future__ import annotations

import functools
import threading
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.models.common import register_model
from analytics_zoo_tpu_torch.models.recommendation import ServedModel
from analytics_zoo_tpu_torch.nn import initializers
from analytics_zoo_tpu_torch.nn.layers.core import Dense
from analytics_zoo_tpu_torch.nn.layers.embedding import Embedding
from analytics_zoo_tpu_torch.nn.layers.recurrent import GRU, LSTM, RNNBase
from analytics_zoo_tpu_torch.nn.module import Layer
from analytics_zoo_tpu_torch.nn.topology import KerasNet

RNN_TYPES = ("lstm", "gru")
BRIDGE_TYPES = ("pass", "dense")
# a beam's score before it exists, and a finished beam's score for any
# token but the stop sign
NEG = -1e30


def _make_cell(rnn_type: str, hidden: int, name: str) -> RNNBase:
    rnn_type = rnn_type.lower()
    if rnn_type == "lstm":
        return LSTM(hidden, return_sequences=True, name=name)
    if rnn_type == "gru":
        return GRU(hidden, return_sequences=True, name=name)
    raise ValueError(f"unknown rnn_type {rnn_type!r}; known: "
                     f"{', '.join(RNN_TYPES)}")


def _leaves(states) -> List[torch.Tensor]:
    """The per-layer states flattened in ``jax.tree_util.tree_leaves``
    order: a list of layers, each a tensor (GRU) or an ``(h, c)`` pair
    (LSTM)."""
    out = []
    for st in states:
        out.extend(st if isinstance(st, (tuple, list)) else [st])
    return out


def _unflatten(like, leaves) -> list:
    it = iter(leaves)
    return [tuple(next(it) for _ in st) if isinstance(st, (tuple, list))
            else next(it) for st in like]


class _StackedRNN(Layer):
    """Stacked cells, each a sub-tree under its own name
    (``{name}_l{i}``)."""

    def __init__(self, rnn_type: str = "lstm", num_layers: int = 1,
                 hidden_size: int = 128, **kw):
        super().__init__(**kw)
        for i in range(num_layers):
            cell = _make_cell(rnn_type, hidden_size, f"{self.name}_l{i}")
            self.add_subtree(cell.name, cell)

    @property
    def cells(self) -> List[RNNBase]:
        return list(self._tree.values())

    def build(self, generator, input_shape):
        shape = tuple(input_shape)
        for cell in self.cells:
            cell.build(generator, shape)
            shape = shape[:-1] + (cell.output_dim,)


class RNNEncoder(_StackedRNN):
    """Stacked RNN encoder: ``[sequence output, final state per
    layer]``."""

    def forward(self, x):
        states = []
        for cell in self.cells:
            x, st = cell.run(x, return_state=True)
            states.append(st)
        return [x, states]


class RNNDecoder(_StackedRNN):
    """Stacked RNN decoder started from given states, one per layer."""

    def run_with_states(self, x, init_states, return_state: bool = False):
        states = []
        for cell, st in zip(self.cells, init_states):
            x, new_st = cell.run(x, initial_carry=st, return_state=True)
            states.append(new_st)
        return (x, states) if return_state else x

    def forward(self, x):
        return self.run_with_states(x, [None] * len(self.cells))


class Bridge(Layer):
    """The encoder's final states into the decoder's initial ones:
    "pass" hands them on; "dense" maps each state leaf ``i`` through
    ``tanh(leaf @ w{i} + b{i})``."""

    def __init__(self, bridge_type: str = "pass",
                 decoder_hidden_size: Optional[int] = None, **kw):
        super().__init__(**kw)
        if bridge_type not in BRIDGE_TYPES:
            raise ValueError(f"unknown bridge_type {bridge_type!r}; known: "
                             f"{', '.join(BRIDGE_TYPES)}")
        self.bridge_type = bridge_type
        self.decoder_hidden_size = decoder_hidden_size
        self.initializer = initializers.get("glorot_uniform")

    def build_states(self, generator, widths: List[int]) -> None:
        """Allocate ``w{i}`` (width, decoder width) and ``b{i}`` for each
        state leaf's width, in leaf order."""
        if self.bridge_type == "pass":
            return
        for i, d_in in enumerate(widths):
            d_out = self.decoder_hidden_size or d_in
            self.set_leaf(f"w{i}", self.initializer(generator, (d_in, d_out)))
            self.set_leaf(f"b{i}", torch.zeros((d_out,), dtype=torch.float32))

    def apply_states(self, states):
        if self.bridge_type == "pass":
            return states
        new = []
        for i, leaf in enumerate(_leaves(states)):
            w = self.leaf(f"w{i}")
            new.append(torch.tanh(torch.matmul(leaf, w.to(leaf.dtype))
                                  + self.leaf(f"b{i}").to(leaf.dtype)))
        return _unflatten(states, new)


class Seq2seqNet(KerasNet):
    """ids -> embed -> encode -> bridge -> teacher-forced decode -> vocab
    logits.  Its layers nest under the tree keys ``embed``, ``enc``,
    ``dec``, ``bridge`` and ``gen`` (no top-level layer names)."""

    def __init__(self, vocab_size: int, embed_dim: int, rnn_type: str,
                 num_layers: int, hidden_size: int, bridge_type: str,
                 **kw):
        super().__init__(**kw)
        self.vocab_size = vocab_size
        self.rnn_type = rnn_type.lower()
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.add_subtree("embed", Embedding(vocab_size, embed_dim,
                                            name=f"{self.name}_embed"))
        self.add_subtree("enc", RNNEncoder(rnn_type, num_layers, hidden_size,
                                           name=f"{self.name}_enc"))
        self.add_subtree("dec", RNNDecoder(rnn_type, num_layers, hidden_size,
                                           name=f"{self.name}_dec"))
        self.add_subtree("bridge", Bridge(bridge_type, hidden_size,
                                          name=f"{self.name}_bridge"))
        self.add_subtree("gen", Dense(vocab_size, name=f"{self.name}_gen"))

    @property
    def layers(self):
        return []

    embedding = property(lambda self: self.subtree("embed"))
    encoder = property(lambda self: self.subtree("enc"))
    decoder = property(lambda self: self.subtree("dec"))
    bridge = property(lambda self: self.subtree("bridge"))
    generator = property(lambda self: self.subtree("gen"))

    def build(self, generator, *input_shapes):
        """The weights depend on no sequence length: ``input_shapes``
        (encoder ids, decoder ids) give only the output's."""
        e, h = self.embedding.output_dim, self.hidden_size
        self.embedding.build(generator, (2, 1))
        self.encoder.build(generator, (2, 1, e))
        self.decoder.build(generator, (2, 1, e))
        per_layer = 2 if self.rnn_type == "lstm" else 1
        self.bridge.build_states(generator,
                                 [h] * (per_layer * self.num_layers))
        self.generator.build(generator, (2, h))
        self._output_shape = self.output_shape(
            *(input_shapes if len(input_shapes) == 2 else ((2, 1),) * 2))

    def output_shape(self, enc_shape, dec_shape):
        return tuple(dec_shape) + (self.vocab_size,)

    def _initial_states(self, enc_ids):
        _, states = self.encoder(self.embedding(enc_ids))
        return self.bridge.apply_states(states)

    def forward(self, enc_ids, dec_ids):
        init = self._initial_states(enc_ids)
        out = self.decoder.run_with_states(self.embedding(dec_ids), init)
        return self.generator(out)

    def _step(self, tok, states):
        """One decode step from (N, 1) tokens: (f32 logits (N, V), new
        states)."""
        out, states = self.decoder.run_with_states(
            self.embedding(tok), states, return_state=True)
        return self.generator(out[:, -1]).float(), states

    # -- greedy decoding ---------------------------------------------------
    def greedy(self, enc_ids, start_sign: int, max_seq_len: int,
               stop_sign: Optional[int] = None) -> torch.Tensor:
        """``max_seq_len`` steps of argmax from ``start_sign``: (B,
        max_seq_len) int32.  With ``stop_sign``, every position after a
        row's first stop token holds the stop token."""
        states = self._initial_states(enc_ids)
        b = enc_ids.shape[0]
        tok = torch.full((b, 1), start_sign, dtype=torch.int32,
                         device=enc_ids.device)
        done = torch.zeros((b,), dtype=torch.bool, device=enc_ids.device)
        toks = []
        for _ in range(max_seq_len):
            logits, states = self._step(tok, states)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if stop_sign is not None:
                nxt = nxt.masked_fill(done, stop_sign)
                done = done | (nxt == stop_sign)
            toks.append(nxt)
            tok = nxt[:, None]
        return torch.stack(toks, dim=1)

    # -- beam search -------------------------------------------------------
    def beam_search(self, enc_ids, start_sign: int, max_seq_len: int,
                    beam_size: int = 4, stop_sign: Optional[int] = None,
                    length_penalty: float = 0.0):
        """Fixed-shape beam search: ``max_seq_len`` steps of ``topk`` over
        every beam's extensions (B, K·V), then a backtrace along the
        parent pointers from the best final beam.  Returns (tokens (B,
        max_seq_len) int32, scores (B,) f32).  A finished beam extends
        only by ``stop_sign``, at no cost; ``length_penalty`` > 0 (with
        ``stop_sign``) divides the final scores by length ** penalty,
        the length counting the tokens before the stop token."""
        v, k = self.vocab_size, beam_size
        b = enc_ids.shape[0]
        dev = enc_ids.device
        states = [tuple(t.repeat_interleave(k, dim=0) for t in st)
                  if isinstance(st, tuple) else st.repeat_interleave(k, dim=0)
                  for st in self._initial_states(enc_ids)]
        tok = torch.full((b * k, 1), start_sign, dtype=torch.int32,
                         device=dev)
        # beam 0 starts live, the others at NEG, so step 1 fans out of one
        # (filled on the device: no host value is copied in, so a CUDA
        # graph can capture it)
        scores = torch.where(torch.arange(k, device=dev) == 0, 0.0,
                             NEG).expand(b, k)
        done = torch.zeros((b, k), dtype=torch.bool, device=dev)
        lens = torch.zeros((b, k), dtype=torch.float32, device=dev)
        if stop_sign is not None:
            pad = torch.where(torch.arange(v, device=dev) == stop_sign, 0.0,
                              NEG)

        def gather_beams(t, beam_idx):
            tk = t.reshape((b, k) + t.shape[1:])
            idx = beam_idx.reshape((b, k) + (1,) * (t.ndim - 1)).expand(
                (b, k) + t.shape[1:])
            return torch.gather(tk, 1, idx).reshape(t.shape)

        hist_tok, hist_parent = [], []
        for _ in range(max_seq_len):
            logits, new_states = self._step(tok, states)
            logp = F.log_softmax(logits, dim=-1).reshape(b, k, v)
            if stop_sign is not None:
                logp = torch.where(done[:, :, None], pad, logp)
            flat = (scores[:, :, None] + logp).reshape(b, k * v)
            scores, top = torch.topk(flat, k, dim=-1)
            beam_idx = torch.div(top, v, rounding_mode="floor")
            token = (top % v).to(torch.int32)
            states = [tuple(gather_beams(t, beam_idx) for t in st)
                      if isinstance(st, tuple) else gather_beams(st, beam_idx)
                      for st in new_states]
            # the histories follow the beams they came from: gathered
            # before they are extended
            done = torch.gather(done, 1, beam_idx)
            lens = torch.gather(lens, 1, beam_idx)
            if stop_sign is not None:
                stop = token == stop_sign
                lens = lens + (~(done | stop)).to(torch.float32)
                done = done | stop
            else:
                lens = lens + 1.0
            tok = token.reshape(b * k, 1)
            hist_tok.append(token)
            hist_parent.append(beam_idx)

        if length_penalty > 0 and stop_sign is not None:
            scores = scores / torch.clamp(lens, min=1.0) ** length_penalty
        best = torch.argmax(scores, dim=-1)
        beam = best[:, None]
        seq = []
        for t in range(max_seq_len - 1, -1, -1):
            seq.append(torch.gather(hist_tok[t], 1, beam)[:, 0])
            beam = torch.gather(hist_parent[t], 1, beam)
        seq = torch.stack(seq[::-1], dim=1)
        return seq, torch.gather(scores, 1, best[:, None])[:, 0]


@register_model
class Seq2seq(ServedModel):
    """Sequence-to-sequence model: ``fit`` takes ``[encoder_ids,
    decoder_ids]`` (teacher forcing) against the decoder's targets;
    ``infer`` decodes greedily, ``infer_beam`` by beam search.  Both
    decode with the weights of the serving model (``inference_model()``,
    float32 unless built otherwise), rebuilt once the net's weights
    change, one program per signature."""

    def __init__(self, vocab_size: int, embed_dim: int = 64,
                 rnn_type: str = "lstm", num_layers: int = 1,
                 hidden_size: int = 128, bridge_type: str = "pass",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(device=device, generator=generator)
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.rnn_type = rnn_type
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.bridge_type = bridge_type
        self._decode_lock = threading.Lock()
        self._decoders: dict = {}
        self._decoders_of = None
        self._finish(Seq2seqNet(vocab_size, embed_dim, rnn_type, num_layers,
                                hidden_size, bridge_type, name="seq2seq"))

    def config(self):
        return {"vocab_size": self.vocab_size, "embed_dim": self.embed_dim,
                "rnn_type": self.rnn_type, "num_layers": self.num_layers,
                "hidden_size": self.hidden_size,
                "bridge_type": self.bridge_type}

    def _decode(self, kind: str, enc_ids, **static):
        """Run decoder ``kind`` ("greedy" or "beam_search") of the serving
        net over ``enc_ids`` through its program for this signature: the
        first call eager, the next one captures, later ones replay."""
        from analytics_zoo_tpu_torch.deploy.inference import _BucketProgram

        enc = np.ascontiguousarray(enc_ids, dtype=np.int32)
        im = self._scorer()
        with self._decode_lock:
            if self._decoders_of is not im:
                self._decoders, self._decoders_of = {}, im
            key = (kind, enc.shape, tuple(sorted(static.items())))
            prog = self._decoders.get(key)
            if prog is None:
                prog = self._decoders[key] = _BucketProgram(
                    functools.partial(getattr(im._net, kind), **static),
                    {"in": [(enc.shape, "int32")]}, im.device,
                    name=f"seq2seq {kind} {static}")
            elif not prog.graph.captured:
                prog.capture()
            return prog.run([enc])

    def infer(self, enc_ids: np.ndarray, start_sign: int,
              max_seq_len: int = 30,
              stop_sign: Optional[int] = None) -> np.ndarray:
        """Greedy decoding: (B, max_seq_len) int32 tokens."""
        return self._decode("greedy", enc_ids, start_sign=int(start_sign),
                            max_seq_len=int(max_seq_len),
                            stop_sign=stop_sign)

    def infer_beam(self, enc_ids: np.ndarray, start_sign: int,
                   max_seq_len: int = 30, beam_size: int = 4,
                   stop_sign: Optional[int] = None,
                   length_penalty: float = 0.0):
        """Beam-search decoding: (tokens (B, max_seq_len) int32, scores
        (B,) f32) of each row's best beam."""
        seq, scores = self._decode(
            "beam_search", enc_ids, start_sign=int(start_sign),
            max_seq_len=int(max_seq_len), beam_size=int(beam_size),
            stop_sign=stop_sign, length_penalty=float(length_penalty))
        return seq, scores
