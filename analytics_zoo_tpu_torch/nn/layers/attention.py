"""Attention layers: MultiHeadAttention, TransformerBlock, TransformerLayer,
BERT.

Each layer owns its sub-layers under the JAX package's tree keys
(``Dense`` for ``q``/``k``/``v``/``o``/``ffn1``/``ffn2``/``pooler``,
``LayerNorm`` for ``ln1``/``ln2``/``embed_ln``), so ``params()`` nests as
the JAX tree does and weights load by key path.  Attention goes through
``ops.attention.dot_product_attention``: a call with no mask and no
dropout takes the flash-attention kernels on the card — the forward
kernel at inference, and in training the forward that also writes the
logsumexp, with the dQ and dK/dV kernels as its backward.

``stacked=True`` keeps the JAX package's stacked layout: one ``blocks``
sub-tree whose leaves carry a leading ``n_block`` dim (``_BlockStack``);
the forward is a Python loop over the blocks.

Dropout (embedding, hidden, output, attention probabilities) draws from
the explicit generator that the Estimator installs on every ``Dropout``
module for the length of ``fit``; it is the identity at inference.  The
masks follow the JAX layers' law, not ``jax.random``'s bits.

Not in this slice, and raising ``NotImplementedError`` (ROADMAP A9):
ring attention over ``seq_shards`` > 1 devices, and the sequence-parallel
and pipeline regimes (``compile(sharding="sp"|"pp")``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from analytics_zoo_tpu_torch.nn import activations, initializers
from analytics_zoo_tpu_torch.nn.layers.core import Dense, Dropout
from analytics_zoo_tpu_torch.nn.layers.normalization import LayerNorm
from analytics_zoo_tpu_torch.nn.module import Layer, is_qleaf
from analytics_zoo_tpu_torch.ops.attention import dot_product_attention
from analytics_zoo_tpu_torch.ops.dequant_matmul import unpack_int4


def _dense(owner, key, d_out, init):
    return owner.add_subtree(key, Dense(d_out, init=init,
                                        name=f"{owner.name}_{key}"))


def _layernorm(owner, key):
    return owner.add_subtree(key, LayerNorm(name=f"{owner.name}_{key}"))


class MultiHeadAttention(Layer):
    """Multi-head (self or cross) attention with separate q/k/v/o
    projections (tree keys ``q``, ``k``, ``v``, ``o``).

    Inputs: ``(x)`` self-attention; ``(q, kv)`` cross-attention with a 3-D
    ``kv``; ``(x, mask)`` self-attention with a 2-D (B, Lk) key-padding or
    4-D mask; ``(q, kv, mask)``, where a mask may also be (B, Lq, Lk).
    Masks are 1 = attend.
    """

    def __init__(self, nhead: int, hidden_size: Optional[int] = None,
                 attn_drop: float = 0.0, output_drop: float = 0.0,
                 causal: bool = False, init="glorot_uniform",
                 seq_shards: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.nhead = nhead
        self.hidden_size = hidden_size
        self.attn_drop = attn_drop
        self.causal = causal
        # None defers to the ZooConfig.seq_shards knob at forward time
        self.seq_shards = seq_shards
        # the width of a hidden_size=None layer is the input's, set at
        # build
        for key in ("q", "k", "v", "o"):
            _dense(self, key, hidden_size, init)
        # holds the probability-dropout generator (the Estimator installs
        # it); the drop itself happens inside the attention op
        self.prob_dropout = Dropout(attn_drop, name=f"{self.name}_attn_drop")
        self.out_dropout = Dropout(output_drop,
                                   name=f"{self.name}_output_drop")

    def build(self, generator, q_shape, *rest):
        d = self.hidden_size or q_shape[-1]
        if d % self.nhead:
            raise ValueError(f"hidden {d} not divisible by nhead {self.nhead}")
        kv_d = rest[0][-1] if rest and len(rest[0]) == 3 else q_shape[-1]
        for key, d_in in (("q", q_shape[-1]), ("k", kv_d), ("v", kv_d),
                          ("o", d)):
            dense = self.subtree(key)
            dense.output_dim = d
            dense.build(generator, (d_in,))

    def output_shape(self, q_shape, *rest):
        return tuple(q_shape[:-1]) + (self.hidden_size or q_shape[-1],)

    def _split_heads(self, x):
        b, l, d = x.shape
        return x.reshape(b, l, self.nhead, d // self.nhead).transpose(1, 2)

    def _prob_drop(self):
        """(rate, generator) of the probability dropout: (0, None) at
        inference."""
        if not self.training or self.attn_drop <= 0.0:
            return 0.0, None
        gen = self.prob_dropout.generator
        if gen is None:
            raise ValueError(f"MultiHeadAttention {self.name} needs a "
                             "generator when training with attn_drop (the "
                             "Estimator installs one; call .eval() to run "
                             "without dropout)")
        return self.attn_drop, gen

    def forward(self, *inputs):
        mask = None
        if len(inputs) == 1:
            q_in = kv_in = inputs[0]
        elif len(inputs) == 2:
            if inputs[1].ndim == 3:
                q_in, kv_in = inputs
            else:
                q_in = kv_in = inputs[0]
                mask = inputs[1]
        else:
            q_in, kv_in, mask = inputs
        q = self._split_heads(self.subtree("q")(q_in))
        k = self._split_heads(self.subtree("k")(kv_in))
        v = self._split_heads(self.subtree("v")(kv_in))
        if mask is not None:
            if mask.ndim == 2:      # (B, Lk) key padding mask
                mask = mask[:, None, None, :]
            elif mask.ndim == 3:    # (B, Lq, Lk) full mask
                mask = mask[:, None, :, :]
        rate, gen = self._prob_drop()
        if mask is None and kv_in is q_in and rate == 0.0:
            from analytics_zoo_tpu_torch.ops.dispatch import config_knob

            ways = (self.seq_shards if self.seq_shards is not None
                    else config_knob("seq_shards", 0) or 0)
            if ways > 1:
                raise NotImplementedError(
                    f"seq_shards={ways}: ring attention over a sequence "
                    f"mesh needs the multi-GPU slice (ROADMAP A9); set "
                    f"seq_shards to 0 to attend on one device")
        out = dot_product_attention(q, k, v, mask=mask, causal=self.causal,
                                    dropout_rate=rate, dropout_generator=gen)
        b, h, l, hd = out.shape
        out = out.transpose(1, 2).reshape(b, l, h * hd)
        return self.out_dropout(self.subtree("o")(out))


class TransformerBlock(Layer):
    """One attention + FFN block with residuals (tree keys ``attn``,
    ``ln1``, ``ln2``, ``ffn1``, ``ffn2``).

    ``after_norm=False`` is post-LN (the original Transformer, BERT, the
    reference's TransformerLayer); ``True`` is pre-LN.
    """

    def __init__(self, nhead: int, hidden_size: int,
                 intermediate_size: Optional[int] = None,
                 hidden_drop: float = 0.1, attn_drop: float = 0.1,
                 causal: bool = False, activation="gelu",
                 after_norm: bool = False, init="glorot_uniform",
                 seq_shards: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.add_subtree("attn", MultiHeadAttention(
            nhead, hidden_size, attn_drop=attn_drop, causal=causal,
            init=init, seq_shards=seq_shards, name=f"{self.name}_attn"))
        self.hidden_size = hidden_size
        self.intermediate = intermediate_size or 4 * hidden_size
        self.act = activations.get(activation)
        self.pre_ln = after_norm
        _layernorm(self, "ln1")
        _layernorm(self, "ln2")
        _dense(self, "ffn1", self.intermediate, init)
        _dense(self, "ffn2", hidden_size, init)
        self.drop1 = Dropout(hidden_drop, name=f"{self.name}_drop1")
        self.drop2 = Dropout(hidden_drop, name=f"{self.name}_drop2")

    def build(self, generator, x_shape, *rest):
        d, t = self.hidden_size, self._tree
        t["attn"].build(generator, tuple(x_shape[:-1]) + (d,))
        t["ln1"].build(generator, (d,))
        t["ln2"].build(generator, (d,))
        t["ffn1"].build(generator, (d,))
        t["ffn2"].build(generator, (self.intermediate,))

    def output_shape(self, x_shape, *rest):
        return tuple(x_shape[:-1]) + (self.hidden_size,)

    def forward(self, x, mask=None):
        t = self._tree
        attn_in = t["ln1"](x) if self.pre_ln else x
        a = (t["attn"](attn_in) if mask is None
             else t["attn"](attn_in, mask))
        x = x + self.drop1(a)
        if not self.pre_ln:
            x = t["ln1"](x)
        ffn_in = t["ln2"](x) if self.pre_ln else x
        h = t["ffn2"](self.act(t["ffn1"](ffn_in)))
        x = x + self.drop2(h)
        if not self.pre_ln:
            x = t["ln2"](x)
        return x


def _stack(trees):
    """One tree from per-block trees: leaves stacked on a new leading
    dim.  A quantized leaf stacks its ``q`` and keeps the scale, which the
    blocks share (their leaves were split from one stacked leaf)."""
    first = trees[0]
    if isinstance(first, dict) and not is_qleaf(first):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if is_qleaf(first):
        if "q4" in first:
            raise NotImplementedError(
                "a block holding an int4 leaf has no stacked form: int4 "
                "packs a leaf's rows, and a stacked leaf's rows are its "
                "blocks")
        scale = first["scale"]
        if not all(torch.equal(t["scale"], scale) for t in trees):
            raise ValueError("the blocks of a stack hold different scales "
                             "for one quantized leaf; it has no stacked form")
        return {"q": torch.stack([t["q"] for t in trees]),
                "scale": scale.unsqueeze(0)}
    return torch.stack(trees)


def _unstack(value, i):
    """Block ``i``'s leaf from a stacked leaf (a copy).

    Under the JAX package's int4 rule (``quantize_pytree``) a stacked
    kernel (3-D) stays int8, but a stacked bias or LayerNorm leaf, 2-D
    ``(n_block, d)`` with an even block count, is packed int4: its nibble
    pairs are pairs of blocks.  Block ``i`` then takes its row, unpacked,
    as an int8 leaf over the shared column scales: the same values the
    JAX rule dequantizes."""
    if is_qleaf(value):
        if "q4" in value:
            q4 = torch.as_tensor(value["q4"])
            rows = unpack_int4(q4, 2 * q4.shape[0])
            return {"q": rows[i].clone(),
                    "scale": torch.as_tensor(value["scale"]).reshape(-1)
                    .clone()}
        scale = torch.as_tensor(value["scale"])
        if scale.ndim == 0 or scale.shape[0] != 1:
            raise ValueError(f"a stacked quantized leaf needs a scale shared "
                             f"by the blocks (leading dim 1), got "
                             f"{tuple(scale.shape)}")
        return {"q": torch.as_tensor(value["q"])[i].clone(),
                "scale": scale[0].clone()}
    return torch.as_tensor(value)[i].clone()


class _BlockStack(Layer):
    """``n_block`` homogeneous blocks seen as one tree whose leaves carry a
    leading ``n_block`` dim — the JAX package's stacked layout.  Each block
    keeps its own leaves; ``params()`` stacks them and ``set_leaf`` splits
    a stacked leaf across them.  The owning layer builds and runs the
    blocks itself."""

    def __init__(self, blocks, **kw):
        super().__init__(**kw)
        self.blocks = nn.ModuleList(blocks)

    def params(self):
        return _stack([blk.params() for blk in self.blocks])

    def set_leaf(self, name, value) -> None:
        for i, blk in enumerate(self.blocks):
            blk.set_leaf(name, _unstack(value, i))


def _blocks(owner, stacked, n_block, prefix, make):
    """``n_block`` blocks under ``block{i}`` / ``enc{i}`` keys, or one
    ``blocks`` stack; returns the list of blocks in order."""
    if stacked:
        stack = owner.add_subtree("blocks", _BlockStack(
            [make(f"{owner.name}_{prefix}{i}") for i in range(n_block)],
            name=f"{owner.name}_{prefix}"))
        return list(stack.blocks)
    return [owner.add_subtree(f"{prefix}{i}", make(f"{owner.name}_{prefix}{i}"))
            for i in range(n_block)]


def _embedding(init, generator, shape):
    return initializers.get(init)(generator, shape, torch.float32) * 0.1


class TransformerLayer(Layer):
    """GPT-style decoder stack over token ids (reference
    api/keras/layers/TransformerLayer.scala:56).

    Input: token ids (B, L) [+ position ids (B, L)].  Output: hidden
    states (B, L, hidden_size).  Leaves ``tok_embed`` (vocab, H) and
    ``pos_embed`` (seq_len, H), and ``block{i}`` sub-trees (``blocks``
    when ``stacked``).  The embedding lookups are plain indexing, as in
    the JAX layer.
    """

    def __init__(self, vocab: int = 40990, seq_len: int = 77,
                 n_block: int = 12, nhead: int = 12, hidden_size: int = 768,
                 intermediate_size: Optional[int] = None,
                 hidden_drop: float = 0.1, attn_drop: float = 0.1,
                 embedding_drop: float = 0.1, causal: bool = True,
                 after_norm: bool = False, init="glorot_uniform",
                 stacked: bool = False,
                 seq_shards: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.vocab, self.seq_len = vocab, seq_len
        self.hidden_size = hidden_size
        self.n_block = n_block
        self.stacked = stacked
        self.init = init
        self.embed_dropout = Dropout(embedding_drop,
                                     name=f"{self.name}_embed_drop")
        self.block_list = _blocks(
            self, stacked, n_block, "block",
            lambda name: TransformerBlock(
                nhead, hidden_size, intermediate_size, hidden_drop,
                attn_drop, causal=causal, after_norm=after_norm, init=init,
                seq_shards=seq_shards, name=name))

    def build(self, generator, ids_shape, *rest):
        d = self.hidden_size
        self.set_leaf("tok_embed", _embedding(self.init, generator,
                                              (self.vocab, d)))
        self.set_leaf("pos_embed", _embedding(self.init, generator,
                                              (self.seq_len, d)))
        for blk in self.block_list:
            blk.build(generator, tuple(ids_shape) + (d,))

    def output_shape(self, ids_shape, *rest):
        return tuple(ids_shape) + (self.hidden_size,)

    def forward(self, ids, pos_ids=None):
        ids = ids.long()
        x = self.leaf("tok_embed")[ids]
        if pos_ids is None:
            x = x + self.leaf("pos_embed")[None, :ids.shape[1]]
        else:
            x = x + self.leaf("pos_embed")[pos_ids.long()]
        x = self.embed_dropout(x)
        for blk in self.block_list:
            x = blk(x)
        return x


class BERT(Layer):
    """BERT encoder (reference api/keras/layers/BERT.scala:66).

    Inputs: token ids (B, L), segment ids (B, L), [position ids (B, L)],
    [attention mask (B, L), 1 = real token].  Output: ``[sequence_output
    (B, L, H), pooled_output (B, H)]``.  Leaves ``word_embed``,
    ``pos_embed``, ``type_embed``; sub-trees ``embed_ln``, ``pooler`` and
    ``enc{i}`` (``blocks`` when ``stacked``).  The word / position / type
    lookups are plain indexing, as in the JAX layer.
    """

    def __init__(self, vocab: int = 40990, hidden_size: int = 768,
                 n_block: int = 12, nhead: int = 12,
                 intermediate_size: int = 3072, max_position_len: int = 512,
                 type_vocab_size: int = 2, hidden_drop: float = 0.1,
                 attn_drop: float = 0.1, init="glorot_uniform",
                 stacked: bool = False,
                 seq_shards: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.vocab = vocab
        self.hidden_size = hidden_size
        self.max_position_len = max_position_len
        self.type_vocab_size = type_vocab_size
        self.n_block = n_block
        self.stacked = stacked
        self.init = init
        _layernorm(self, "embed_ln")
        _dense(self, "pooler", hidden_size, init)
        self.embed_dropout = Dropout(hidden_drop,
                                     name=f"{self.name}_embed_drop")
        self.block_list = _blocks(
            self, stacked, n_block, "enc",
            lambda name: TransformerBlock(
                nhead, hidden_size, intermediate_size, hidden_drop,
                attn_drop, causal=False, activation="gelu",
                after_norm=False, init=init, seq_shards=seq_shards,
                name=name))

    def build(self, generator, ids_shape, *rest):
        d = self.hidden_size
        self.set_leaf("word_embed", _embedding(self.init, generator,
                                               (self.vocab, d)))
        self.set_leaf("pos_embed", _embedding(
            self.init, generator, (self.max_position_len, d)))
        self.set_leaf("type_embed", _embedding(
            self.init, generator, (self.type_vocab_size, d)))
        self._tree["embed_ln"].build(generator, (d,))
        self._tree["pooler"].build(generator, (d,))
        for blk in self.block_list:
            blk.build(generator, tuple(ids_shape) + (d,))

    def output_shape(self, ids_shape, *rest):
        b, l = ids_shape[0], ids_shape[1]
        return ((b, l, self.hidden_size), (b, self.hidden_size))

    def forward(self, ids, seg_ids=None, pos_ids=None, mask=None):
        ids = ids.long()
        seg_ids = (torch.zeros_like(ids) if seg_ids is None
                   else seg_ids.long())
        x = self.leaf("word_embed")[ids] + self.leaf("type_embed")[seg_ids]
        if pos_ids is None:
            x = x + self.leaf("pos_embed")[None, :ids.shape[1]]
        else:
            x = x + self.leaf("pos_embed")[pos_ids.long()]
        x = self.embed_dropout(self._tree["embed_ln"](x))
        for blk in self.block_list:
            x = blk(x) if mask is None else blk(x, mask)
        pooled = torch.tanh(self._tree["pooler"](x[:, 0]))
        return [x, pooled]
