"""Recommendation models: NeuralCF, WideAndDeep and SessionRecommender,
their serving base, and the implicit-feedback samplers
``negative_sample`` (host) and ``presample_implicit_epochs`` (on the
device).

NeuralCF: GMF embeddings ⊙ + an MLP tower over (user, item) ids, concat,
class-softmax head.  WideAndDeep: a wide linear tower (one bag sum over a
shared zero-initialised table) plus a deep tower (embedding columns,
indicator and continuous features, an MLP), summed into a softmax.
SessionRecommender: GRUs over the session's item ids, optionally beside
an MLP over the user's history, and a softmax over every item.  Each
graph is built in the JAX package's order, so the auto-named layers
(``flatten_1..4``, ``merge_1..3``) and every leaf name match its
parameter tree.  Ratings/classes follow the reference's 1-based
convention at the API surface, 0-based internally.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.core.context import resolve_device
from analytics_zoo_tpu_torch.models.common import ZooModel, register_model
from analytics_zoo_tpu_torch.nn import Input, Model
from analytics_zoo_tpu_torch.nn.layers.core import (Activation, Dense, Dropout,
                                                    Flatten)
from analytics_zoo_tpu_torch.nn.layers.embedding import Embedding, EmbeddingBag
from analytics_zoo_tpu_torch.nn.layers.merge import merge
from analytics_zoo_tpu_torch.nn.layers.recurrent import GRU

TABLE_PLACEMENTS = ("auto", "replicated", "sharded")


def _check_placement(requested: str) -> None:
    """On one device ``auto`` and ``replicated`` both keep every table
    whole on the card; row-sharding arrives with the multi-GPU slice."""
    if requested not in TABLE_PLACEMENTS:
        raise ValueError(f"table_placement must be one of "
                         f"{TABLE_PLACEMENTS}, got {requested!r}")
    if requested == "sharded":
        raise NotImplementedError(
            "table_placement='sharded' needs the multi-GPU slice")


class ServedModel(ZooModel):
    """Base of the models whose helpers score through a serving model.
    The helpers score the net's current weights, as the JAX package's
    helpers (which call ``model.predict``) do: through the serving
    ``InferenceModel`` that ``inference_model()`` built last while the
    weights it copied are unchanged, and through a fresh one of the same
    kind once they have changed (``fit``, ``load_weights``,
    ``load_jax_params`` or any in-place update); without one, through a
    float32 one."""

    _inference = None
    _inference_kw: Dict[str, Any] = {}
    _inference_stamp: Optional[tuple] = None

    def _weights_stamp(self) -> tuple:
        """What changes whenever the weights do, read without touching
        them: each tensor's storage and version counter (a replaced
        tensor, ``copy_`` or any other in-place op), and the estimator's
        step count (``fit`` on the card updates the weights inside
        replayed graphs, which no version counter sees)."""
        est = self.model._estimator
        return (tuple((t.data_ptr(), t._version)
                      for t in list(self.model.parameters())
                      + list(self.model.buffers())),
                id(est), None if est is None else est.global_step)

    def inference_model(self, **kw):
        """Build (and keep, for the helpers below) the serving model over
        this model's weights; ``kw`` go to
        ``InferenceModel.from_keras_net`` (``weight_dtype=``, ...)."""
        from analytics_zoo_tpu_torch.deploy.inference import InferenceModel

        kw.setdefault("device", self.device)
        self._inference_stamp = self._weights_stamp()
        self._inference = InferenceModel.from_keras_net(self.model, **kw)
        self._inference_kw = dict(kw)
        return self._inference

    def _scorer(self):
        """The serving model of the current weights: the one built last
        if the weights it copied are unchanged, else a fresh one built
        the same way."""
        if (self._inference is None
                or self._inference_stamp != self._weights_stamp()):
            return self.inference_model(**self._inference_kw)
        return self._inference


class Recommender(ServedModel):
    """Base with pair-scoring / top-K recommendation helpers."""

    def predict_user_item_pair(self, user_ids: np.ndarray,
                               item_ids: np.ndarray,
                               batch_size: int = 1024) -> np.ndarray:
        """Class probabilities for (user, item) pairs."""
        u = np.asarray(user_ids).reshape(-1, 1).astype(np.int32)
        i = np.asarray(item_ids).reshape(-1, 1).astype(np.int32)
        return self._scorer().predict([u, i], batch_size=batch_size)

    @staticmethod
    def _ranked(ids: np.ndarray, probs: np.ndarray, k: int
                ) -> List[Tuple[int, float]]:
        # score = expected rating over the 1-based classes
        if probs.shape[-1] > 1:
            classes = np.arange(1, probs.shape[-1] + 1)
            scores = (probs * classes).sum(-1)
        else:
            scores = probs[:, 0]
        order = np.argsort(-scores)[:k]
        return [(int(ids[j]), float(scores[j])) for j in order]

    def recommend_for_user(self, user_id: int, candidate_items: np.ndarray,
                           max_items: int = 10) -> List[Tuple[int, float]]:
        items = np.asarray(candidate_items)
        users = np.full_like(items, user_id)
        return self._ranked(items, self.predict_user_item_pair(users, items),
                            max_items)

    def recommend_for_item(self, item_id: int, candidate_users: np.ndarray,
                           max_users: int = 10) -> List[Tuple[int, float]]:
        users = np.asarray(candidate_users)
        items = np.full_like(users, item_id)
        return self._ranked(users, self.predict_user_item_pair(users, items),
                            max_users)


@register_model
class NeuralCF(Recommender):
    """Neural Collaborative Filtering.

    Two towers over (user, item) ids:
      - GMF: mf embeddings, elementwise product
      - MLP: embeddings concat -> hidden stack
    concat -> Dense(num_classes, softmax).  ``include_mf=False`` drops GMF.
    """

    def __init__(self, user_count: int, item_count: int, class_num: int = 5,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20,
                 dropout: float = 0.0, table_placement: str = "auto",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(device=device, generator=generator)
        if class_num < 2:
            raise ValueError(
                f"class_num must be >= 2, got {class_num} (the head is "
                "a softmax; use class_num=2 with int {0,1} labels for "
                "binary ratings)")
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        _check_placement(table_placement)
        self.user_count = user_count
        self.item_count = item_count
        self.class_num = class_num
        self.user_embed = user_embed
        self.item_embed = item_embed
        self.hidden_layers = tuple(hidden_layers)
        self.include_mf = include_mf
        self.mf_embed = mf_embed
        self.dropout = dropout
        self.table_placement = table_placement
        self.build()

    def config(self):
        return dict(user_count=self.user_count, item_count=self.item_count,
                    class_num=self.class_num, user_embed=self.user_embed,
                    item_embed=self.item_embed,
                    hidden_layers=list(self.hidden_layers),
                    include_mf=self.include_mf, mf_embed=self.mf_embed,
                    dropout=self.dropout,
                    table_placement=self.table_placement)

    def build(self):
        user = Input(shape=(1,), dtype=torch.int32, name="user")
        item = Input(shape=(1,), dtype=torch.int32, name="item")

        # +1: ids are 1-based at the API surface (MovieLens convention);
        # row 0 is an unused pad row
        mlp_u = Flatten()(Embedding(self.user_count + 1, self.user_embed,
                                    name="mlp_user_embed")(user))
        mlp_i = Flatten()(Embedding(self.item_count + 1, self.item_embed,
                                    name="mlp_item_embed")(item))
        h = merge([mlp_u, mlp_i], mode="concat")
        for k, width in enumerate(self.hidden_layers):
            h = Dense(width, activation="relu", name=f"mlp_dense_{k}")(h)
            if self.dropout > 0:
                h = Dropout(self.dropout, name=f"mlp_drop_{k}")(h)

        if self.include_mf:
            mf_u = Flatten()(Embedding(self.user_count + 1, self.mf_embed,
                                       name="mf_user_embed")(user))
            mf_i = Flatten()(Embedding(self.item_count + 1, self.mf_embed,
                                       name="mf_item_embed")(item))
            gmf = merge([mf_u, mf_i], mode="mul")
            h = merge([gmf, h], mode="concat")

        out = Dense(self.class_num, activation="softmax", name="ncf_head")(h)
        self._finish(Model([user, item], out, name="NeuralCF"))
        return self


@register_model
class WideAndDeep(Recommender):
    """Wide & Deep.

    wide: one id per wide column, offset into one shared table of
    ``class_num`` columns (``init="zero"``, ``pad_id=None``: every id is
    a live feature), summed by the fused bag (``ops/embedding_bag.py``):
    sparse ``W·x`` without the (B, n_wide, class_num) rows in memory.
    deep: the indicator columns, one embedding per embed column (cut from
    the embed input by ``Variable.slice``) and the continuous columns,
    concatenated into an MLP and a ``class_num`` head.
    ``model_type``: "wide" | "deep" | "wide_n_deep"; the towers' logits
    sum into one softmax.  Inputs, in this order where present: wide
    int32 (B, n_wide), indicator f32 (B, sum(indicator_dims)), embed
    int32 (B, n_embed), continuous f32 (B, continuous_cols).
    """

    def __init__(self, class_num: int, model_type: str = "wide_n_deep",
                 wide_base_dims: Sequence[int] = (),
                 wide_cross_dims: Sequence[int] = (),
                 indicator_dims: Sequence[int] = (),
                 embed_in_dims: Sequence[int] = (),
                 embed_out_dims: Sequence[int] = (),
                 continuous_cols: int = 0,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 table_placement: str = "auto", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device=device, generator=generator)
        if class_num < 2:
            raise ValueError(
                f"class_num must be >= 2, got {class_num} (softmax head; "
                "use class_num=2 for binary targets)")
        if model_type not in ("wide", "deep", "wide_n_deep"):
            raise ValueError(f"model_type must be wide|deep|wide_n_deep, "
                             f"got {model_type!r}")
        _check_placement(table_placement)
        self.class_num = class_num
        self.model_type = model_type
        self.wide_base_dims = tuple(wide_base_dims)
        self.wide_cross_dims = tuple(wide_cross_dims)
        self.indicator_dims = tuple(indicator_dims)
        self.embed_in_dims = tuple(embed_in_dims)
        self.embed_out_dims = tuple(embed_out_dims)
        self.continuous_cols = continuous_cols
        self.hidden_layers = tuple(hidden_layers)
        self.table_placement = table_placement
        self.build()

    def config(self):
        return dict(class_num=self.class_num, model_type=self.model_type,
                    wide_base_dims=list(self.wide_base_dims),
                    wide_cross_dims=list(self.wide_cross_dims),
                    indicator_dims=list(self.indicator_dims),
                    embed_in_dims=list(self.embed_in_dims),
                    embed_out_dims=list(self.embed_out_dims),
                    continuous_cols=self.continuous_cols,
                    hidden_layers=list(self.hidden_layers),
                    table_placement=self.table_placement)

    def build(self):
        inputs, towers = [], []
        wide_dims = self.wide_base_dims + self.wide_cross_dims
        if self.model_type in ("wide", "wide_n_deep") and wide_dims:
            wide_in = Input(shape=(len(wide_dims),), dtype=torch.int32,
                            name="wide_input")
            inputs.append(wide_in)
            towers.append(EmbeddingBag(
                int(np.sum(wide_dims)), self.class_num, combiner="sum",
                init="zero", pad_id=None, name="wide_linear")(wide_in))

        if self.model_type in ("deep", "wide_n_deep"):
            deep_parts = []
            if self.indicator_dims:
                ind_in = Input(shape=(int(np.sum(self.indicator_dims)),),
                               name="indicator_input")
                inputs.append(ind_in)
                deep_parts.append(ind_in)
            if self.embed_in_dims:
                embed_in = Input(shape=(len(self.embed_in_dims),),
                                 dtype=torch.int32, name="embed_input")
                inputs.append(embed_in)
                for k, (in_d, out_d) in enumerate(
                        zip(self.embed_in_dims, self.embed_out_dims)):
                    col = embed_in.slice(1, k, 1)
                    deep_parts.append(Flatten()(Embedding(
                        in_d + 1, out_d, name=f"deep_embed_{k}")(col)))
            if self.continuous_cols:
                cont_in = Input(shape=(self.continuous_cols,),
                                name="continuous_input")
                inputs.append(cont_in)
                deep_parts.append(cont_in)
            if not deep_parts:
                raise ValueError("a deep tower needs indicator, embed or "
                                 "continuous columns")
            h = (merge(deep_parts, mode="concat")
                 if len(deep_parts) > 1 else deep_parts[0])
            for k, width in enumerate(self.hidden_layers):
                h = Dense(width, activation="relu", name=f"deep_dense_{k}")(h)
            towers.append(Dense(self.class_num, name="deep_head")(h))
        if not towers:
            raise ValueError(f"model_type={self.model_type!r} with no wide "
                             f"columns builds no tower")

        logits = towers[0] if len(towers) == 1 else merge(towers, mode="sum")
        out = Activation("softmax", name="wnd_softmax")(logits)
        self._finish(Model(inputs, out, name="WideAndDeep"))
        return self


@register_model
class SessionRecommender(ServedModel):
    """Session-based recommender: GRUs over the session's item ids
    (optionally beside an MLP over the user's ``history_length`` last
    items), and a softmax over every item (``item_count + 1`` classes,
    row 0 the pad id).  Inputs: session int32 (B, session_length), then,
    with ``include_history``, history int32 (B, history_length)."""

    def __init__(self, item_count: int, item_embed: int = 100,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 10, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 history_length: int = 5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device=device, generator=generator)
        if not rnn_hidden_layers:
            raise ValueError("rnn_hidden_layers needs at least one width")
        self.item_count = item_count
        self.item_embed = item_embed
        self.rnn_hidden_layers = tuple(rnn_hidden_layers)
        self.session_length = session_length
        self.include_history = include_history
        self.mlp_hidden_layers = tuple(mlp_hidden_layers)
        self.history_length = history_length
        self.build()

    def config(self):
        return dict(item_count=self.item_count, item_embed=self.item_embed,
                    rnn_hidden_layers=list(self.rnn_hidden_layers),
                    session_length=self.session_length,
                    include_history=self.include_history,
                    mlp_hidden_layers=list(self.mlp_hidden_layers),
                    history_length=self.history_length)

    def build(self):
        session = Input(shape=(self.session_length,), dtype=torch.int32,
                        name="session_input")
        inputs = [session]
        h = Embedding(self.item_count + 1, self.item_embed,
                      name="session_embed")(session)
        for k, width in enumerate(self.rnn_hidden_layers[:-1]):
            h = GRU(width, return_sequences=True, name=f"session_gru_{k}")(h)
        h = GRU(self.rnn_hidden_layers[-1], name="session_gru_last")(h)

        if self.include_history:
            hist = Input(shape=(self.history_length,), dtype=torch.int32,
                         name="history_input")
            inputs.append(hist)
            g = Flatten()(Embedding(self.item_count + 1, self.item_embed,
                                    name="history_embed")(hist))
            for k, width in enumerate(self.mlp_hidden_layers):
                g = Dense(width, activation="relu",
                          name=f"history_mlp_{k}")(g)
            h = merge([h, g], mode="concat")

        out = Dense(self.item_count + 1, activation="softmax",
                    name="session_head")(h)
        self._finish(Model(inputs, out, name="SessionRecommender"))
        return self

    def recommend_for_session(self, sessions, max_items: int = 10,
                              batch_size: int = 1024
                              ) -> List[List[Tuple[int, float]]]:
        """The ``max_items`` most probable next items of each session, as
        ``(item, probability)`` lists.  ``sessions``: (B, session_length)
        ids, or with ``include_history`` the pair (sessions, histories)."""
        xs = ([np.asarray(a, np.int32) for a in sessions]
              if self.include_history else np.asarray(sessions, np.int32))
        probs = self._scorer().predict(xs, batch_size=batch_size)
        top = np.argsort(-probs, axis=-1)[:, :max_items]
        return [[(int(i), float(p[i])) for i in row]
                for row, p in zip(top, probs)]


# ---------------------------------------------------------------------------
# implicit-feedback sampling


def negative_sample(user_ids: np.ndarray, item_ids: np.ndarray,
                    item_count: int, neg_per_pos: int = 1, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Implicit-feedback negatives on the host (the JAX package's numpy
    sampler, copied): for each positive (u, i) pair, ``neg_per_pos`` items
    the user has not interacted with (up to 10 redraws).  Returns
    shuffled (users, items, labels) with labels 1 / 0."""
    rs = np.random.RandomState(seed)
    seen = {}
    for u, i in zip(user_ids, item_ids):
        seen.setdefault(int(u), set()).add(int(i))
    neg_u, neg_i = [], []
    for u in user_ids:
        s = seen[int(u)]
        for _ in range(neg_per_pos):
            j = int(rs.randint(1, item_count + 1))
            tries = 0
            while j in s and tries < 10:
                j = int(rs.randint(1, item_count + 1))
                tries += 1
            neg_u.append(u)
            neg_i.append(j)
    users = np.concatenate([user_ids, np.asarray(neg_u)])
    items = np.concatenate([item_ids, np.asarray(neg_i)])
    labels = np.concatenate([np.ones(len(user_ids)), np.zeros(len(neg_u))])
    perm = rs.permutation(len(users))
    return users[perm], items[perm], labels[perm]


def presample_implicit_epochs(user_ids, item_ids, item_count: int, *,
                              epochs: int, neg_per_pos: int = 1,
                              seed: int = 0, trim_multiple: int = 1,
                              user_count: Optional[int] = None,
                              device=None,
                              generator: Optional[torch.Generator] = None):
    """Negative sampling for every epoch, on the device.

    For each epoch, every positive (u, i) contributes itself and
    ``neg_per_pos`` uniform negatives in [1, item_count], redrawn against
    the user's seen items in three fixed rejection rounds over a dense
    (users + 1, items + 1) seen-matrix (a negative stays seen only at odds
    of about (seen / item_count)^4); item 0, the pad row, is never drawn.
    The epoch's stream is then permuted and trimmed to a multiple of
    ``trim_multiple`` (pass the batch size so ``fit`` drops nothing).

    Draws come from ``generator`` (a ``torch.Generator`` on ``device``;
    default one seeded with ``seed``), not ``jax.random``'s bits.
    Returns ``(users, items, labels)``, (epochs, S) int32 tensors on
    ``device`` — feed epoch slices to ``fit`` for device-resident
    training.
    """
    device = resolve_device(device)
    n_pos = int(len(user_ids))
    uc = int(user_count if user_count is not None else np.max(user_ids))
    pos_u = torch.as_tensor(np.asarray(user_ids, np.int64), device=device)
    pos_i = torch.as_tensor(np.asarray(item_ids, np.int64), device=device)
    seen = torch.zeros((uc + 1, item_count + 1), dtype=torch.bool,
                       device=device)
    seen[pos_u, pos_i] = True
    seen[:, 0] = True                          # pad item never sampled
    s_raw = n_pos * (1 + neg_per_pos)
    s_out = (s_raw // trim_multiple) * trim_multiple
    if s_out == 0:
        raise ValueError(
            f"trim_multiple={trim_multiple} exceeds the epoch stream "
            f"({s_raw} samples = {n_pos} positives x (1+{neg_per_pos}))")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    neg_u = pos_u.repeat_interleave(neg_per_pos)
    labels = torch.cat([torch.ones(n_pos, dtype=torch.int32, device=device),
                        torch.zeros(n_pos * neg_per_pos, dtype=torch.int32,
                                    device=device)])
    users = torch.cat([pos_u, neg_u])

    def draw():
        return torch.randint(1, item_count + 1, neg_u.shape,
                             generator=generator, device=device)

    out_u, out_i, out_l = [], [], []
    for _ in range(epochs):
        neg_i = draw()
        for _ in range(3):                     # fixed rejection rounds
            neg_i = torch.where(seen[neg_u, neg_i], draw(), neg_i)
        items = torch.cat([pos_i, neg_i])
        perm = torch.randperm(s_raw, generator=generator,
                              device=device)[:s_out]
        out_u.append(users[perm])
        out_i.append(items[perm])
        out_l.append(labels[perm])
    return (torch.stack(out_u).to(torch.int32),
            torch.stack(out_i).to(torch.int32), torch.stack(out_l))
