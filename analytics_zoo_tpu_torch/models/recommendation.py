"""Recommendation models: NeuralCF and its ``Recommender`` base.

NeuralCF: GMF embeddings ⊙ + an MLP tower over (user, item) ids, concat,
class-softmax head.  The graph is built in the JAX package's order, so
the auto-named layers (``flatten_1..4``, ``merge_1..3``) and every leaf
name match its parameter tree.  Ratings/classes follow the reference's
1-based convention at the API surface, 0-based internally.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.common import ZooModel, register_model
from analytics_zoo_tpu_torch.nn import Input, Model
from analytics_zoo_tpu_torch.nn.layers.core import Dense, Dropout, Flatten
from analytics_zoo_tpu_torch.nn.layers.embedding import Embedding
from analytics_zoo_tpu_torch.nn.layers.merge import merge

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


class Recommender(ZooModel):
    """Base with pair-scoring / top-K recommendation helpers.  They run
    through the serving ``InferenceModel`` — the one ``inference_model()``
    built last, or a float32 one on the model's device."""

    _inference = None

    def inference_model(self, **kw):
        """Build (and keep, for the helpers below) the serving model over
        this recommender's weights; ``kw`` go to
        ``InferenceModel.from_keras_net`` (``weight_dtype=``, ...)."""
        from analytics_zoo_tpu_torch.deploy.inference import InferenceModel

        kw.setdefault("device", self.device)
        self._inference = InferenceModel.from_keras_net(self.model, **kw)
        return self._inference

    def predict_user_item_pair(self, user_ids: np.ndarray,
                               item_ids: np.ndarray,
                               batch_size: int = 1024) -> np.ndarray:
        """Class probabilities for (user, item) pairs."""
        u = np.asarray(user_ids).reshape(-1, 1).astype(np.int32)
        i = np.asarray(item_ids).reshape(-1, 1).astype(np.int32)
        m = self._inference or self.inference_model()
        return m.predict([u, i], batch_size=batch_size)

    def recommend_for_user(self, user_id: int, candidate_items: np.ndarray,
                           max_items: int = 10) -> List[Tuple[int, float]]:
        items = np.asarray(candidate_items)
        users = np.full_like(items, user_id)
        probs = self.predict_user_item_pair(users, items)
        # score = expected rating over the 1-based classes
        if probs.shape[-1] > 1:
            classes = np.arange(1, probs.shape[-1] + 1)
            scores = (probs * classes).sum(-1)
        else:
            scores = probs[:, 0]
        order = np.argsort(-scores)[:max_items]
        return [(int(items[j]), float(scores[j])) for j in order]


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
