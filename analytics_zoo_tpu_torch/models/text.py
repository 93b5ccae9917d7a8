"""Text models: TextClassifier (CNN / LSTM / GRU encoders), the KNRM
kernel-pooling ranker, and ranking evaluation (NDCG, MAP, ``Ranker``).

Each is built as the JAX package builds it, with its explicit layer
names (``tc_embed``, ``tc_conv``, ``shared_embedding``, ...), so the
parameter trees match leaf for leaf and weights carry across by name
(``convert.load_jax_params``, ``save_model`` / ``load_model``).  Every
embedding lookup goes through the bag kernel (``ops/embedding_bag.py``);
served in int8 / int4, the Dense layers go through the dequantize-matmul
kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.common import register_model
from analytics_zoo_tpu_torch.models.recommendation import ServedModel
from analytics_zoo_tpu_torch.nn import Input, Model, Sequential
from analytics_zoo_tpu_torch.nn.layers.convolutional import Convolution1D
from analytics_zoo_tpu_torch.nn.layers.core import Dense, Dropout, Lambda
from analytics_zoo_tpu_torch.nn.layers.embedding import Embedding
from analytics_zoo_tpu_torch.nn.layers.pooling import GlobalMaxPooling1D
from analytics_zoo_tpu_torch.nn.layers.recurrent import GRU, LSTM

ENCODERS = ("cnn", "lstm", "gru")


@register_model
class TextClassifier(ServedModel):
    """Embedding -> encoder -> Dropout(0.2) -> Dense(128, relu) ->
    Dense(class_num) logits.  ``encoder``: "cnn" (``Convolution1D(
    encoder_output_dim, 5, relu)`` and a global max pool), "lstm" or
    "gru".  Input: (B, sequence_length) int32 word ids, 0 the pad."""

    def __init__(self, class_num: int, token_length: int = 200,
                 sequence_length: int = 500, encoder: str = "cnn",
                 encoder_output_dim: int = 256, max_words_num: int = 5000,
                 embedding_weights: Optional[np.ndarray] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(device=device, generator=generator)
        self.class_num = class_num
        self.token_length = token_length
        self.sequence_length = sequence_length
        self.encoder = encoder.lower()
        self.encoder_output_dim = encoder_output_dim
        self.max_words_num = max_words_num
        if self.encoder not in ENCODERS:
            raise ValueError(f"unknown encoder {encoder!r}; known: "
                             f"{', '.join(ENCODERS)}")
        layers = [Embedding(max_words_num + 1, token_length,
                            weights=embedding_weights, name="tc_embed",
                            input_shape=(sequence_length,))]
        if self.encoder == "cnn":
            layers += [Convolution1D(encoder_output_dim, 5,
                                     activation="relu", name="tc_conv"),
                       GlobalMaxPooling1D(name="tc_pool")]
        elif self.encoder == "lstm":
            layers.append(LSTM(encoder_output_dim, name="tc_lstm"))
        else:
            layers.append(GRU(encoder_output_dim, name="tc_gru"))
        layers += [Dropout(0.2, name="tc_drop"),
                   Dense(128, activation="relu", name="tc_fc"),
                   Dense(class_num, name="tc_out")]
        self._finish(Sequential(layers,
                                name=f"text_classifier_{self.encoder}"))

    def config(self):
        return {"class_num": self.class_num,
                "token_length": self.token_length,
                "sequence_length": self.sequence_length,
                "encoder": self.encoder,
                "encoder_output_dim": self.encoder_output_dim,
                "max_words_num": self.max_words_num}


def kernel_centres(kernel_num: int, sigma: float, exact_sigma: float):
    """KNRM's RBF kernels over the cosine range [-1, 1]: ``(mus,
    sigmas)``, the last one (mu = 1) the exact-match kernel with its own
    sigma, as Python floats."""
    mus, sigmas = [], []
    for i in range(kernel_num):
        mu = 1.0 / (kernel_num - 1) + (2.0 * i) / (kernel_num - 1) - 1.0
        if mu > 1.0:
            mu, sg = 1.0, exact_sigma
        else:
            sg = sigma
        mus.append(mu)
        sigmas.append(sg)
    return mus, sigmas


def kernel_pooling_fn(mus, sigmas):
    """KNRM's kernel pooling over (query, doc) embeddings, a function for
    a ``Lambda``: row norms clamped at 1e-8, the cosine translation
    matrix (B, Lq, Ld), the RBF stack (B, Lq, Ld, K), the sum over the
    doc, ``log1p(max(kq - 1e-10, 0))`` summed over the query, times 0.01.
    The kernels' centres and widths become f32 tensors on each device at
    its first (eager) call, which a CUDA graph's capture then reads."""
    consts: Dict[torch.device, tuple] = {}

    def kernel_pooling(qe, de):
        c = consts.get(qe.device)
        if c is None:
            c = consts[qe.device] = (
                torch.tensor(mus, dtype=torch.float32, device=qe.device),
                torch.tensor(sigmas, dtype=torch.float32, device=qe.device))
        mu, sg = c
        qn = qe / torch.clamp(torch.linalg.vector_norm(
            qe, dim=-1, keepdim=True), min=1e-8)
        dn = de / torch.clamp(torch.linalg.vector_norm(
            de, dim=-1, keepdim=True), min=1e-8)
        mm = torch.einsum("bqe,bde->bqd", qn, dn)
        diff = mm[..., None] - mu
        k = torch.exp(-0.5 * diff * diff / (sg * sg))
        kq = torch.sum(k, dim=2)                           # (B, Lq, K)
        soft_tf = torch.sum(torch.log1p(torch.clamp(kq - 1e-10, min=0.0)),
                            dim=1)                         # (B, K)
        return soft_tf * 0.01

    return kernel_pooling


@register_model
class KNRM(ServedModel):
    """Kernel-pooling neural ranking model (Xiong et al., SIGIR 2017):
    one embedding shared by the query and the doc, the kernel pooling of
    their cosine translation matrix, and a Dense(1) score (a sigmoid
    with ``target_mode="classification"``).  Inputs: query ids (B,
    text1_length), doc ids (B, text2_length), int32."""

    def __init__(self, text1_length: int, text2_length: int,
                 max_words_num: int = 5000, embed_size: int = 100,
                 embedding_weights: Optional[np.ndarray] = None,
                 train_embed: bool = True, kernel_num: int = 21,
                 sigma: float = 0.1, exact_sigma: float = 0.001,
                 target_mode: str = "ranking", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device=device, generator=generator)
        if kernel_num <= 1:
            raise ValueError(f"kernel_num must be > 1, got {kernel_num}")
        self.text1_length = text1_length
        self.text2_length = text2_length
        self.max_words_num = max_words_num
        self.embed_size = embed_size
        self.kernel_num = kernel_num
        self.sigma = sigma
        self.exact_sigma = exact_sigma
        self.target_mode = target_mode

        q_in = Input(shape=(text1_length,), dtype=torch.int32, name="query")
        d_in = Input(shape=(text2_length,), dtype=torch.int32, name="doc")
        embed = Embedding(max_words_num + 1, embed_size,
                          weights=embedding_weights, trainable=train_embed,
                          name="shared_embedding")
        pooled = Lambda(kernel_pooling_fn(*kernel_centres(
            kernel_num, sigma, exact_sigma)), name="kernel_pooling")(
                embed(q_in), embed(d_in))
        act = "sigmoid" if target_mode == "classification" else None
        out = Dense(1, activation=act, name="score")(pooled)
        self._finish(Model([q_in, d_in], out, name="knrm"))

    def config(self):
        return {"text1_length": self.text1_length,
                "text2_length": self.text2_length,
                "max_words_num": self.max_words_num,
                "embed_size": self.embed_size,
                "kernel_num": self.kernel_num, "sigma": self.sigma,
                "exact_sigma": self.exact_sigma,
                "target_mode": self.target_mode}


# ---------------------------------------------------------------------------
# ranking evaluation (host, numpy; the JAX package's functions)


def ndcg(y_true: np.ndarray, y_score: np.ndarray, k: int = 10) -> float:
    """NDCG@k of one query's candidates."""
    order = np.argsort(-np.asarray(y_score))
    gains = (2.0 ** np.asarray(y_true)[order] - 1.0)[:k]
    discounts = 1.0 / np.log2(np.arange(2, gains.size + 2))
    dcg = float(np.sum(gains * discounts))
    ideal = (2.0 ** np.sort(np.asarray(y_true))[::-1] - 1.0)[:k]
    idcg = float(np.sum(ideal * discounts[:ideal.size]))
    return dcg / idcg if idcg > 0 else 0.0


def mean_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Average precision of one query's candidates (relevance > 0 is
    relevant)."""
    order = np.argsort(-np.asarray(y_score))
    rel = np.asarray(y_true)[order] > 0
    if not rel.any():
        return 0.0
    prec = np.cumsum(rel) / np.arange(1, rel.size + 1)
    return float(np.sum(prec * rel) / rel.sum())


class Ranker:
    """Mean NDCG / MAP over (query id, label, score) triples, grouped by
    query."""

    @staticmethod
    def _group(qids, labels, scores):
        groups: Dict = {}
        for q, l, s in zip(qids, labels, scores):
            groups.setdefault(q, ([], []))
            groups[q][0].append(l)
            groups[q][1].append(s)
        return groups

    @classmethod
    def evaluate_ndcg(cls, qids, labels, scores, k: int = 10) -> float:
        groups = cls._group(qids, labels, scores)
        return float(np.mean([ndcg(l, s, k) for l, s in groups.values()]))

    @classmethod
    def evaluate_map(cls, qids, labels, scores) -> float:
        groups = cls._group(qids, labels, scores)
        return float(np.mean([mean_average_precision(l, s)
                              for l, s in groups.values()]))
