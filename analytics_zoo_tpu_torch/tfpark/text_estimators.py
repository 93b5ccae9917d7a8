"""BERT task models (reference pyzoo/zoo/tfpark/text/estimator/
bert_classifier.py / bert_ner.py / bert_squad.py).

The BERT encoder (``nn/layers/attention.py``) plus a task head, as one
``KerasNet`` over ``(ids, segments, mask)`` inputs: ``compile`` / ``fit``
/ ``evaluate`` / ``predict`` come from ``KerasNet``, and
``InferenceModel.from_keras_net`` serves it.  The parameter tree is the
JAX package's: ``{bert_name: {...}, "head": {"kernel", "bias"}}``, where
``"head"`` is a sub-tree of the net, not a layer (``layers`` is
``[bert]``).

The net builds its weights when it is made, from ``generator`` (default
seeded from ``ZooConfig.seed``), on the CPU; ``compile`` / ``fit`` or
``from_keras_net`` move them to the device.  The weights' shapes do not
depend on the input shapes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from analytics_zoo_tpu_torch.core.context import get_zoo_context
from analytics_zoo_tpu_torch.nn.layers.attention import BERT
from analytics_zoo_tpu_torch.nn.layers.core import Dense
from analytics_zoo_tpu_torch.nn.topology import KerasNet

__all__ = ["BERTClassifier", "BERTNER", "BERTSQuAD"]


class _BERTTask(KerasNet):
    """BERT encoder + task head over (ids, segments, mask) inputs."""

    head_on = "pooled"          # "pooled" | "sequence" | "qa"

    def __init__(self, num_classes: int, bert_config: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None, **kw):
        super().__init__(**kw)
        cfg = dict(vocab=30522, hidden_size=128, n_block=2, nhead=2,
                   intermediate_size=512, max_position_len=512)
        cfg.update(bert_config or {})
        self.bert = BERT(name=f"{self.name}_bert", **cfg)
        self.num_classes = num_classes
        self.hidden_size = cfg["hidden_size"]
        out = 2 if self.head_on == "qa" else num_classes
        self.add_subtree("head", Dense(out, name=f"{self.name}_head"))
        if generator is None:
            generator = torch.Generator().manual_seed(
                get_zoo_context().config.seed)
        self.build(generator)

    @property
    def layers(self):
        return [self.bert]

    def build(self, generator, ids_shape=(2, 1), *rest):
        self.bert.build(generator, tuple(ids_shape))
        self.subtree("head").build(generator, (self.hidden_size,))
        self._output_shape = self.output_shape(ids_shape)

    def output_shape(self, ids_shape, *rest):
        b, l = ids_shape[0], ids_shape[1]
        if self.head_on == "pooled":
            return (b, self.num_classes)
        if self.head_on == "sequence":
            return (b, l, self.num_classes)
        return ((b, l), (b, l))

    def forward(self, ids, segments=None, mask=None):
        # the BERT layer's positional order is ids, segments, positions,
        # mask: with a mask, positions are the default 0..L-1 so the mask
        # never lands in the positions slot
        inputs = [ids]
        if segments is not None or mask is not None:
            inputs.append(segments if segments is not None
                          else torch.zeros_like(ids))
        if mask is not None:
            positions = torch.arange(ids.shape[1], device=ids.device)
            inputs.extend([positions.expand(ids.shape), mask])
        seq, pooled = self.bert(*inputs)
        head = self.subtree("head")
        if self.head_on == "pooled":
            return head(pooled)
        logits = head(seq)                  # per-token heads (ner / qa)
        if self.head_on == "qa":
            return logits[..., 0], logits[..., 1]
        return logits


class BERTClassifier(_BERTTask):
    """Sequence classification on the pooled output (reference
    bert_classifier.py)."""

    head_on = "pooled"


class BERTNER(_BERTTask):
    """Token-level tagging on the sequence output (reference
    bert_ner.py)."""

    head_on = "sequence"


class BERTSQuAD(_BERTTask):
    """Extractive QA: start/end logits per token, returned as a pair
    (reference bert_squad.py)."""

    head_on = "qa"

    def __init__(self, bert_config: Optional[Dict] = None, **kw):
        super().__init__(num_classes=2, bert_config=bert_config, **kw)
