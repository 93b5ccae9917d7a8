"""Text pipeline: ``TextSet`` / ``TextFeature`` with the tokenize,
normalize, word2idx, shape_sequence and generate_sample stages, the
vocabulary's save and load, the folder and CSV readers, and
``load_glove_embeddings``.

A copy of the JAX package's ``data/text.py`` (numpy only, run on the
host): the stages give dense int32 id matrices of a fixed length (padded
or cut at the front by default, id 0 the pad and unknown word) that batch
straight onto the device.
"""

from __future__ import annotations

import csv as _csv
import json
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class TextFeature(dict):
    """One text record: keys text / label / tokens / indexed / sample
    (reference feature/text/TextFeature.scala)."""

    @property
    def text(self) -> str:
        return self.get("text", "")

    @property
    def label(self):
        return self.get("label")


class TextSet:
    """Collection of TextFeatures with chainable stages
    (reference TextSet.scala — stages mutate a copied feature list)."""

    def __init__(self, features: List[TextFeature],
                 word_index: Optional[Dict[str, int]] = None):
        self.features = features
        self.word_index = word_index

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_texts(texts: Sequence[str],
                   labels: Optional[Sequence[int]] = None) -> "TextSet":
        feats = []
        for i, t in enumerate(texts):
            f = TextFeature(text=t)
            if labels is not None:
                f["label"] = int(labels[i])
            feats.append(f)
        return TextSet(feats)

    @staticmethod
    def read(path: str, num_shards: int = 1, shard_index: int = 0
             ) -> "TextSet":
        """Read a folder-per-class text corpus (reference TextSet.read:290:
        path/<category>/*.txt, category names sorted → 0-based labels)."""
        classes = sorted(d for d in os.listdir(path)
                         if os.path.isdir(os.path.join(path, d)))
        label_map = {c: i for i, c in enumerate(classes)}
        feats = []
        for c in classes:
            cdir = os.path.join(path, c)
            for fn in sorted(os.listdir(cdir)):
                fp = os.path.join(cdir, fn)
                if os.path.isfile(fp):
                    with open(fp, encoding="utf-8", errors="ignore") as f:
                        feats.append(TextFeature(text=f.read(),
                                                 label=label_map[c]))
        ts = TextSet(feats[shard_index::num_shards])
        ts.label_map = label_map
        return ts

    @staticmethod
    def read_csv(path: str, text_col="text", label_col: Optional[str] = "label",
                 **kw) -> "TextSet":
        """Reference TextSet.readCSV:345 (uid,text columns)."""
        feats = []
        with open(path, newline="", encoding="utf-8") as f:
            for row in _csv.DictReader(f):
                feat = TextFeature(text=row[text_col])
                if label_col and label_col in row:
                    feat["label"] = int(row[label_col])
                for k, v in row.items():
                    if k not in (text_col, label_col):
                        feat[k] = v
                feats.append(feat)
        return TextSet(feats)

    @staticmethod
    def read_parquet(path: str, text_col="text",
                     label_col: Optional[str] = "label") -> "TextSet":
        """Reference TextSet.readParquet:372."""
        import pandas as pd

        df = pd.read_parquet(path)
        labels = df[label_col].tolist() if label_col in df else None
        return TextSet.from_texts(df[text_col].tolist(), labels)

    # -- stages ------------------------------------------------------------
    def _map(self, fn: Callable[[TextFeature], TextFeature]) -> "TextSet":
        out = TextSet([fn(TextFeature(f)) for f in self.features],
                      self.word_index)
        if hasattr(self, "label_map"):
            out.label_map = self.label_map
        return out

    def tokenize(self) -> "TextSet":
        """Whitespace/punct split (reference Tokenizer.scala)."""
        pat = re.compile(r"[\w']+")

        def fn(f):
            f["tokens"] = pat.findall(f.text)
            return f

        return self._map(fn)

    def normalize(self) -> "TextSet":
        """Lowercase + strip non-alphanumeric tokens
        (reference Normalizer.scala)."""
        def fn(f):
            toks = [t.lower() for t in f.get("tokens", [])]
            f["tokens"] = [t for t in toks if t and not t.isspace()]
            return f

        return self._map(fn)

    def word2idx(self, remove_topN: int = 0, max_words_num: int = -1,
                 min_freq: int = 1, existing_map: Optional[Dict[str, int]] = None
                 ) -> "TextSet":
        """Build (or reuse) the vocabulary and index tokens; ids are
        1-based with 0 reserved for padding/UNK (reference
        TextSet.word2idx:147 + WordIndexer.scala)."""
        if existing_map is not None:
            vocab = dict(existing_map)
        else:
            freq: Dict[str, int] = {}
            for f in self.features:
                for t in f.get("tokens", []):
                    freq[t] = freq.get(t, 0) + 1
            items = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
            items = [kv for kv in items if kv[1] >= min_freq]
            items = items[remove_topN:]
            if max_words_num > 0:
                items = items[:max_words_num]
            vocab = {w: i + 1 for i, (w, _) in enumerate(items)}

        def fn(f):
            f["indexed"] = [vocab.get(t, 0) for t in f.get("tokens", [])]
            return f

        out = self._map(fn)
        out.word_index = vocab
        return out

    def shape_sequence(self, len: int, trunc_mode: str = "pre",  # noqa: A002
                       pad_element: int = 0) -> "TextSet":
        """Pad/truncate to fixed length (reference SequenceShaper.scala;
        ``trunc_mode='pre'`` keeps/pads at the FRONT like the reference —
        the parameter is named ``len`` for API parity)."""
        target = len

        def fn(f):
            seq = list(f.get("indexed", []))
            n = seq.__len__()
            if n > target:
                seq = seq[-target:] if trunc_mode == "pre" else seq[:target]
            elif n < target:
                pad = [pad_element] * (target - n)
                seq = pad + seq if trunc_mode == "pre" else seq + pad
            f["indexed"] = seq
            return f

        return self._map(fn)

    def generate_sample(self) -> "TextSet":
        """Finalize int32 arrays (reference TextFeatureToSample.scala)."""
        def fn(f):
            f["sample"] = np.asarray(f.get("indexed", []), np.int32)
            return f

        return self._map(fn)

    # -- vocabulary persistence (reference TextSet.saveWordIndex) ----------
    def save_word_index(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.word_index or {}, f)

    @staticmethod
    def load_word_index(path: str) -> Dict[str, int]:
        with open(path) as f:
            return json.load(f)

    # -- materialization ---------------------------------------------------
    def __len__(self):
        return len(self.features)

    def to_arrays(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        xs = [f.get("sample", np.asarray(f.get("indexed", []), np.int32))
              for f in self.features]
        x = np.stack(xs)
        labels = [f.label for f in self.features if f.label is not None]
        if labels and np.asarray(labels).shape[0] != x.shape[0]:
            raise ValueError("some records lack labels")
        y = np.asarray(labels, np.int32) if labels else None
        return x, y

    def to_feature_set(self, memory_type: str = "DRAM",
                       cache_level: Optional[str] = None):
        from analytics_zoo_tpu_torch.data.featureset import FeatureSet

        x, y = self.to_arrays()
        return FeatureSet.from_ndarrays(x, y, memory_type=memory_type,
                                        cache_level=cache_level)


def load_glove_embeddings(path: str, word_index: Dict[str, int],
                          dim: Optional[int] = None) -> np.ndarray:
    """An embedding matrix (1-based ids, row 0 the pad / unknown word,
    zeros) from a GloVe text file, its dimension the file's: the rows of
    the vocabulary's words, zeros for words the file lacks.  Raises when
    no vocabulary word is in the file, or when ``dim`` is given and the
    file's differs."""
    found = None
    vectors = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if parts[0] in word_index:
                vec = np.asarray(parts[1:], dtype=np.float32)
                found = len(vec)
                vectors[parts[0]] = vec
    if found is None:
        raise ValueError(f"no vocabulary words found in {path}")
    table = np.zeros((max(word_index.values()) + 1, found), np.float32)
    for word, idx in word_index.items():
        if word in vectors:
            table[idx] = vectors[word]
    if dim is not None and found != dim:
        raise ValueError(
            f"GloVe file {path} has dim {found}, expected {dim}")
    return table
