"""TFDataset facades: uniform (features, labels, batch) handles.

Reference capability: pyzoo/zoo/tfpark/tf_dataset.py:115-643 — the
``TFDataset`` hierarchy (from_rdd:304, from_ndarrays:360,
from_image_set:387, from_text_set:423, from_feature_set:499,
from_dataframe:611, from_tf_data_dataset:575).  There the dataset carried
a serialized tf.data graph executed inside each JVM executor; here it is a
plain host-side container handing numpy arrays to the Estimator (the JAX
package's module, copied: it is plain numpy).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TFDataset"]


def _as_list(x) -> List[np.ndarray]:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [np.asarray(a) for a in x]
    return [np.asarray(x)]


class TFDataset:
    """(features, labels) + batch size, with optional validation split."""

    def __init__(self, features, labels=None, batch_size: int = 32,
                 val_features=None, val_labels=None):
        self.features = _as_list(features)
        self.labels = _as_list(labels)
        if not self.features:
            raise ValueError("TFDataset needs at least one feature tensor")
        n = self.features[0].shape[0]
        for a in self.features + self.labels:
            if a.shape[0] != n:
                raise ValueError("all tensors must share the leading dim")
        self.batch_size = batch_size
        self.val_features = _as_list(val_features)
        self.val_labels = _as_list(val_labels)

    def __len__(self) -> int:
        return self.features[0].shape[0]

    @property
    def x(self):
        return (self.features[0] if len(self.features) == 1
                else self.features)

    @property
    def y(self):
        if not self.labels:
            return None
        return self.labels[0] if len(self.labels) == 1 else self.labels

    @property
    def validation(self) -> Optional[Tuple]:
        if not self.val_features:
            return None
        vx = (self.val_features[0] if len(self.val_features) == 1
              else self.val_features)
        vy = (self.val_labels[0] if len(self.val_labels) == 1
              else self.val_labels) if self.val_labels else None
        return (vx, vy)

    # -- constructors (reference tf_dataset.py:304-643) --------------------
    @classmethod
    def from_ndarrays(cls, tensors, batch_size: int = 32,
                      val_tensors=None) -> "TFDataset":
        """(x, y) tuple of ndarrays / lists (reference from_ndarrays:360)."""
        x, y = (tensors if isinstance(tensors, tuple) and len(tensors) == 2
                else (tensors, None))
        vx, vy = (val_tensors if val_tensors else (None, None))
        return cls(x, y, batch_size=batch_size, val_features=vx,
                   val_labels=vy)

    @classmethod
    def from_image_set(cls, image_set, batch_size: int = 32,
                       labels=None) -> "TFDataset":
        """Materialize an ``data.image.ImageSet`` pipeline (reference
        from_image_set:387)."""
        arr, y = image_set.to_arrays()
        if labels is not None:
            y = labels
        return cls(arr, y, batch_size=batch_size)

    @classmethod
    def from_text_set(cls, text_set, batch_size: int = 32) -> "TFDataset":
        """Materialize a ``data.text.TextSet`` (reference from_text_set:423)."""
        x, y = text_set.to_arrays()
        return cls(x, y, batch_size=batch_size)

    @classmethod
    def from_feature_set(cls, feature_set, has_labels: bool = True,
                         batch_size: int = 32) -> "TFDataset":
        """Wrap a ``data.featureset.FeatureSet`` (reference
        from_feature_set:499).  FeatureSet convention: labels, when
        present, are the last array."""
        arrays = feature_set.arrays
        if has_labels and len(arrays) >= 2:
            return cls(list(arrays[:-1]), arrays[-1],
                       batch_size=batch_size)
        return cls(list(arrays), None, batch_size=batch_size)

    @classmethod
    def from_dataframe(cls, df, feature_cols: Sequence[str],
                       label_cols: Optional[Sequence[str]] = None,
                       batch_size: int = 32) -> "TFDataset":
        """pandas/pyarrow DataFrame → tensors (reference from_dataframe:611)."""
        if hasattr(df, "to_pandas"):  # pyarrow Table
            df = df.to_pandas()
        xs = [np.stack(df[c].to_numpy()) for c in feature_cols]
        ys = ([np.stack(df[c].to_numpy()) for c in label_cols]
              if label_cols else None)
        return cls(xs, ys, batch_size=batch_size)

    @classmethod
    def from_tfrecord_file(cls, path: str, feature_cols: Sequence[str],
                           label_col: Optional[str] = None,
                           batch_size: int = 32) -> "TFDataset":
        """Parse tf.Example TFRecords WITHOUT TensorFlow (reference
        from_tfrecord_file:458 ran a TF graph per partition; here the
        record framing + Example protos are decoded natively —
        data/tfrecord.py, crc32c in C++ when built)."""
        from analytics_zoo_tpu_torch.data.tfrecord import read_example_file

        examples = read_example_file(path)
        if not examples:
            raise ValueError(f"no records in {path}")
        xs = [np.stack([np.asarray(ex[c]) for ex in examples])
              for c in feature_cols]
        y = (np.stack([np.asarray(ex[label_col]) for ex in examples])
             if label_col else None)
        if y is not None and y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        return cls(xs, y, batch_size=batch_size)

    @classmethod
    def from_tf_data_dataset(cls, dataset, batch_size: int = 32,
                             max_examples: Optional[int] = None
                             ) -> "TFDataset":
        """Drain a tf.data.Dataset to host arrays (reference
        from_tf_data_dataset:575 serialized the graph instead).  Only
        ``as_numpy_iterator()`` is called, so any object with one will
        do."""
        xs_rows: List[Any] = []
        ys_rows: List[Any] = []
        for i, item in enumerate(dataset.as_numpy_iterator()):
            if max_examples is not None and i >= max_examples:
                break
            if isinstance(item, tuple) and len(item) == 2:
                x, y = item
                xs_rows.append(x)
                ys_rows.append(y)
            else:
                xs_rows.append(item)
        x = np.stack(xs_rows, axis=0)
        y = np.stack(ys_rows, axis=0) if ys_rows else None
        return cls(x, y, batch_size=batch_size)
