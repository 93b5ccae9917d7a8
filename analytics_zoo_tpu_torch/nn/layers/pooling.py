"""Pooling layers.  The global 1-D poolings only — what the repo's
transformer classifier puts on top of ``TransformerLayer``; the windowed
and 2-D/3-D poolings come with the image slice."""

from __future__ import annotations

from analytics_zoo_tpu_torch.nn.module import Layer

DIM_ORDERINGS = ("tf", "th")


class _GlobalPool1D(Layer):
    """Reduce over the steps axis of (B, steps, C) ("tf") or (B, C, steps)
    ("th") inputs, giving (B, C)."""

    mode = "max"

    def __init__(self, dim_ordering: str = "tf", **kw):
        super().__init__(**kw)
        if dim_ordering not in DIM_ORDERINGS:
            raise ValueError(f"dim_ordering must be one of {DIM_ORDERINGS}, "
                             f"got {dim_ordering!r}")
        self.dim_ordering = dim_ordering

    def output_shape(self, input_shape):
        c = input_shape[1] if self.dim_ordering == "th" else input_shape[2]
        return (input_shape[0], c)

    def forward(self, x):
        axis = 2 if self.dim_ordering == "th" else 1
        return x.amax(dim=axis) if self.mode == "max" else x.mean(dim=axis)


class GlobalMaxPooling1D(_GlobalPool1D):
    mode = "max"


class GlobalAveragePooling1D(_GlobalPool1D):
    mode = "avg"
