"""Rolling-window time-series feature engineering
(reference automl/feature/time_sequence.py:30-540: datetime feature
generation :526, rolling :415-470, scaling :503).

Input: a DataFrame with a datetime column + target column (+ extra
feature columns).  ``fit_transform`` generates calendar features, scales,
and rolls into (X, y) supervised windows; ``post_processing`` unscales
predictions back into a datetime-indexed frame.

The JAX package's module, copied: it is host code.  pandas is imported
inside the methods that take a DataFrame (the card machine may have
none), so ``automl`` imports without it; ``_roll``, ``_fit_scale`` and
``_scale`` are numpy.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_DT_FEATURES = ("HOUR", "DAY", "MONTH", "DAYOFWEEK", "WEEKDAY", "WEEKEND",
                "IS_AWAKE", "IS_BUSY_HOURS")


class TimeSequenceFeatureTransformer:
    """Feature transformer for TimeSequencePredictor."""

    def __init__(self, future_seq_len: int = 1, dt_col: str = "datetime",
                 target_col: str = "value",
                 extra_features_col: Optional[Sequence[str]] = None,
                 drop_missing: bool = True):
        self.future_seq_len = future_seq_len
        self.dt_col = dt_col
        self.target_col = target_col
        self.extra_features_col = list(extra_features_col or [])
        self.drop_missing = drop_missing
        # fitted state
        self.scale_min: Optional[np.ndarray] = None
        self.scale_max: Optional[np.ndarray] = None
        self.config: Dict = {}

    # -- feature generation ------------------------------------------------
    def get_feature_list(self, input_df: pd.DataFrame) -> List[str]:
        """All candidate feature names the search can select from."""
        return [f"{f}({self.dt_col})" for f in _DT_FEATURES] + \
            list(self.extra_features_col)

    def _gen_calendar(self, dt: pd.Series) -> pd.DataFrame:
        import pandas as pd

        dt = pd.to_datetime(dt)
        hour = dt.dt.hour
        out = {
            f"HOUR({self.dt_col})": hour,
            f"DAY({self.dt_col})": dt.dt.day,
            f"MONTH({self.dt_col})": dt.dt.month,
            f"DAYOFWEEK({self.dt_col})": dt.dt.dayofweek,
            f"WEEKDAY({self.dt_col})": (dt.dt.dayofweek < 5).astype(int),
            f"WEEKEND({self.dt_col})": (dt.dt.dayofweek >= 5).astype(int),
            f"IS_AWAKE({self.dt_col})": ((hour >= 6) & (hour <= 23))
            .astype(int),
            f"IS_BUSY_HOURS({self.dt_col})": hour.isin(
                [7, 8, 9, 17, 18, 19]).astype(int),
        }
        return pd.DataFrame(out)

    def _feature_frame(self, input_df: pd.DataFrame,
                       selected: Sequence[str]) -> np.ndarray:
        """(target, selected features...) matrix in time order."""
        import pandas as pd

        df = input_df
        if self.drop_missing:
            df = df.dropna(subset=[self.dt_col, self.target_col])
        cal = self._gen_calendar(df[self.dt_col]).reset_index(drop=True)
        cols = [df[self.target_col].reset_index(drop=True).rename("__y")]
        for name in selected:
            if name in cal.columns:
                cols.append(cal[name])
            elif name in df.columns:
                cols.append(df[name].reset_index(drop=True))
            else:
                raise ValueError(f"unknown feature {name!r}")
        return pd.concat(cols, axis=1).to_numpy(np.float32)

    # -- scaling (fit on train, reuse at test) -----------------------------
    def _fit_scale(self, mat: np.ndarray) -> np.ndarray:
        self.scale_min = mat.min(axis=0)
        self.scale_max = mat.max(axis=0)
        return self._scale(mat)

    def _scale(self, mat: np.ndarray) -> np.ndarray:
        span = np.where(self.scale_max - self.scale_min == 0, 1.0,
                        self.scale_max - self.scale_min)
        return (mat - self.scale_min) / span

    def _unscale_y(self, y: np.ndarray) -> np.ndarray:
        span = (self.scale_max[0] - self.scale_min[0]) or 1.0
        return y * span + self.scale_min[0]

    # -- rolling -----------------------------------------------------------
    @staticmethod
    def _roll(mat: np.ndarray, past: int, future: int
              ) -> Tuple[np.ndarray, np.ndarray]:
        n = mat.shape[0] - past - future + 1
        if n <= 0:
            raise ValueError(
                f"series too short: {mat.shape[0]} rows for "
                f"past={past} + future={future}")
        idx = np.arange(past)[None, :] + np.arange(n)[:, None]
        x = mat[idx]                                    # (n, past, F)
        yi = past + np.arange(future)[None, :] + np.arange(n)[:, None]
        y = mat[yi, 0]                                  # (n, future)
        return x, y

    # -- public API --------------------------------------------------------
    def fit_transform(self, input_df: pd.DataFrame, **config
                      ) -> Tuple[np.ndarray, np.ndarray]:
        self.config = dict(config)
        selected = config.get("selected_features",
                              self.get_feature_list(input_df))
        # persist the RESOLVED selection: save/load must rebuild the
        # exact input width even when the recipe omitted the key
        self.config["selected_features"] = list(selected)
        past = int(config.get("past_seq_len", 2))
        mat = self._feature_frame(input_df, selected)
        mat = self._fit_scale(mat)
        return self._roll(mat, past, self.future_seq_len)

    def transform(self, input_df: pd.DataFrame, is_train: bool = False
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if self.scale_min is None:
            raise RuntimeError("fit_transform first")
        selected = self.config.get("selected_features",
                                   self.get_feature_list(input_df))
        past = int(self.config.get("past_seq_len", 2))
        mat = self._scale(self._feature_frame(input_df, selected))
        if is_train:
            return self._roll(mat, past, self.future_seq_len)
        # Test mode: EVERY window of length `past`, including the final
        # one whose forecast lies beyond the frame — predict() must be
        # able to forecast the actual future, not just in-frame steps.
        n = mat.shape[0] - past + 1
        if n <= 0:
            raise ValueError("series shorter than past_seq_len")
        idx = np.arange(past)[None, :] + np.arange(n)[:, None]
        return mat[idx], None

    def post_processing(self, input_df: pd.DataFrame, y_pred: np.ndarray,
                        is_train: bool = False):
        """Unscale predictions; for test mode attach the datetime of the
        FORECAST TARGET step — window i covers rows [i, i+past) and
        predicts row i+past, so its stamp is dt[i+past], extrapolated by
        the series period when the target lies beyond the frame
        (reference post_processing :230)."""
        y = self._unscale_y(np.asarray(y_pred))
        if is_train:
            return y
        import pandas as pd

        past = int(self.config.get("past_seq_len", 2))
        dt = pd.to_datetime(input_df[self.dt_col]).reset_index(drop=True)
        dt_vals = dt.to_numpy()
        step = (dt_vals[-1] - dt_vals[-2]) if len(dt_vals) > 1 else \
            np.timedelta64(0, "s")
        idx = past + np.arange(len(y))
        stamps = np.asarray(
            [dt_vals[i] if i < len(dt_vals)
             else dt_vals[-1] + (i - len(dt_vals) + 1) * step for i in idx])
        out = {self.dt_col: stamps}
        for k in range(y.shape[1] if y.ndim > 1 else 1):
            col = y[:, k] if y.ndim > 1 else y
            out[f"{self.target_col}_{k}" if
                (y.ndim > 1 and y.shape[1] > 1) else self.target_col] = col
        return pd.DataFrame(out)

    # -- persistence -------------------------------------------------------
    def save(self, file_path: str) -> None:
        blob = {"future_seq_len": self.future_seq_len,
                "dt_col": self.dt_col, "target_col": self.target_col,
                "extra_features_col": self.extra_features_col,
                "drop_missing": self.drop_missing,
                "config": {k: (list(v) if isinstance(v, (list, tuple))
                               else v) for k, v in self.config.items()},
                "scale_min": (self.scale_min.tolist()
                              if self.scale_min is not None else None),
                "scale_max": (self.scale_max.tolist()
                              if self.scale_max is not None else None)}
        with open(file_path, "w") as f:
            json.dump(blob, f)

    @classmethod
    def load(cls, file_path: str) -> "TimeSequenceFeatureTransformer":
        with open(file_path) as f:
            blob = json.load(f)
        ft = cls(future_seq_len=blob["future_seq_len"],
                 dt_col=blob["dt_col"], target_col=blob["target_col"],
                 extra_features_col=blob["extra_features_col"],
                 drop_missing=blob["drop_missing"])
        ft.config = blob["config"]
        if blob["scale_min"] is not None:
            ft.scale_min = np.asarray(blob["scale_min"], np.float32)
            ft.scale_max = np.asarray(blob["scale_max"], np.float32)
        return ft

    restore = load
