"""TSDataset — the port of ``bigdl_tpu/chronos/data/tsdataset.py`` (ref:
P:chronos/data/tsdataset.py — the time-series container: impute,
resample, roll into (lookback, horizon) windows, scale, feature
generation).

The container holds no JAX, so its verbs are the JAX package's, over
pandas (imported when a frame is made or read, as
``orca/data/shard.py``'s readers do). :func:`roll_windows` is the
windowing itself in numpy: one series' windows are strided views of its
value array (no copy), which :meth:`TSDataset.roll` returns for a
single-id frame and concatenates for several ids. At ECL's size (321
series, 26,304 steps, lookback and horizon 96) a copy would be 3.2 GB
for each of x and y.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


def _as_list(x) -> List[str]:
    if x is None:
        return []
    return [x] if isinstance(x, str) else list(x)


def _horizons(horizon: Union[int, Sequence[int]]) -> List[int]:
    return list(range(1, horizon + 1)) if isinstance(horizon, int) \
        else list(horizon)


def roll_windows(values: np.ndarray, targets: np.ndarray, lookback: int,
                 horizon: Union[int, Sequence[int]]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One series' supervised windows: ``x[i] = values[i:i + lookback]``
    (N, lookback, C) and ``y[i, j] = targets[i + lookback + h_j - 1]``
    (N, len(horizons), T), N = len - lookback - max(h) + 1. ``x`` is a
    read-only strided view of ``values``; ``y`` is one of ``targets``
    when the horizons are 1..H (an int), else a gathered copy. The
    arrays are used as given (``roll`` passes f32)."""
    horizons = _horizons(horizon)
    h_max = max(horizons) if horizons else 0
    n = max(len(values) - lookback - h_max + 1, 0)
    if n == 0:
        return (np.zeros((0, lookback, values.shape[1]), values.dtype),
                np.zeros((0, len(horizons), targets.shape[1]),
                         targets.dtype))
    win = np.lib.stride_tricks.sliding_window_view
    x = win(values, lookback, axis=0)[:n].transpose(0, 2, 1)
    if not horizons:
        y = np.zeros((n, 0, targets.shape[1]), targets.dtype)
    elif horizons == list(range(1, h_max + 1)):
        y = win(targets[lookback:], h_max, axis=0)[:n].transpose(0, 2, 1)
    else:
        idx = (np.arange(n)[:, None] + lookback
               + np.asarray(horizons)[None, :] - 1)
        y = targets[idx]
    return x, y


class TSDataset:
    """Single- or multi-id time series over a pandas frame.

    Usage mirrors the reference::

        ts = TSDataset.from_pandas(df, dt_col="dt", target_col="value",
                                   extra_feature_col=["f1"], id_col="id")
        ts.impute("last").scale(scaler).roll(lookback=24, horizon=4)
        x, y = ts.to_numpy()
    """

    def __init__(self, df, dt_col: str, target_cols: List[str],
                 feature_cols: List[str], id_col: Optional[str]):
        self.df = df
        self.dt_col = dt_col
        self.target_cols = target_cols
        self.feature_cols = feature_cols
        self.id_col = id_col
        self.lookback: Optional[int] = None
        self.horizon: Optional[int] = None
        self._rolled: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.scaler = None

    # -- construction --------------------------------------------------------
    @classmethod
    def from_pandas(cls, df, dt_col: str,
                    target_col: Union[str, Sequence[str]],
                    extra_feature_col: Union[str, Sequence[str], None] = None,
                    id_col: Optional[str] = None,
                    with_split: bool = False, val_ratio: float = 0.1,
                    test_ratio: float = 0.1):
        """ref: TSDataset.from_pandas (+ train/val/test split variant)."""
        targets = _as_list(target_col)
        feats = _as_list(extra_feature_col)
        df = df.copy()
        df = df.sort_values([c for c in (id_col, dt_col) if c])
        if not with_split:
            return cls(df, dt_col, targets, feats, id_col)

        out = []
        n = len(df)
        n_test = int(n * test_ratio)
        n_val = int(n * val_ratio)
        n_train = n - n_val - n_test
        for sub in (df.iloc[:n_train], df.iloc[n_train:n_train + n_val],
                    df.iloc[n_train + n_val:]):
            out.append(cls(sub.reset_index(drop=True), dt_col, targets,
                           feats, id_col))
        return tuple(out)

    @property
    def _value_cols(self) -> List[str]:
        return self.target_cols + self.feature_cols

    def _groups(self):
        if self.id_col:
            for _, g in self.df.groupby(self.id_col, sort=False):
                yield g
        else:
            yield self.df

    # -- cleaning ------------------------------------------------------------
    def impute(self, mode: str = "last", const_num: float = 0.0):
        """ref: impute modes last | const | linear."""
        cols = self._value_cols
        if mode == "last":
            self.df[cols] = self.df[cols].ffill().bfill()
        elif mode == "const":
            self.df[cols] = self.df[cols].fillna(const_num)
        elif mode == "linear":
            self.df[cols] = self.df[cols].interpolate(
                method="linear", limit_direction="both")
        else:
            raise ValueError(f"unknown impute mode {mode!r}")
        return self

    def deduplicate(self):
        keys = [c for c in (self.id_col, self.dt_col) if c]
        self.df = self.df.drop_duplicates(subset=keys, keep="last") \
            .reset_index(drop=True)
        return self

    def resample(self, interval: str, merge_mode: str = "mean"):
        """ref: resample to a fixed interval per id."""
        import pandas as pd

        def _one(g):
            g = g.set_index(self.dt_col)
            r = g[self._value_cols].resample(interval)
            out = getattr(r, merge_mode)()
            if self.id_col:
                out[self.id_col] = g[self.id_col].iloc[0]
            return out.reset_index()

        self.df = pd.concat([_one(g) for g in self._groups()],
                            ignore_index=True)
        return self

    # -- scaling -------------------------------------------------------------
    def scale(self, scaler=None, fit: bool = True):
        """scaler: sklearn-style (fit/transform) or None → StandardScaler."""
        if scaler is None:
            from sklearn.preprocessing import StandardScaler
            scaler = StandardScaler()
        cols = self._value_cols
        vals = self.df[cols].to_numpy(np.float64)
        if fit:
            scaler.fit(vals)
        self.df[cols] = scaler.transform(vals)
        self.scaler = scaler
        return self

    def unscale(self):
        cols = self._value_cols
        self.df[cols] = self.scaler.inverse_transform(
            self.df[cols].to_numpy(np.float64))
        return self

    def unscale_numpy(self, y: np.ndarray) -> np.ndarray:
        """Unscale a rolled prediction (B, horizon, n_targets) (ref:
        unscale_numpy — uses the target columns' slice of the scaler)."""
        mean = getattr(self.scaler, "mean_", None)
        stds = getattr(self.scaler, "scale_", None)
        nt = len(self.target_cols)
        if mean is None:
            raise RuntimeError("scale() with a StandardScaler first")
        return y * stds[:nt] + mean[:nt]

    # -- feature generation ---------------------------------------------------
    def gen_dt_feature(self, features: Sequence[str] = ("HOUR", "DAY",
                                                        "WEEKDAY")):
        """ref: gen_dt_feature — calendar features from dt_col."""
        import pandas as pd

        dt = pd.to_datetime(self.df[self.dt_col])
        gens = {
            "HOUR": dt.dt.hour, "DAY": dt.dt.day, "MONTH": dt.dt.month,
            "WEEKDAY": dt.dt.weekday, "MINUTE": dt.dt.minute,
            "DAYOFYEAR": dt.dt.dayofyear,
            "WEEKOFYEAR": dt.dt.isocalendar().week.astype(np.int64),
            "IS_WEEKEND": (dt.dt.weekday >= 5).astype(np.int64),
        }
        for f in features:
            if f not in gens:
                raise ValueError(f"unknown dt feature {f!r}")
            name = f"{f}({self.dt_col})"
            self.df[name] = np.asarray(gens[f])
            if name not in self.feature_cols:
                self.feature_cols.append(name)
        return self

    # -- rolling --------------------------------------------------------------
    def roll(self, lookback: int, horizon: Union[int, Sequence[int]],
             feature_col: Optional[Sequence[str]] = None,
             target_col: Optional[Sequence[str]] = None):
        """Window into supervised (x, y) pairs:
        x (N, lookback, n_targets+n_feats); y (N, horizon, n_targets).
        Each id's windows come from :func:`roll_windows`; several ids'
        are concatenated in group order."""
        feats = self.feature_cols if feature_col is None \
            else _as_list(feature_col)
        targets = self.target_cols if target_col is None \
            else _as_list(target_col)
        parts = [roll_windows(g[targets + feats].to_numpy(np.float32),
                              g[targets].to_numpy(np.float32), lookback,
                              horizon)
                 for g in self._groups()]
        if len(parts) == 1:
            x, y = parts[0]
        else:
            x = np.concatenate([p[0] for p in parts])
            y = np.concatenate([p[1] for p in parts])
        self.lookback, self.horizon = lookback, len(_horizons(horizon))
        self._rolled = (x, y)
        return self

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._rolled is None:
            raise RuntimeError("call roll(lookback, horizon) first")
        return self._rolled

    def to_pandas(self):
        return self.df.copy()

    def get_feature_num(self) -> int:
        return len(self._value_cols)

    def get_target_num(self) -> int:
        return len(self.target_cols)
