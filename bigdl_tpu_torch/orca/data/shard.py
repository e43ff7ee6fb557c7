"""XShards — the port of ``bigdl_tpu/orca/data/shard.py`` (ref:
P:orca/data/shard.py — SparkXShards: an RDD of dict-of-numpy partitions
with transform_shard/repartition/collect).

A shard list lives in the driver process; its partitions are merged and
fed to the mesh's ``data`` axis at fit time (the reference pins
partitions to Spark executors). ``pandas`` is imported only by the
readers."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Union

import numpy as np


class XShards:
    """List of partitions; each partition is a dict of numpy arrays,
    a pandas DataFrame, or an arbitrary python object."""

    def __init__(self, partitions: List[Any]):
        self._parts = list(partitions)

    # -- construction --------------------------------------------------------
    @staticmethod
    def partition(data: Union[Dict[str, np.ndarray], np.ndarray, tuple],
                  num_shards: int = 4) -> "XShards":
        """ref: XShards.partition — split dict-of-numpy along dim 0."""
        def split(arr):
            return np.array_split(np.asarray(arr), num_shards)

        if isinstance(data, dict):
            pieces = {k: split(v) for k, v in data.items()}
            parts = [{k: pieces[k][i] for k in data}
                     for i in range(num_shards)]
        elif isinstance(data, tuple):
            cols = [split(v) for v in data]
            parts = [tuple(c[i] for c in cols) for i in range(num_shards)]
        else:
            parts = split(data)
        return XShards(parts)

    # -- transformations -----------------------------------------------------
    def transform_shard(self, fn: Callable, *args) -> "XShards":
        return XShards([fn(p, *args) for p in self._parts])

    def repartition(self, num_partitions: int) -> "XShards":
        """Best effort: re-split dict-of-numpy / array shards evenly."""
        first = self._parts[0]
        if isinstance(first, dict):
            merged = {k: np.concatenate([np.asarray(p[k])
                                         for p in self._parts])
                      for k in first}
            return XShards.partition(merged, num_partitions)
        merged = np.concatenate([np.asarray(p) for p in self._parts])
        return XShards.partition(merged, num_partitions)

    # -- access --------------------------------------------------------------
    def collect(self) -> List[Any]:
        return list(self._parts)

    def num_partitions(self) -> int:
        return len(self._parts)

    def __len__(self):
        return len(self._parts)

    def merged(self):
        """Concatenate all partitions (driver-side)."""
        first = self._parts[0]
        if isinstance(first, dict):
            return {k: np.concatenate([np.asarray(p[k])
                                       for p in self._parts])
                    for k in first}
        if isinstance(first, tuple):
            n = len(first)
            return tuple(np.concatenate([np.asarray(p[i])
                                         for p in self._parts])
                         for i in range(n))
        return np.concatenate([np.asarray(p) for p in self._parts])


def read_csv(path: str, num_shards: int = 4, **kwargs) -> XShards:
    """ref: orca.data.pandas.read_csv → shards of DataFrames."""
    import glob

    import pandas as pd

    files = sorted(glob.glob(path)) or [path]
    dfs = [pd.read_csv(f, **kwargs) for f in files]
    df = pd.concat(dfs, ignore_index=True)
    return XShards(_split_df(df, num_shards))


def read_parquet(path: str, num_shards: int = 4, **kwargs) -> XShards:
    import glob

    import pandas as pd

    files = sorted(glob.glob(path)) or [path]
    df = pd.concat([pd.read_parquet(f, **kwargs) for f in files],
                   ignore_index=True)
    return XShards(_split_df(df, num_shards))


def _split_df(df, num_shards: int):
    """Row-range split (np.array_split on a DataFrame coerces to ndarray
    on pandas 3.x)."""
    bounds = np.linspace(0, len(df), num_shards + 1, dtype=int)
    return [df.iloc[a:b].reset_index(drop=True)
            for a, b in zip(bounds[:-1], bounds[1:])]
