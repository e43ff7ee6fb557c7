"""Data layer — the port of ``bigdl_tpu/feature/dataset.py`` (ref:
.../feature/dataset/DataSet.scala, Sample.scala, MiniBatch.scala,
SampleToMiniBatch): host-side numpy, so both packages draw the same
batches — ``LocalDataSet`` shuffles with ``np.random.RandomState(seed)``
each epoch, as the JAX one does. The optimizer places each batch on the
device.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


class Sample:
    """(features, label) record (ref: Sample.scala / TensorSample)."""

    __slots__ = ("features", "labels")

    def __init__(self, features, labels=None):
        self.features = [np.asarray(f) for f in (
            features if isinstance(features, (list, tuple)) else [features])]
        if labels is None:
            self.labels = []
        else:
            self.labels = [np.asarray(l) for l in (
                labels if isinstance(labels, (list, tuple)) else [labels])]

    @staticmethod
    def from_ndarray(features, labels=None) -> "Sample":
        return Sample(features, labels)

    def feature(self, i: int = 0):
        return self.features[i]

    def label(self, i: int = 0):
        return self.labels[i] if self.labels else None


class MiniBatch:
    """Batched (input, target) pair (ref: MiniBatch.scala)."""

    __slots__ = ("input", "target")

    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    def size(self) -> int:
        arr = self.input[0] if isinstance(self.input, (list, tuple)) \
            else self.input
        return arr.shape[0]

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target


def _stack_samples(samples: Sequence[Sample], pad: bool = False) -> MiniBatch:
    n_feat = len(samples[0].features)
    n_lab = len(samples[0].labels)

    def stack(arrs: List[np.ndarray]) -> np.ndarray:
        if pad:
            # pad to the max shape in the batch (ref: PaddingParam)
            max_shape = np.max([a.shape for a in arrs], axis=0)
            out = np.zeros((len(arrs),) + tuple(max_shape), arrs[0].dtype)
            for i, a in enumerate(arrs):
                sl = (i,) + tuple(slice(0, s) for s in a.shape)
                out[sl] = a
            return out
        return np.stack(arrs)

    feats = [stack([s.features[i] for s in samples]) for i in range(n_feat)]
    labs = [stack([s.labels[i] for s in samples]) for i in range(n_lab)]
    inp = feats[0] if n_feat == 1 else feats
    tgt = (labs[0] if n_lab == 1 else labs) if n_lab else None
    return MiniBatch(inp, tgt)


class AbstractDataSet:
    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self):
        return self

    def data(self, train: bool = True) -> Iterator:
        raise NotImplementedError

    def transform(self, transformer) -> "AbstractDataSet":
        return _TransformedDataSet(self, transformer)

    def prefetch(self, depth: int = 8) -> "AbstractDataSet":
        return PrefetchDataSet(self, depth)

    # sugar matching the reference's `dataset -> transformer` composition
    def __rshift__(self, transformer):
        return self.transform(transformer)


class LocalDataSet(AbstractDataSet):
    """In-memory dataset of Samples or raw arrays (ref: LocalArrayDataSet)."""

    def __init__(self, x, y: Optional[np.ndarray] = None, shuffle: bool = True,
                 seed: int = 0):
        if isinstance(x, (list, tuple)) and x and isinstance(x[0], Sample):
            self.samples = list(x)
            self._array_mode = False
        else:
            self.x = np.asarray(x)
            self.y = None if y is None else np.asarray(y)
            self._array_mode = True
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def size(self) -> int:
        return len(self.samples) if not self._array_mode else self.x.shape[0]

    def data(self, train: bool = True):
        n = self.size()
        order = np.arange(n)
        if train and self._shuffle:
            self._rng.shuffle(order)
        if self._array_mode:
            for i in order:
                yield Sample(self.x[i],
                             None if self.y is None else self.y[i])
        else:
            for i in order:
                yield self.samples[i]


class DistributedDataSet(LocalDataSet):
    """Rank-sharded dataset (ref: CachedDistriDataSet): each rank sees
    samples ``[rank::world]`` of the shuffled order. ``rank`` and
    ``world`` not given come from the process group (the Engine's), or
    are 0 and 1 in a process without one, as ``jax.process_index`` and
    ``process_count`` are before any distributed init."""

    def __init__(self, x, y=None, shuffle: bool = True, seed: int = 0,
                 rank: Optional[int] = None, world: Optional[int] = None):
        super().__init__(x, y, shuffle, seed)
        if rank is None or world is None:
            import torch.distributed as dist
            live = dist.is_initialized()
            rank = dist.get_rank() if live else 0
            world = dist.get_world_size() if live else 1
        self.rank, self.world = rank, world

    def data(self, train: bool = True):
        for i, s in enumerate(super().data(train)):
            if i % self.world == self.rank:
                yield s


class _TransformedDataSet(AbstractDataSet):
    def __init__(self, parent: AbstractDataSet, transformer):
        self.parent = parent
        self.transformer = transformer

    def size(self):
        return self.parent.size()

    def data(self, train: bool = True):
        return self.transformer(self.parent.data(train))


class PrefetchDataSet(AbstractDataSet):
    """Background-thread prefetch: host-side decode/augment overlaps the
    device step, so the Optimizer's per-iteration data timer shows only
    queue-pop latency (the role of the reference's multi-threaded
    transformer iterators over Spark partitions)."""

    def __init__(self, parent: AbstractDataSet, depth: int = 8):
        self.parent = parent
        self.depth = depth

    def size(self):
        return self.parent.size()

    def data(self, train: bool = True):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        _END = object()
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up when the consumer is gone, so an
            # abandoned iterator (early break / trigger fire) cannot leave
            # the producer blocked forever on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for s in self.parent.data(train):
                    if not put(s):
                        return
                put(_END)
            except BaseException as e:  # surface errors on the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # retire the producer: put() gives up within its 0.1 s
            # poll once stop is set, so this never hangs the consumer
            t.join(timeout=5.0)


class SampleToMiniBatch:
    """Transformer: iterator[Sample] → iterator[MiniBatch]
    (ref: SampleToMiniBatch.scala)."""

    def __init__(self, batch_size: int, drop_remainder: bool = True,
                 pad: bool = False):
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.pad = pad

    def __call__(self, it: Iterator[Sample]) -> Iterator[MiniBatch]:
        buf: List[Sample] = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield _stack_samples(buf, self.pad)
                buf = []
        if buf and not self.drop_remainder:
            yield _stack_samples(buf, self.pad)


class DataSet:
    """Factory facade (ref: DataSet object)."""

    @staticmethod
    def array(x, y=None, shuffle: bool = True, seed: int = 0) -> LocalDataSet:
        return LocalDataSet(x, y, shuffle, seed)

    @staticmethod
    def distributed(x, y=None, shuffle: bool = True, seed: int = 0,
                    rank=None, world=None) -> DistributedDataSet:
        return DistributedDataSet(x, y, shuffle, seed, rank, world)
