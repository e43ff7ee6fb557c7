"""AutoTSEstimator — the port of ``bigdl_tpu/chronos/autots/auto_ts.py``
(ref: P:chronos/autots — HPO over forecaster family, lookback and
hyperparams via orca.automl; returns a TSPipeline). The lookback and
config draws are the JAX package's (one ``random.Random(seed)``); the
forecasters are the port's, on ``device`` (``None``: the GPU)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from bigdl_tpu_torch.chronos.data import TSDataset
from bigdl_tpu_torch.orca.automl.hp import _Space, hp, sample_config


_MODEL_BUILDERS = {}


def _builders():
    if not _MODEL_BUILDERS:
        from bigdl_tpu_torch.chronos.forecaster import (
            LSTMForecaster, Seq2SeqForecaster, TCNForecaster)
        _MODEL_BUILDERS.update(
            tcn=TCNForecaster, seq2seq=Seq2SeqForecaster,
            lstm=LSTMForecaster)
    return _MODEL_BUILDERS


class TSPipeline:
    """Fitted forecaster + the preprocessing recipe (ref: TSPipeline)."""

    def __init__(self, forecaster, lookback: int, horizon: int):
        self.forecaster = forecaster
        self.lookback = lookback
        self.horizon = horizon

    def _roll(self, ts: TSDataset):
        return ts.roll(self.lookback, self.horizon).to_numpy()

    def predict(self, data: Union[TSDataset, np.ndarray]):
        x = self._roll(data)[0] if isinstance(data, TSDataset) else data
        return self.forecaster.predict(x)

    def evaluate(self, data: Union[TSDataset, tuple], metrics=("mse",)):
        xy = self._roll(data) if isinstance(data, TSDataset) else data
        return self.forecaster.evaluate(xy, metrics=metrics)

    def fit(self, data: Union[TSDataset, tuple], epochs: int = 1,
            batch_size: int = 32):
        xy = self._roll(data) if isinstance(data, TSDataset) else data
        self.forecaster.fit(xy, epochs=epochs, batch_size=batch_size)
        return self


class AutoTSEstimator:
    """ref args kept: model (tcn/seq2seq/lstm), search_space with
    hp.choice/... , past_seq_len possibly a search space."""

    def __init__(self, model: str = "tcn",
                 search_space: Optional[dict] = None,
                 past_seq_len: Union[int, _Space] = 24,
                 future_seq_len: int = 1,
                 input_feature_num: Optional[int] = None,
                 output_target_num: int = 1,
                 metric: str = "mse", device=None):
        self.model = model
        self.search_space = search_space or {}
        self.past_seq_len = past_seq_len
        self.future_seq_len = future_seq_len
        self.input_feature_num = input_feature_num
        self.output_target_num = output_target_num
        self.metric = metric
        self.device = device
        self._best: Optional[TSPipeline] = None

    def fit(self, data: TSDataset, validation_data: Optional[TSDataset]
            = None, n_sampling: int = 4, epochs: int = 3,
            batch_size: int = 32, seed: int = 0) -> TSPipeline:
        import random

        rng = random.Random(seed)
        builder_cls = _builders()[self.model]
        in_feats = self.input_feature_num or data.get_feature_num()
        best_score, best_pipe = None, None
        for _ in range(n_sampling):
            lookback = self.past_seq_len.sample(rng) \
                if isinstance(self.past_seq_len, _Space) \
                else self.past_seq_len
            cfg = sample_config(self.search_space, rng)
            kwargs = dict(past_seq_len=int(lookback),
                          future_seq_len=self.future_seq_len,
                          input_feature_num=in_feats,
                          output_feature_num=self.output_target_num,
                          device=self.device)
            kwargs.update(cfg)
            forecaster = builder_cls(**kwargs)
            x, y = data.roll(int(lookback), self.future_seq_len).to_numpy()
            forecaster.fit((x, y), epochs=epochs, batch_size=batch_size)
            if validation_data is not None:
                vx, vy = validation_data.roll(
                    int(lookback), self.future_seq_len).to_numpy()
            else:
                vx, vy = x, y
            score = forecaster.evaluate((vx, vy),
                                        metrics=[self.metric])[0]
            if best_score is None or score < best_score:
                best_score = score
                best_pipe = TSPipeline(forecaster, int(lookback),
                                       self.future_seq_len)
        self._best = best_pipe
        return best_pipe

    def get_best_model(self):
        return self._best.forecaster if self._best else None
