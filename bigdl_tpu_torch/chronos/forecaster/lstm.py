"""LSTMForecaster — the port of ``bigdl_tpu/chronos/forecaster/lstm.py``
(ref: P:chronos/forecaster/lstm_forecaster.py — stacked LSTM over the
lookback window, linear head on the final state). ``Recurrent`` is a
Python loop over the cell's step in the port."""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.chronos.forecaster.base import BaseForecaster


class LSTMForecaster(BaseForecaster):
    def __init__(self, past_seq_len: int, input_feature_num: int,
                 output_feature_num: int, hidden_dim: int = 32,
                 layer_num: int = 1, dropout: float = 0.1,
                 lr: float = 1e-3, loss: str = "mse", seed: int = 0,
                 future_seq_len: int = 1, device=None):
        self.hidden_dim = hidden_dim
        self.layer_num = layer_num
        self.dropout = dropout
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, lr, loss, seed, device)

    def _build_model(self) -> nn.Module:
        model = nn.Sequential()
        d = self.input_feature_num
        for i in range(self.layer_num):
            last = i == self.layer_num - 1
            model.add(nn.Recurrent(nn.LSTM(d, self.hidden_dim),
                                   return_sequences=not last))
            if self.dropout > 0 and not last:
                model.add(nn.Dropout(self.dropout))
            d = self.hidden_dim
        out_dim = self.future_seq_len * self.output_feature_num
        return (model
                .add(nn.Linear(self.hidden_dim, out_dim))
                .add(nn.Reshape([self.future_seq_len,
                                 self.output_feature_num])))
