"""Seq2SeqForecaster — the port of
``bigdl_tpu/chronos/forecaster/seq2seq.py`` (ref:
P:chronos/forecaster/seq2seq_forecaster.py — LSTM encoder-decoder;
BASELINE config 3)."""

from __future__ import annotations

from typing import Optional

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.chronos.forecaster.base import BaseForecaster
from bigdl_tpu_torch.nn.module import TensorModule


class _Seq2Seq(TensorModule):
    """Encoder LSTM → repeat last hidden state over horizon → decoder LSTM
    → per-step linear head (the reference's VanillaSeq2Seq shape)."""

    def __init__(self, in_dim: int, hidden: int, layers: int,
                 horizon: int, out_dim: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.horizon = horizon
        enc = nn.Sequential()
        d = in_dim
        for i in range(layers):
            enc.add(nn.Recurrent(nn.LSTM(d, hidden),
                                 return_sequences=(i < layers - 1)))
            d = hidden
        self.encoder = enc
        self.repeat = nn.Replicate(horizon, dim=2)
        dec = nn.Sequential()
        for _ in range(layers):
            dec.add(nn.Recurrent(nn.LSTM(hidden, hidden),
                                 return_sequences=True))
        self.decoder = dec
        self.head = nn.Linear(hidden, out_dim)

    def forward(self, x):
        h = self.encoder(x)                  # (B, H)
        return self.head(self.decoder(self.repeat(h)))   # (B, T, out)


class Seq2SeqForecaster(BaseForecaster):
    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_feature_num: int, output_feature_num: int,
                 lstm_hidden_dim: int = 64, lstm_layer_num: int = 1,
                 lr: float = 1e-3, loss: str = "mse", seed: int = 0,
                 device=None):
        self.lstm_hidden_dim = lstm_hidden_dim
        self.lstm_layer_num = lstm_layer_num
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, lr, loss, seed, device)

    def _build_model(self) -> nn.Module:
        return _Seq2Seq(self.input_feature_num, self.lstm_hidden_dim,
                        self.lstm_layer_num, self.future_seq_len,
                        self.output_feature_num)
