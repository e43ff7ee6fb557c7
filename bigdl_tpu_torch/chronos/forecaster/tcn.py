"""TCNForecaster — the port of ``bigdl_tpu/chronos/forecaster/tcn.py``
(ref: P:chronos/forecaster/tcn_forecaster.py over the pytorch TCN in
P:chronos/model/tcn.py — causal dilated conv stacks with residual
connections; BASELINE config 3)."""

from __future__ import annotations

from typing import Sequence

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.chronos.forecaster.base import BaseForecaster


def _causal_block(c_in: int, c_out: int, kernel: int, dilation: int,
                  seq_len: int, dropout: float) -> nn.Module:
    """Conv(pad both sides) → chomp tail → relu → dropout, twice, with a
    1x1-projected residual (the reference TCN TemporalBlock)."""
    pad = (kernel - 1) * dilation
    path = nn.Sequential()
    for i in range(2):
        path.add(nn.TemporalConvolution(c_in if i == 0 else c_out, c_out,
                                        kernel, 1, pad=pad,
                                        dilation=dilation))
        # chomp: keep the first seq_len frames (causal)
        path.add(nn.Narrow(2, 1, seq_len))
        path.add(nn.ReLU())
        if dropout > 0:
            path.add(nn.Dropout(dropout))
    shortcut = nn.Identity() if c_in == c_out else \
        nn.TemporalConvolution(c_in, c_out, 1)
    return (nn.Sequential()
            .add(nn.ConcatTable().add(path).add(shortcut))
            .add(nn.CAddTable())
            .add(nn.ReLU()))


class TCNForecaster(BaseForecaster):
    """ref args: past_seq_len, future_seq_len, input_feature_num,
    output_feature_num, num_channels, kernel_size, dropout, lr. Block i
    dilates by 2^i."""

    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_feature_num: int, output_feature_num: int,
                 num_channels: Sequence[int] = (30, 30),
                 kernel_size: int = 3, dropout: float = 0.1,
                 lr: float = 1e-3, loss: str = "mse", seed: int = 0,
                 device=None):
        self.num_channels = list(num_channels)
        self.kernel_size = kernel_size
        self.dropout = dropout
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, lr, loss, seed, device)

    def _build_model(self) -> nn.Module:
        model = nn.Sequential()
        c_in = self.input_feature_num
        for i, c_out in enumerate(self.num_channels):
            model.add(_causal_block(c_in, c_out, self.kernel_size, 2 ** i,
                                    self.past_seq_len, self.dropout))
            c_in = c_out
        # head: flatten time×channels → horizon × targets (ref projects the
        # last-level features through a linear decoder)
        out_dim = self.future_seq_len * self.output_feature_num
        return (model
                .add(nn.Flatten())
                .add(nn.Linear(c_in * self.past_seq_len, out_dim))
                .add(nn.Reshape([self.future_seq_len,
                                 self.output_feature_num])))
