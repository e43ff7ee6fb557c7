"""NBeatsForecaster — the port of ``bigdl_tpu/chronos/forecaster/nbeats.py``
(ref: P:chronos/forecaster/nbeats_forecaster.py — N-BEATS generic
stacks: fully-connected blocks emitting backcast + forecast,
residual-subtracted backcasts, summed forecasts).

Univariate only, as in the reference (input_feature_num must be 1).
The blocks sit under the JAX module's keys (``block{i}``, ``fc``,
``backcast_head``, ``forecast_head``), so ``load_parameters_dict``
carries its tree.
"""

from __future__ import annotations

from typing import Optional

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.chronos.forecaster.base import BaseForecaster
from bigdl_tpu_torch.nn.module import TensorModule


class _NBeatsBlock(TensorModule):
    def __init__(self, lookback: int, horizon: int, units: int,
                 layers: int = 4, name: Optional[str] = None):
        super().__init__(name)
        stack = nn.Sequential()
        d = lookback
        for _ in range(layers):
            stack.add(nn.Linear(d, units)).add(nn.ReLU())
            d = units
        self.fc = stack
        self.backcast_head = nn.Linear(units, lookback)
        self.forecast_head = nn.Linear(units, horizon)

    def forward(self, x):
        h = self.fc(x)
        return [self.backcast_head(h), self.forecast_head(h)]


class _NBeats(TensorModule):
    def __init__(self, lookback: int, horizon: int, units: int = 64,
                 num_blocks: int = 3, name: Optional[str] = None):
        super().__init__(name)
        self.lookback, self.horizon = lookback, horizon
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            setattr(self, f"block{i}",
                    _NBeatsBlock(lookback, horizon, units))

    def forward(self, x):
        resid = x.reshape(x.shape[0], self.lookback)   # (B, L) univariate
        forecast = None
        for i in range(self.num_blocks):
            b, f = getattr(self, f"block{i}")(resid)
            resid = resid - b
            forecast = f if forecast is None else forecast + f
        return forecast[..., None]                     # (B, horizon, 1)


class NBeatsForecaster(BaseForecaster):
    def __init__(self, past_seq_len: int, future_seq_len: int,
                 nbeats_units: int = 64, num_blocks: int = 3,
                 lr: float = 1e-3, loss: str = "mse", seed: int = 0,
                 device=None):
        self.nbeats_units = nbeats_units
        self.num_blocks = num_blocks
        super().__init__(past_seq_len, future_seq_len, 1, 1, lr, loss, seed,
                         device)

    def _build_model(self) -> nn.Module:
        return _NBeats(self.past_seq_len, self.future_seq_len,
                       self.nbeats_units, self.num_blocks)
