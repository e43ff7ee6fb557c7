"""AutoformerForecaster — the port of
``bigdl_tpu/chronos/forecaster/autoformer.py`` (ref:
P:chronos/forecaster/autoformer_forecaster.py over
P:chronos/model/autoformer — series decomposition blocks +
auto-correlation attention, Wu et al. 2021).

- **series decomposition**: moving-average trend by a cumulative sum
  (the JAX module's form: its f32 error grows with L, and a pooling form
  would part from it by other amounts) + the seasonal residual;
- **auto-correlation**: ``R(tau) = irfft(rfft(q) * conj(rfft(k)), n=L)``
  on the time axis, the top-k delays of its channel mean, and the
  time-delay aggregation as one gather on ``(t + tau) % L``. The
  gradient flows through the softmax of the top-k scores and the
  gathered values, not through the chosen indices, as in JAX;
- the encoder refines the seasonal part; dense heads map the seasonal
  and trend parts to the horizon.

One :class:`TensorModule` whose parameters carry the JAX module's names
(``embed_w``, ``attn_q``, ..., ``head_trend_w``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.chronos.forecaster.base import BaseForecaster
from bigdl_tpu_torch.nn.module import RNG, TensorModule


def _series_decomp(x: torch.Tensor, kernel: int):
    """x (B, L, C) → (seasonal, trend); trend = centered moving average
    with edge padding (ref series_decomp)."""
    pad_l = (kernel - 1) // 2
    pad_r = kernel - 1 - pad_l
    xp = torch.cat([x[:, :1].expand(-1, pad_l, -1), x,
                    x[:, -1:].expand(-1, pad_r, -1)], dim=1)
    cs = torch.cumsum(F.pad(xp, (0, 0, 1, 0)), dim=1)
    trend = (cs[:, kernel:] - cs[:, :-kernel]) / kernel
    return x - trend, trend


def _delays(q: torch.Tensor, k: torch.Tensor, top_k: int):
    """The top-k delays of the channel-mean auto-correlation of q and k
    (B, L, D): ``(scores (B, K), delays (B, K))``."""
    L = q.shape[1]
    fq = torch.fft.rfft(q, dim=1)
    fk = torch.fft.rfft(k, dim=1)
    corr = torch.fft.irfft(fq * torch.conj(fk), n=L, dim=1)   # (B, L, D)
    return torch.topk(corr.mean(dim=-1), top_k, dim=-1)


def _auto_correlation(q, k, v, top_k: int):
    """q/k/v (B, L, D) → time-delay aggregated output (B, L, D)."""
    b, L, d = v.shape
    top_w, top_tau = _delays(q, k, top_k)
    w = torch.softmax(top_w, dim=-1)                          # (B, K)
    idx = (torch.arange(L, device=v.device)[None, None, :]
           + top_tau[:, :, None]) % L                          # (B, K, L)
    rolled = torch.gather(
        v[:, None].expand(b, top_k, L, d), 2,
        idx[..., None].expand(b, top_k, L, d))                # (B, K, L, D)
    return torch.einsum("bk,bkld->bld", w, rolled)


class _Autoformer(TensorModule):
    def __init__(self, past_len: int, future_len: int, c_in: int,
                 c_out: int, d_model: int = 32, top_k: int = 3,
                 decomp_kernel: int = 7, name: Optional[str] = None):
        super().__init__(name)
        self.past_len, self.future_len = past_len, future_len
        self.c_in, self.c_out = c_in, c_out
        self.d_model, self.top_k = d_model, top_k
        self.decomp_kernel = decomp_kernel

        def mk(shape, scale):
            return torch.randn(shape, generator=RNG) * scale

        s = 1.0 / np.sqrt(c_in)
        self.add_param("embed_w", mk((d_model, c_in), s))
        self.add_param("embed_b", torch.zeros(d_model))
        sd = 1.0 / np.sqrt(d_model)
        for nm in ("q", "k", "v", "o"):
            self.add_param(f"attn_{nm}", mk((d_model, d_model), sd))
        self.add_param("ff1_w", mk((2 * d_model, d_model), sd))
        self.add_param("ff1_b", torch.zeros(2 * d_model))
        self.add_param("ff2_w", mk((d_model, 2 * d_model),
                                   1.0 / np.sqrt(2 * d_model)))
        self.add_param("ff2_b", torch.zeros(d_model))
        self.add_param("head_seasonal_w",
                       mk((future_len * c_out, past_len * d_model),
                          1.0 / np.sqrt(past_len * d_model)))
        self.add_param("head_trend_w",
                       mk((future_len * c_out, past_len * c_in),
                          1.0 / np.sqrt(past_len * c_in)))

    def forward(self, x):
        b = x.shape[0]
        seasonal, trend = _series_decomp(x, self.decomp_kernel)
        h = F.linear(seasonal, self.embed_w, self.embed_b)
        q = F.linear(h, self.attn_q)
        k = F.linear(h, self.attn_k)
        v = F.linear(h, self.attn_v)
        attn = F.linear(_auto_correlation(q, k, v, self.top_k), self.attn_o)
        h2, _ = _series_decomp(h + attn, self.decomp_kernel)
        ff = torch.relu(F.linear(h2, self.ff1_w, self.ff1_b))
        ff = F.linear(ff, self.ff2_w, self.ff2_b)
        h3, _ = _series_decomp(h2 + ff, self.decomp_kernel)
        out = (F.linear(h3.reshape(b, -1), self.head_seasonal_w)
               + F.linear(trend.reshape(b, -1), self.head_trend_w))
        return out.reshape(b, self.future_len, self.c_out)


class AutoformerForecaster(BaseForecaster):
    """ref args mirror AutoformerForecaster(past_seq_len, future_seq_len,
    input_feature_num, output_feature_num, d_model, ...)."""

    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_feature_num: int, output_feature_num: int,
                 d_model: int = 32, top_k: int = 3,
                 decomp_kernel: int = 7, lr: float = 1e-3,
                 loss: str = "mse", seed: int = 0, device=None):
        self.d_model = d_model
        self.top_k = top_k
        self.decomp_kernel = decomp_kernel
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, lr, loss, seed, device)

    def _build_model(self) -> nn.Module:
        return _Autoformer(self.past_seq_len, self.future_seq_len,
                           self.input_feature_num, self.output_feature_num,
                           self.d_model, self.top_k, self.decomp_kernel)
