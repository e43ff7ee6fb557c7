"""Attention / Transformer layers — the port of
``bigdl_tpu/nn/layers/attention.py`` (ref: S:dllib/nn/Attention.scala,
keras-era TransformerLayer).

Written as the JAX layer is: einsums, f32 logits, ``-1e30`` masking and
a softmax (``attention.py:66-76``). Not ``F.scaled_dot_product_attention``:
a row whose mask is all zeros gives NaN there, and uniform weights here
and in the JAX layer.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.nn.layers.activation import GELU
from bigdl_tpu_torch.nn.layers.dropout import Dropout
from bigdl_tpu_torch.nn.layers.linear import Linear
from bigdl_tpu_torch.nn.layers.normalization import LayerNorm
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


def _split_input(x):
    """x may be a tensor, or a Table/tuple of (hidden, attention_mask)."""
    if isinstance(x, Table):
        vals = list(x.values())
        return vals[0], (vals[1] if len(vals) > 1 else None)
    if isinstance(x, (tuple, list)):
        return x[0], (x[1] if len(x) > 1 else None)
    return x, None


class MultiHeadAttention(Module):
    """Self-attention with ``n_head`` heads (ref: nn/Attention.scala).

    Input: hidden (B, T, H) or Table(hidden, mask) where mask is (B, T)
    with 1 for real tokens; output (B, T, H).
    """

    def __init__(self, hidden_size: int, n_head: int,
                 attn_dropout: float = 0.0, name: Optional[str] = None):
        super().__init__(name)
        if hidden_size % n_head:
            raise ValueError(f"hidden {hidden_size} % heads {n_head} != 0")
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.head_dim = hidden_size // n_head
        self._modules["q"] = Linear(hidden_size, hidden_size)
        self._modules["k"] = Linear(hidden_size, hidden_size)
        self._modules["v"] = Linear(hidden_size, hidden_size)
        self._modules["out"] = Linear(hidden_size, hidden_size)
        self._modules["drop"] = Dropout(attn_dropout)

    def forward(self, x):
        h, mask = _split_input(x)
        b, t, _ = h.shape

        def heads(y):
            return y.reshape(b, t, self.n_head, self.head_dim)

        q, k, v = heads(self.q(h)), heads(self.k(h)), heads(self.v(h))
        logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
        logits = logits / math.sqrt(self.head_dim)
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :].bool(), -1e30)
        p = self.drop(torch.softmax(logits, dim=-1))
        # p in the input dtype, f32 sums, cast back (the JAX layer's PV)
        ctx = torch.einsum("bnqk,bknd->bqnd", p.to(h.dtype).float(),
                           v.float())
        ctx = ctx.to(h.dtype).reshape(b, t, self.hidden_size)
        return self.out(ctx)


class TransformerEncoderLayer(Module):
    """Post-LN transformer encoder block (BERT-style: ref keras
    TransformerLayer): MHA → add&norm → FFN(GELU) → add&norm.

    Input: hidden (B, T, H) or Table(hidden, mask); output same shape as
    hidden.
    """

    def __init__(self, hidden_size: int, n_head: int,
                 intermediate_size: Optional[int] = None,
                 dropout: float = 0.1, name: Optional[str] = None):
        super().__init__(name)
        inter = intermediate_size or 4 * hidden_size
        self._modules["attention"] = MultiHeadAttention(
            hidden_size, n_head, attn_dropout=dropout)
        self._modules["attn_norm"] = LayerNorm(hidden_size, eps=1e-12)
        self._modules["ffn1"] = Linear(hidden_size, inter)
        # exact erf GELU: HF BERT semantics
        self._modules["gelu"] = GELU(approximate=False)
        self._modules["ffn2"] = Linear(inter, hidden_size)
        self._modules["drop1"] = Dropout(dropout)
        self._modules["drop2"] = Dropout(dropout)
        self._modules["ffn_norm"] = LayerNorm(hidden_size, eps=1e-12)

    def forward(self, x):
        h, mask = _split_input(x)
        attn = self.attention((h, mask) if mask is not None else h)
        h = self.attn_norm(h + self.drop1(attn))
        ffn = self.ffn2(self.gelu(self.ffn1(h)))
        return self.ffn_norm(h + self.drop2(ffn))
