"""Bloom family — the port of ``bigdl_tpu/llm/models/bloom.py``. Distinct
from Llama and GPT-NeoX: **ALiBi** linear position biases instead of
rotary, a LayerNorm directly after the word embeddings, sequential
residuals, tanh-GELU MLP, fused per-head q/k/v in checkpoints, the tied
head, no GQA.

The layer is StarCoder's (``starcoder._layer``: the same GPT-2-style
block; Bloom's position information is the attention's ALiBi bias). The
biases enter through ``llama._attention(alibi_slopes=)`` on its
single-block score path: ``attn_block_size`` keeps the whole
``max_position_embeddings`` window one block. Bloom is dense only, as in
the JAX package: ``forward`` and ``generate`` over the dense cache, no
paged step (the paged kernels have no bias hook), so ``LLMServer``
refuses a Bloom model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.llm.models._facade import (CausalLMFacade, draw,
                                                init_layers, load_layers,
                                                norm_params, quantize_layers)
from bigdl_tpu_torch.llm.models.gptneox import _layer_norm
from bigdl_tpu_torch.llm.models.llama import dense_forward, init_cache
from bigdl_tpu_torch.llm.models.starcoder import _layer
from bigdl_tpu_torch.llm.transformers.st_reader import SafetensorsReader


@dataclasses.dataclass
class BloomConfig:
    """Bloom-7b1 by default."""
    vocab_size: int = 250880
    hidden_size: int = 4096
    num_hidden_layers: int = 30
    num_attention_heads: int = 32
    layer_norm_epsilon: float = 1e-5
    max_position_embeddings: int = 2048
    sliding_window = None              # read by the shared _attention
    num_experts = 0

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def attn_block_size(self) -> int:
        # ALiBi rides the single-block attention path (llama._attention)
        return max(self.max_position_embeddings, 1024)

    @classmethod
    def bloom_7b1(cls) -> "BloomConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab: int = 256) -> "BloomConfig":
        return cls(vocab_size=vocab, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, max_position_embeddings=128)

    @classmethod
    def from_hf(cls, hf) -> "BloomConfig":
        g = (lambda k, d: getattr(hf, k, d))
        return cls(vocab_size=g("vocab_size", 250880),
                   hidden_size=g("hidden_size", g("n_embed", 4096)),
                   num_hidden_layers=g("num_hidden_layers",
                                       g("n_layer", 30)),
                   num_attention_heads=g("num_attention_heads",
                                         g("n_head", 32)),
                   layer_norm_epsilon=g("layer_norm_epsilon", 1e-5))


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes — the closest-power-of-2 recipe of the ALiBi
    paper that HF's ``build_alibi_tensor`` implements: for ``p =
    2^floor(log2 n)`` heads, slope_i = 2^(-8(i+1)/p); the remaining heads
    interleave the odd steps of the 2p schedule."""
    p = 2 ** int(np.floor(np.log2(n_heads)))
    base = 2.0 ** (-(2.0 ** -(np.log2(p) - 3)))
    slopes = base ** np.arange(1, p + 1)
    if p < n_heads:
        base2 = 2.0 ** (-(2.0 ** -(np.log2(2 * p) - 3)))
        extra = base2 ** np.arange(1, 2 * (n_heads - p) + 1, 2)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


_LAYER_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj",
                  "fc_in", "fc_out")


def linear_shapes(cfg: BloomConfig) -> Dict[str, Tuple[int, int]]:
    h = cfg.hidden_size
    return {"q_proj": (h, h), "k_proj": (h, h), "v_proj": (h, h),
            "o_proj": (h, h), "fc_in": (cfg.intermediate_size, h),
            "fc_out": (h, cfg.intermediate_size)}


def init_params(cfg: BloomConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None, qtype: Optional[str] = None) -> Dict[str, Any]:
    """Random weights (the JAX package's shapes, scales and dtypes) from a
    seeded ``torch.Generator`` on ``device``; with ``qtype`` every
    decoder linear is q4_0 as drawn, one layer at a time."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = cfg.hidden_size
    return {"layers": init_layers(cfg, linear_shapes(cfg), gen, dtype, dev,
                                  qtype),
            "word_embeddings": draw(gen, (cfg.vocab_size, h), 0.02, dtype,
                                    dev),
            "word_embeddings_layernorm": norm_params(h, dtype, dev),
            "ln_f": norm_params(h, dtype, dev)}


def quantize_params(params: Dict[str, Any], qtype: str = "sym_int4"
                    ) -> Dict[str, Any]:
    return quantize_layers(params, _LAYER_LINEARS, qtype)


def _embed(params, cfg, toks, positions):
    return _layer_norm(params["word_embeddings"][toks],
                       params["word_embeddings_layernorm"],
                       cfg.layer_norm_epsilon)


def _head(params, cfg, x):
    """Final LayerNorm, then the tied head."""
    x = _layer_norm(x, params["ln_f"], cfg.layer_norm_epsilon)
    return x @ params["word_embeddings"].t().to(x.dtype)


def forward(params: Dict[str, Any], cfg: BloomConfig, tokens, cache,
            positions):
    """Dense-cache forward (prefill or decode) with ALiBi attention; the
    cache is written in place. Returns ``(logits (B, T, V) f32, cache)``."""
    slopes = torch.from_numpy(alibi_slopes(cfg.num_attention_heads)).to(
        cache["k"].device)
    return dense_forward(params, cfg, tokens, cache, positions,
                         embed=_embed, layer=_layer, head=_head,
                         alibi_slopes=slopes)


class BloomForCausalLM(CausalLMFacade):
    """Generation facade (``_facade.CausalLMFacade``), dense decode."""

    _forward = staticmethod(forward)
    _init_cache = staticmethod(init_cache)
    _init_params = staticmethod(init_params)


def load_hf_bloom_safetensors(path: str, cfg: Optional[BloomConfig] = None,
                              qtype: Optional[str] = None, dtype=None,
                              device=None) -> Dict[str, Any]:
    """An HF ``BloomForCausalLM`` checkpoint → the stacked layout on
    ``device``, one layer at a time (quantize-on-load with ``qtype``). HF
    fuses q/k/v as ``self_attention.query_key_value`` interleaved per head
    ``[q; k; v]``; it is split back into three linears. Bit-identical to
    the JAX package's loader."""
    from bigdl_tpu_torch.llm.transformers.model import _read_raw_config
    if qtype and qtype != "sym_int4":
        raise NotImplementedError("q4_0 only on the scanned path")
    dev = resolve_device(device)
    dtype = dtype or torch.bfloat16
    if cfg is None:
        cfg = BloomConfig.from_hf(type("HFConfig", (), _read_raw_config(
            path))())
    nh, hd, h = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
    hf_lin = {"o_proj": "self_attention.dense", "fc_in": "mlp.dense_h_to_4h",
              "fc_out": "mlp.dense_4h_to_h",
              "input_layernorm": "input_layernorm",
              "post_attention_layernorm": "post_attention_layernorm"}
    # the reader takes the optional "transformer." name prefix
    with SafetensorsReader(path) as reader:
        def get(name):
            return torch.from_numpy(reader.get(name)).to(dev)

        def read_layer(l):
            pre = f"h.{l}."
            w = get(pre + "self_attention.query_key_value.weight").view(
                nh, 3, hd, h)
            b = get(pre + "self_attention.query_key_value.bias").view(
                nh, 3, hd)
            out = {n: (w[:, i].reshape(h, h), b[:, i].reshape(h))
                   for i, n in enumerate(("q_proj", "k_proj", "v_proj"))}
            out.update({n: (get(pre + hf + ".weight"), get(pre + hf + ".bias"))
                        for n, hf in hf_lin.items()})
            return out

        return {"layers": load_layers(cfg.num_hidden_layers, read_layer,
                                      qtype, dtype),
                "word_embeddings": get("word_embeddings.weight").to(dtype),
                "word_embeddings_layernorm": {
                    "w": get("word_embeddings_layernorm.weight").to(dtype),
                    "b": get("word_embeddings_layernorm.bias").to(dtype)},
                "ln_f": {"w": get("ln_f.weight").to(dtype),
                         "b": get("ln_f.bias").to(dtype)}}
