"""StarCoder / GPTBigCode family — the port of
``bigdl_tpu/llm/models/starcoder.py``. Distinct from the other stacks:
**multi-query attention** (one shared K/V head: every attention path
groups all ``Hq`` query heads onto it, ``g = Hq``, so the K/V is never
repeated), learned absolute position embeddings (``wpe``, indexed by a
device tensor, so a captured step reads the positions; no rotary),
GPT-2-style LayerNorm + bias blocks with a sequential residual, tanh-GELU
MLP and the tied head (``wte``).

The layer (:func:`_layer`, Bloom's too) runs on every path through the
shared skeletons, as in ``gptneox.py``. The multi-query ``k_proj`` /
``v_proj`` are (head_dim, H): q4_0 at StarCoder-15B's N = 128; an N that
is not a multiple of 128 (the tiny test configs) stays dense, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.llm.kernels.sampling import make_sampled_step
from bigdl_tpu_torch.llm.kvcache.prefill import (make_mixed_step,
                                                 make_partial_prefill,
                                                 make_spec_step)
from bigdl_tpu_torch.llm.models._facade import (CausalLMFacade, draw,
                                                init_layers, load_layers,
                                                norm_params, quantize_layers)
from bigdl_tpu_torch.llm.models.gptneox import _layer_norm
from bigdl_tpu_torch.llm.models.llama import (_linear, dense_forward,
                                              init_cache, ragged_prefill)
from bigdl_tpu_torch.llm.transformers.st_reader import SafetensorsReader


@dataclasses.dataclass
class StarCoderConfig:
    """StarCoder-15B by default."""
    vocab_size: int = 49152
    hidden_size: int = 6144
    intermediate_size: int = 24576
    num_hidden_layers: int = 40
    num_attention_heads: int = 48
    num_key_value_heads: int = 1           # multi-query
    max_position_embeddings: int = 8192
    layer_norm_epsilon: float = 1e-5
    attn_block_size: int = 1024
    sliding_window = None                  # read by the shared attention
    num_experts = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def starcoder_15b(cls) -> "StarCoderConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab: int = 256) -> "StarCoderConfig":
        return cls(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   max_position_embeddings=128)

    @classmethod
    def from_hf(cls, hf) -> "StarCoderConfig":
        g = (lambda k, d: getattr(hf, k, d))
        return cls(vocab_size=g("vocab_size", 49152),
                   hidden_size=g("n_embd", 6144),
                   intermediate_size=g("n_inner", None)
                   or 4 * g("n_embd", 6144),
                   num_hidden_layers=g("n_layer", 40),
                   num_attention_heads=g("n_head", 48),
                   num_key_value_heads=(1 if g("multi_query", True)
                                        else g("n_head", 48)),
                   max_position_embeddings=g("n_positions", 8192),
                   layer_norm_epsilon=g("layer_norm_epsilon", 1e-5))


_LAYER_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj",
                  "fc_in", "fc_out")


def _quantizable(shape) -> bool:
    """q4_0 takes an (N, K) linear whose N is a multiple of 128 (the JAX
    kernel's N tile); the tiny configs' multi-query k/v stay dense."""
    return shape[0] % 128 == 0


def linear_shapes(cfg: StarCoderConfig) -> Dict[str, Tuple[int, int]]:
    h = cfg.hidden_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    return {"q_proj": (h, h), "k_proj": (kv, h), "v_proj": (kv, h),
            "o_proj": (h, h), "fc_in": (cfg.intermediate_size, h),
            "fc_out": (h, cfg.intermediate_size)}


def init_params(cfg: StarCoderConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None, qtype: Optional[str] = None) -> Dict[str, Any]:
    """Random weights (the JAX package's shapes, scales and dtypes) from a
    seeded ``torch.Generator`` on ``device``; with ``qtype`` every
    quantizable decoder linear is q4_0 as drawn, one layer at a time."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = cfg.hidden_size
    return {"layers": init_layers(cfg, linear_shapes(cfg), gen, dtype, dev,
                                  qtype, _quantizable),
            "wte": draw(gen, (cfg.vocab_size, h), 0.02, dtype, dev),
            "wpe": draw(gen, (cfg.max_position_embeddings, h), 0.02, dtype,
                        dev),
            "ln_f": norm_params(h, dtype, dev)}


def quantize_params(params: Dict[str, Any], qtype: str = "sym_int4"
                    ) -> Dict[str, Any]:
    return quantize_layers(params, _LAYER_LINEARS, qtype, _quantizable)


def _embed(params, cfg, toks, positions):
    """Token plus learned position embedding. A position past the table
    (a padding row of the last bucket) reads its last row, as JAX's
    clamped gather does; nothing reads that row's output."""
    wpe = params["wpe"]
    pos = positions.long().clamp(max=wpe.shape[0] - 1)
    return params["wte"][toks] + wpe[pos].to(params["wte"].dtype)


def _layer(lp, x, positions, cfg, attend, kv_dtype=None):
    """One GPT-2-style layer (StarCoder's and Bloom's): LayerNorm + bias,
    ``num_key_value_heads`` K/V heads, sequential residual, tanh GELU;
    position information comes from the embedding (StarCoder) or the
    attention's ALiBi biases (Bloom). Returns (x, k, v), k/v cast to
    ``kv_dtype`` before attention when given."""
    b, t, _ = x.shape
    nh, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    eps = cfg.layer_norm_epsilon
    h1 = _layer_norm(x, lp["input_layernorm"], eps)
    q = _linear(lp["q_proj"], h1).reshape(b, t, nh, hd)
    k = _linear(lp["k_proj"], h1).reshape(b, t, kvh, hd)
    v = _linear(lp["v_proj"], h1).reshape(b, t, kvh, hd)
    if kv_dtype is not None:
        k, v = k.to(kv_dtype), v.to(kv_dtype)
    x = x + _linear(lp["o_proj"], attend(q, k, v).to(x.dtype).reshape(
        b, t, -1))
    h2 = _layer_norm(x, lp["post_attention_layernorm"], eps)
    x = x + _linear(lp["fc_out"], F.gelu(
        _linear(lp["fc_in"], h2).to(torch.float32),
        approximate="tanh").to(x.dtype))
    return x, k, v


def _head(params, cfg, x):
    """Final LayerNorm, then the tied head."""
    x = _layer_norm(x, params["ln_f"], cfg.layer_norm_epsilon)
    return x @ params["wte"].t().to(x.dtype)


_PARTS = dict(embed=_embed, layer=_layer, head=_head)


def forward(params: Dict[str, Any], cfg: StarCoderConfig, tokens, cache,
            positions):
    """Dense-cache forward (prefill or decode); the cache is written in
    place. Returns ``(logits (B, T, V) f32, cache)``."""
    return dense_forward(params, cfg, tokens, cache, positions, **_PARTS)


def paged_decode_step(params, cfg, k_pages, v_pages, bt, lens, toks, *,
                      page: int):
    """The engine's paged decode step for StarCoder (``serving.
    paged_decode``; the stats kernel groups all query heads on the one
    K/V head). Returns ``(logits (B, V) f32, k_pages, v_pages)``."""
    from bigdl_tpu_torch.llm.serving import paged_decode
    return paged_decode(params, cfg, k_pages, v_pages, bt, lens, toks,
                        page=page, **_PARTS)


def paged_prefill_ragged(params, cfg, k_pages, v_pages, toks, length,
                         offset, bt_row, phys, slots, fork_dst, fork_src, *,
                         page: int, full_logits: bool = False):
    """Ragged in-place prefill (``llama.paged_prefill_ragged``'s
    contract) with the StarCoder layer."""
    return ragged_prefill(params, cfg, k_pages, v_pages, toks, length,
                          offset, bt_row, phys, slots, fork_dst, fork_src,
                          page=page, full_logits=full_logits, **_PARTS)


paged_decode_step_sampled = make_sampled_step(paged_decode_step)
paged_prefill_partial = make_partial_prefill(forward, init_cache)
paged_step_mixed = make_mixed_step(paged_decode_step, paged_prefill_ragged)
paged_step_spec = make_spec_step(paged_decode_step, paged_prefill_ragged)


class StarCoderForCausalLM(CausalLMFacade):
    """Generation facade (``_facade.CausalLMFacade``)."""

    _forward = staticmethod(forward)
    _init_cache = staticmethod(init_cache)
    _init_params = staticmethod(init_params)
    _paged_step = staticmethod(paged_decode_step)


def load_hf_starcoder_safetensors(path: str,
                                  cfg: Optional[StarCoderConfig] = None,
                                  qtype: Optional[str] = None, dtype=None,
                                  device=None) -> Dict[str, Any]:
    """An HF ``GPTBigCodeForCausalLM`` checkpoint → the stacked layout on
    ``device``, one layer at a time (quantize-on-load with ``qtype``).
    HF's ``attn.c_attn`` is a plain concat ``[q (h); k (kv); v (kv)]``
    along the output dim. Bit-identical to the JAX package's loader."""
    from bigdl_tpu_torch.llm.transformers.model import _read_raw_config
    if qtype and qtype != "sym_int4":
        raise NotImplementedError("q4_0 only on the scanned path")
    dev = resolve_device(device)
    dtype = dtype or torch.bfloat16
    if cfg is None:
        cfg = StarCoderConfig.from_hf(type("HFConfig", (), _read_raw_config(
            path))())
    h, kv = cfg.hidden_size, cfg.num_key_value_heads * cfg.head_dim
    hf_lin = {"o_proj": "attn.c_proj", "fc_in": "mlp.c_fc",
              "fc_out": "mlp.c_proj", "input_layernorm": "ln_1",
              "post_attention_layernorm": "ln_2"}
    # the reader takes the optional "transformer." name prefix
    with SafetensorsReader(path) as reader:
        def get(name):
            return torch.from_numpy(reader.get(name)).to(dev)

        def read_layer(l):
            w, b = get(f"h.{l}.attn.c_attn.weight"), get(
                f"h.{l}.attn.c_attn.bias")
            out = {"q_proj": (w[:h], b[:h]),
                   "k_proj": (w[h:h + kv], b[h:h + kv]),
                   "v_proj": (w[h + kv:], b[h + kv:])}
            out.update({n: (get(f"h.{l}.{hf}.weight"), get(f"h.{l}.{hf}.bias"))
                        for n, hf in hf_lin.items()})
            return out

        return {"layers": load_layers(cfg.num_hidden_layers, read_layer,
                                      qtype, dtype, _quantizable),
                "wte": get("wte.weight").to(dtype),
                "wpe": get("wpe.weight").to(dtype),
                "ln_f": {"w": get("ln_f.weight").to(dtype),
                         "b": get("ln_f.bias").to(dtype)}}
