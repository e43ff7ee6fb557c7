"""Shared model holder of the GPT-NeoX, StarCoder and Bloom families —
the port of ``bigdl_tpu/llm/models/_facade.py`` — and the parameter
helpers the three share.

:class:`CausalLMFacade` drives a family's ``forward`` / ``init_cache``:
``from_config`` (random weights from a seed) and greedy ``generate``
with EOS-chunked early exit. It shares ``LlamaForCausalLM``'s base,
``llama.ModelHolder`` (what the serving engine reads, and ``__call__``:
a prefill into a fresh dense cache), and its ``generate`` is the llama
holder's loop (``llama.generate_tokens``): over a page pool through the family's
``paged_decode_step``, one captured CUDA graph a token on the card, or,
for a family with no paged step (Bloom) or with ``paged_decode=False``,
over the dense cache through the family's ``forward`` (the JAX facade's
``decode_scan(forward_fn=)``). The JAX facade's ``PRNGKey`` is a
``torch.Generator`` here.

The families' parameter trees are the JAX package's: stacked decoder
linears ``{"w": (L, N, K), "b": (L, N)}`` (or ``{"q", "scale", "b"}``
quantized to q4_0 in the k-major kernel layout), LayerNorms ``{"w", "b"}``
and the family's embeddings.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.llm.kernels.int4_matmul import quantize_tpu
from bigdl_tpu_torch.llm.models.llama import ModelHolder, generate_tokens

# the JAX families' refusal, word for word
Q4_ONLY = "the scanned decoder path implements q4_0 (sym_int4)"


def _always(shape) -> bool:
    return True


def draw(gen, shape, scale, dtype, device) -> torch.Tensor:
    """``randn(shape) * scale`` (``1/sqrt(fan_in)`` when ``scale`` is
    None, the JAX package's init) drawn in f32 from ``gen``, cast."""
    scale = scale or (1.0 / np.sqrt(shape[-1]))
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * scale).to(dtype)


def norm_params(h: int, dtype, device) -> Dict[str, torch.Tensor]:
    """A LayerNorm's unit weight and zero bias."""
    return {"w": torch.ones((h,), dtype=dtype, device=device),
            "b": torch.zeros((h,), dtype=dtype, device=device)}


def _quantized(ws, qtype: str) -> Dict[str, torch.Tensor]:
    """One linear's per-layer (N, K) weights → stacked q4_0 planes."""
    if qtype != "sym_int4":
        raise NotImplementedError(Q4_ONLY)
    tds = [quantize_tpu(w, qtype) for w in ws]
    return {"q": torch.stack([td["q"] for td in tds]),
            "scale": torch.stack([td["scale"] for td in tds])}


def init_layers(cfg, shapes: Dict[str, Tuple[int, int]], gen, dtype,
                device, qtype: Optional[str] = None,
                quantizable: Callable = _always) -> Dict[str, Any]:
    """Random stacked decoder layers: each linear of ``shapes`` (out, in)
    drawn one layer at a time with a zero bias, quantized to ``qtype``
    as it is drawn where ``quantizable(shape)`` (so the f32 temporary is
    one layer's weight; bit-identical to :func:`quantize_layers` of the
    dense draw), and the two LayerNorms."""
    L, h = cfg.num_hidden_layers, cfg.hidden_size
    layers: Dict[str, Any] = {}
    for name, shape in shapes.items():
        if qtype and quantizable(shape):
            wd = _quantized((draw(gen, shape, None, dtype, device)
                             for _ in range(L)), qtype)
        else:
            wd = {"w": torch.empty((L,) + shape, dtype=dtype,
                                   device=device)}
            for l in range(L):
                wd["w"][l] = draw(gen, shape, None, dtype, device)
        wd["b"] = torch.zeros((L, shape[0]), dtype=dtype, device=device)
        layers[name] = wd
    for norm in ("input_layernorm", "post_attention_layernorm"):
        layers[norm] = {k: v.expand(L, h).clone()
                        for k, v in norm_params(h, dtype, device).items()}
    return layers


def quantize_layers(params: Dict[str, Any], names, qtype: str = "sym_int4",
                    quantizable: Callable = _always) -> Dict[str, Any]:
    """q4_0-quantize the decoder linears ``names`` (weights only; biases
    stay as they are) into the k-major kernel layout, one layer at a
    time, on the weights' own device, where ``quantizable((N, K))``.
    Bit-identical to the JAX families' ``quantize_params``."""
    if qtype != "sym_int4":
        raise NotImplementedError(Q4_ONLY)
    layers = dict(params["layers"])
    for name in names:
        w = layers[name].get("w")
        if w is None or not quantizable(tuple(w.shape[1:])):
            continue
        layers[name] = {**_quantized(w.unbind(0), qtype),
                        "b": layers[name]["b"]}
    return {**params, "layers": layers}


def load_layers(L: int, read_layer, qtype: Optional[str], dtype,
                quantizable: Callable = _always) -> Dict[str, Any]:
    """The stacked layer tree of a checkpoint: ``read_layer(l)`` gives
    layer ``l``'s ``{name: (w, b)}`` f32 tensors, linears as (N, K)
    weights (quantized at once with ``qtype`` where ``quantizable``, else
    cast to ``dtype``) and LayerNorms as (H,) weights; biases and norms
    are cast to ``dtype``, as the JAX loaders store them."""
    acc: Dict[str, Dict[str, list]] = {}
    for l in range(L):
        for name, (w, b) in read_layer(l).items():
            a = acc.setdefault(name, {"w": [], "b": []})
            a["b"].append(b.to(dtype))
            if w.dim() == 2 and qtype and quantizable(tuple(w.shape)):
                w = _quantized([w], qtype)
            else:
                w = w.to(dtype)
            a["w"].append(w)
    layers: Dict[str, Any] = {}
    for name, a in acc.items():
        ws = a["w"]
        layers[name] = ({k: torch.cat([w[k] for w in ws]) for k in ws[0]}
                        if isinstance(ws[0], dict)
                        else {"w": torch.stack(ws)})
        layers[name]["b"] = torch.stack(a["b"])
    return layers


class CausalLMFacade(ModelHolder):
    """Greedy generation over a family's ``forward`` / ``init_cache``
    (:class:`~bigdl_tpu_torch.llm.models.llama.ModelHolder`).

    Subclasses set ``_forward``, ``_init_cache``, ``_init_params`` and
    ``_paged_step`` (the family's ``paged_decode_step``, None for Bloom)
    as ``staticmethod`` class attributes."""

    _init_params = None
    _paged_step = None

    def __init__(self, cfg, params: Dict[str, Any], max_cache_len: int = 512,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 paged_decode: bool = True, page_size: int = 16,
                 device=None):
        # a family with no paged decode step (Bloom) decodes dense
        super().__init__(cfg, params, max_cache_len, cache_dtype,
                         paged_decode and type(self)._paged_step is not None,
                         page_size, device)

    @classmethod
    def from_config(cls, cfg, seed: int = 0,
                    load_in_low_bit: Optional[str] = None,
                    max_cache_len: int = 512, device=None):
        """Random weights from ``seed`` made on ``device``; with
        ``load_in_low_bit``, each decoder linear quantized one layer at a
        time as it is drawn."""
        dev = resolve_device(device)
        params = cls._init_params(cfg, seed, device=dev,
                                  qtype=load_in_low_bit)
        return cls(cfg, params, max_cache_len, device=dev)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 decode_chunk: int = 32) -> np.ndarray:
        """Greedy decode; input_ids (B, T0) → (B, T0 + new) int32 numpy
        (``llama.generate_tokens``)."""
        step = type(self)._paged_step if self.paged_decode else None
        return generate_tokens(self, input_ids, max_new_tokens,
                               forward_fn=type(self)._forward, step_fn=step,
                               eos_token_id=eos_token_id,
                               decode_chunk=decode_chunk)
