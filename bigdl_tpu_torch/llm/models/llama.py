"""Llama family — the port of ``bigdl_tpu/llm/models/llama.py``, the
parts on the served path: the config, parameter fusion and q4_0
quantization, the layer math (``_linear``, ``rms_norm``, ``rope``,
``attention_qkv``, ``mlp``), the ragged in-place prefill and a minimal
model holder.

Parameters are nested dicts of tensors with the JAX package's keys and
layouts: stacked per layer (``params["layers"][name]`` has a leading
``L`` dim), dense linears ``{"w": (N, K)}``, quantized linears in the
k-major kernel layout ``{"q": (K/2, N) uint8, "scale": (K/32, N) f32}``
(``bigdl_tpu_torch.llm.convert.params_from_numpy`` carries a JAX
package tree across). Layers run in a Python loop: PyTorch is eager, so
the JAX ``lax.scan`` has no counterpart to keep.

The dense ``forward``/``generate``/``decode_scan*`` path and MoE are not
ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.llm.ggml.quantize import QK
from bigdl_tpu_torch.llm.kernels.int4_matmul import int4_matmul, quantize_tpu


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # Mistral-style sliding-window attention: position p attends only to
    # [p - sliding_window + 1, p]. None = full causal (Llama).
    sliding_window: Optional[int] = None
    # "half" = Llama rotate-half; "glm" = interleaved pairs over the first
    # head_dim * partial_rotary_factor dims
    rope_mode: str = "half"
    partial_rotary_factor: float = 1.0
    # mixture-of-experts FFN: not ported yet (0 = dense FFN)
    num_experts: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab: int = 256) -> "LlamaConfig":
        """Test-size config (the JAX package's ``LlamaConfig.tiny``)."""
        return cls(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

_LAYER_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj",
                  "gate_proj", "up_proj", "down_proj")

# q/k/v and gate/up concatenated along the output (N) axis: 4 weight
# streams per layer instead of 7
_FUSED_LINEARS = {"qkv_proj": ("q_proj", "k_proj", "v_proj"),
                  "gate_up_proj": ("gate_proj", "up_proj")}


def linear_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, int]]:
    """(out, in) shapes of every per-layer linear."""
    hd, h = cfg.head_dim, cfg.hidden_size
    kvh = cfg.num_key_value_heads * hd
    qh = cfg.num_attention_heads * hd
    return {
        "q_proj": (qh, h), "k_proj": (kvh, h), "v_proj": (kvh, h),
        "o_proj": (h, qh),
        "gate_proj": (cfg.intermediate_size, h),
        "up_proj": (cfg.intermediate_size, h),
        "down_proj": (h, cfg.intermediate_size),
    }


def fuse_decoder_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Concatenate per-layer q/k/v → ``qkv_proj`` and gate/up →
    ``gate_up_proj`` along the output dim: dense stacked ``w`` (L, N, K)
    on dim 1, k-major quantized ``q``/``scale`` (L, ·, N) on the last dim
    (q4_0 groups run along K, so an N-concat never mixes groups).
    Idempotent."""
    layers = dict(params["layers"])
    for fused, parts in _FUSED_LINEARS.items():
        if fused in layers or not all(p in layers for p in parts):
            continue
        ds = [layers[p] for p in parts]
        if "w" in ds[0]:
            fd = {"w": torch.cat([d["w"] for d in ds], dim=1)}
        else:
            fd = {k: torch.cat([d[k] for d in ds], dim=-1)
                  for k in ("q", "scale")}
        if "b" in ds[0]:
            fd["b"] = torch.cat([d["b"] for d in ds], dim=-1)
        layers[fused] = fd
        for p in parts:
            del layers[p]
    out = dict(params)
    out["layers"] = layers
    return out


def quantize_params(params: Dict[str, Any],
                    qtype: str = "sym_int4") -> Dict[str, Any]:
    """q4_0-quantize every decoder linear (stacked per layer) into the
    k-major kernel layout, on the weights' own device, then fuse qkv and
    gate/up; norms, embeddings and ``lm_head`` stay as they are.
    Bit-identical to the JAX package's ``quantize_params`` on the same
    weights."""
    if qtype != "sym_int4":
        raise NotImplementedError(
            "the decoder path implements q4_0 (sym_int4) only")
    out = dict(params)
    layers = dict(params["layers"])
    names = [n for n in _LAYER_LINEARS + tuple(_FUSED_LINEARS)
             if n in layers and "w" in layers[n]]
    for name in names:
        w = layers[name]["w"]
        if w.dim() != 3:
            raise NotImplementedError(
                "MoE expert-stacked FFN weights are not ported yet")
        tds = [quantize_tpu(w[l], qtype) for l in range(w.shape[0])]
        nd = {"q": torch.stack([td["q"] for td in tds]),
              "scale": torch.stack([td["scale"] for td in tds])}
        if "b" in layers[name]:
            nd["b"] = layers[name]["b"]
        layers[name] = nd
    out["layers"] = layers
    return fuse_decoder_params(out)


def layer_params(layers: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer ``l``'s slice of the stacked layer tree (views, no copy)."""
    return {k: (layer_params(v, l) if isinstance(v, dict) else v[l])
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# compute
# ---------------------------------------------------------------------------

def _linear(wd: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Dense or q4_0 matmul: x (..., K) → (..., N), plus an optional bias
    ``b``. A quantized weight goes through :func:`int4_matmul`, which
    launches the CUDA kernel for a CUDA x and takes the plain version
    for a CPU x."""
    if "w" in wd:
        y = x @ wd["w"].t().to(x.dtype)
        if "b" in wd:
            y = y + wd["b"].to(y.dtype)
        return y
    shape = x.shape
    y = int4_matmul(x.reshape(-1, shape[-1]), wd["q"], wd["scale"],
                    out_dtype=x.dtype)
    if "b" in wd:
        y = y + wd["b"].to(y.dtype)
    return y.reshape(shape[:-1] + (y.shape[-1],))


def rms_norm(x, w, eps: float):
    """Normalise in f32, cast to the model dtype, THEN scale by ``w``
    (the JAX package's cast order)."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x, positions, theta: float, mode: str = "half",
         partial: float = 1.0):
    """RoPE. x (B, T, H, D); positions (B, T) int.

    ``mode="half"``: Llama rotate-half over the full head dim;
    ``mode="glm"``: interleaved pairs (2i, 2i+1) over the first
    ``D * partial`` dims, the rest passed through."""
    d = x.shape[-1]
    dev = x.device
    pos = positions.to(torch.float32)[..., None]
    if mode == "glm":
        rot = int(d * partial)
        x_rot, x_pass = x[..., :rot], x[..., rot:]
        inv_freq = 1.0 / (theta ** (torch.arange(
            0, rot, 2, dtype=torch.float32, device=dev) / rot))
        ang = pos * inv_freq
        cos = torch.cos(ang)[:, :, None, :]
        sin = torch.sin(ang)[:, :, None, :]
        xr = x_rot.to(torch.float32).reshape(x.shape[:-1] + (rot // 2, 2))
        x1, x2 = xr[..., 0], xr[..., 1]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(x.shape[:-1] + (rot,))
        return torch.cat([out.to(x.dtype), x_pass], dim=-1)
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=dev) / d))
    ang = pos * inv_freq                                  # (B, T, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_cfg(x, positions, cfg: LlamaConfig):
    return rope(x, positions, cfg.rope_theta, cfg.rope_mode,
                cfg.partial_rotary_factor)


def attention_qkv(lp: Dict[str, Any], h: torch.Tensor, cfg: LlamaConfig):
    """q/k/v projections of one decoder layer (fused ``qkv_proj`` or
    separate), head-shaped (B, T, H*, D), pre-RoPE."""
    b, t, _ = h.shape
    hd = cfg.head_dim
    qh = cfg.num_attention_heads * hd
    kvh = cfg.num_key_value_heads * hd
    if "qkv_proj" in lp:
        qkv = _linear(lp["qkv_proj"], h)
        q, k, v = (qkv[..., :qh], qkv[..., qh:qh + kvh],
                   qkv[..., qh + kvh:])
    else:
        q = _linear(lp["q_proj"], h)
        k = _linear(lp["k_proj"], h)
        v = _linear(lp["v_proj"], h)
    return (q.reshape(b, t, cfg.num_attention_heads, hd),
            k.reshape(b, t, cfg.num_key_value_heads, hd),
            v.reshape(b, t, cfg.num_key_value_heads, hd))


def mlp(lp: Dict[str, Any], h2: torch.Tensor, dtype) -> torch.Tensor:
    """SwiGLU FFN of one decoder layer: SiLU in f32, then cast."""
    if "gate_up_proj" in lp:
        gu = _linear(lp["gate_up_proj"], h2).to(torch.float32)
        gate, up = torch.chunk(gu, 2, dim=-1)
        gate = F.silu(gate)
    else:
        gate = F.silu(_linear(lp["gate_proj"], h2).to(torch.float32))
        up = _linear(lp["up_proj"], h2).to(torch.float32)
    return _linear(lp["down_proj"], (gate * up).to(dtype))


def lm_logits(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Final projection: the (possibly quantized) ``lm_head``, or the
    embedding-tied plain matmul."""
    head = params.get("lm_head")
    if head is None:
        return x @ params["embed_tokens"].t().to(x.dtype)
    return _linear(head, x)


def decoder_layer(lp: Dict[str, Any], x: torch.Tensor, positions,
                  cfg: LlamaConfig, attend, kv_dtype=None):
    """One decoder layer around an attention closure
    ``attend(q, k, v) -> (B, T, Hq, D)``; returns (x, k, v) with k/v the
    post-RoPE projections for the caller's page scatter, cast to
    ``kv_dtype`` BEFORE attention when given."""
    b, t, _ = x.shape
    h = rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
    q, k, v = attention_qkv(lp, h, cfg)
    q = rope_cfg(q, positions, cfg)
    k = rope_cfg(k, positions, cfg)
    if kv_dtype is not None:
        k, v = k.to(kv_dtype), v.to(kv_dtype)
    attn = attend(q, k, v)
    x = x + _linear(lp["o_proj"], attn.to(x.dtype).reshape(b, t, -1))
    h2 = rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    x = x + mlp(lp, h2, x.dtype)
    return x, k, v


def paged_prefill_ragged(params, cfg: LlamaConfig, k_pages, v_pages, toks,
                         length: int, offset: int, bt_row, phys, slots,
                         fork_dst: int, fork_src: int, *, page: int):
    """Ragged in-place prefill: the suffix tokens run through the layer
    math while attention reads the cached prefix directly from the page
    pool (kernels/ragged_prefill.py); after the layers, one scatter
    writes every layer's suffix K/V into the pools IN PLACE. The COW
    tail fork is one page copy ahead of the layers.

    toks (1, bucket) int; ``length``/``offset`` the true suffix length
    and its start position; bt_row (pages_cap,) int32; phys/slots
    (bucket,) scatter targets (padding routed to trash page 0).
    Returns ``(k_pages, v_pages, last_logits (V,) f32)``. (The JAX
    package's ``full_logits`` leg belongs to speculative decoding, ROADMAP
    Queue 1 item 6(d).)"""
    from bigdl_tpu_torch.llm.kvcache.prefill import (fork_tail_pages,
                                                     ragged_prefill_attend,
                                                     scatter_suffix_kv)
    bucket = toks.shape[1]
    k_pages, v_pages = fork_tail_pages(k_pages, v_pages, fork_dst,
                                       fork_src)
    positions = (offset + torch.arange(bucket, dtype=torch.int32,
                                       device=toks.device))[None]
    x = params["embed_tokens"][toks.long()]                  # (1, Tq, H)
    attend_l = ragged_prefill_attend(k_pages, v_pages, bt_row, offset,
                                     length, page=page,
                                     sliding_window=cfg.sliding_window)
    k_new, v_new = [], []
    for l in range(cfg.num_hidden_layers):
        # the suffix K/V are attended at POOL precision: a later
        # re-prefill reads them back from the pages, so greedy parity
        # needs the cast BEFORE attention, not just at the scatter
        x, k, v = decoder_layer(
            layer_params(params["layers"], l), x, positions, cfg,
            lambda q, k, v, l=l: attend_l(l, q, k, v),
            kv_dtype=k_pages.dtype)
        k_new.append(k[0])
        v_new.append(v[0])
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    logits = lm_logits(params, x)
    k_pages, v_pages = scatter_suffix_kv(k_pages, v_pages, phys, slots,
                                         torch.stack(k_new),
                                         torch.stack(v_new))
    return k_pages, v_pages, logits[0, length - 1].to(torch.float32)


# ---------------------------------------------------------------------------
# model holder
# ---------------------------------------------------------------------------

class LlamaForCausalLM:
    """What the serving engine needs of a model: ``config``, ``params``
    on ``device``, the KV ``cache_dtype`` and the ``page_size``.
    ``device=None`` means the GPU (and raises without one)."""

    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any],
                 cache_dtype: torch.dtype = torch.bfloat16,
                 page_size: int = 16, device=None):
        if cfg.num_experts:
            raise NotImplementedError("MoE FFN is not ported yet "
                                      "(ROADMAP Queue 1 item 3)")
        self.device = resolve_device(device)
        self.config = cfg
        self.params = _to_device(params, self.device)
        self.cache_dtype = cache_dtype
        self.page_size = page_size

    @classmethod
    def synthetic_q4(cls, cfg: LlamaConfig, device=None, seed: int = 0,
                     page_size: int = 16) -> "LlamaForCausalLM":
        """Random, already-quantized q4_0 weights made directly on the
        device from a seeded ``torch.Generator`` (the port of the JAX
        package's ``bench._synthetic_q4_llama_params``): no 28 GB of f32
        host weights for a 7B run. ``lm_head`` is quantized too; qkv and
        gate/up are fused."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        h, L = cfg.hidden_size, cfg.num_hidden_layers

        def q4(n, k, lead=()):
            q = torch.randint(0, 256, lead + (k // 2, n), generator=gen,
                              device=dev, dtype=torch.uint8)
            s = torch.empty(lead + (k // QK, n), device=dev,
                            dtype=torch.float32).uniform_(0.001, 0.02,
                                                          generator=gen)
            return {"q": q, "scale": s}

        shapes = linear_shapes(cfg)
        layers = {name: q4(*shapes[name], lead=(L,))
                  for name in _LAYER_LINEARS}
        layers["input_layernorm"] = torch.ones((L, h), dtype=torch.bfloat16,
                                               device=dev)
        layers["post_attention_layernorm"] = torch.ones(
            (L, h), dtype=torch.bfloat16, device=dev)
        embed = (torch.randn((cfg.vocab_size, h), generator=gen, device=dev)
                 * 0.02).to(torch.bfloat16)
        params = {"embed_tokens": embed,
                  "norm": torch.ones((h,), dtype=torch.bfloat16, device=dev),
                  "layers": layers,
                  "lm_head": q4(cfg.vocab_size, h)}
        return cls(cfg, fuse_decoder_params(params), page_size=page_size,
                   device=dev)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
