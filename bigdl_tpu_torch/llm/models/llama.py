"""Llama family — the port of ``bigdl_tpu/llm/models/llama.py``: the
config and its presets, random init, parameter fusion and q4_0
quantization, the layer math (``_linear``, ``rms_norm``, ``rope``,
``attention_qkv``, ``mlp``, ``_attention``), the dense-cache
``forward``, the token loops (``decode_scan`` over the dense cache,
``decode_scan_paged`` over a page pool), the serving engine's prefills
(``paged_prefill_ragged`` in place, ``paged_prefill_partial`` through a
dense staging cache), its mixed prefill+decode step
(``paged_step_mixed``) and speculative verify step (``paged_step_spec``),
and :class:`LlamaForCausalLM` with ``generate``. A config with
``num_experts`` runs the mixture-of-experts FFN (``_moe_ffn``, Mixtral)
in place of the SwiGLU MLP on every one of these paths.

Parameters are nested dicts of tensors with the JAX package's keys and
layouts: stacked per layer (``params["layers"][name]`` has a leading
``L`` dim), dense linears ``{"w": (N, K)}``, quantized linears in the
k-major kernel layout ``{"q": (K/2, N) uint8, "scale": (K/32, N) f32}``
(``bigdl_tpu_torch.llm.convert.params_from_numpy`` carries a JAX
package tree across). Layers run in a Python loop: PyTorch is eager, so
the JAX ``lax.scan`` has no counterpart to keep.

PyTorch runs eagerly, so there is no jit and no donation: ``forward``
writes the dense cache IN PLACE and ``decode_scan*`` are Python loops.

Parallelism over ``torch.distributed``: ``param_pspecs`` gives the JAX
package's tensor-parallel specs; :func:`shard_params` (and
``LlamaForCausalLM.shard``) keeps this rank's Megatron slices, with the
collectives in the forward (``_shard``); ``forward(ring=(mesh, axis))``
and ``LlamaForCausalLM.sequence_parallel`` run the prefill's attention
as ring attention over a sequence split across ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.llm.ggml.quantize import QK
from bigdl_tpu_torch.llm.kernels.int4_matmul import int4_matmul, quantize_tpu
from bigdl_tpu_torch.llm.kernels.paged_attention import LANE
from bigdl_tpu_torch.llm.kernels.sampling import sample_tokens
from bigdl_tpu_torch.llm.kvcache.prefill import (make_mixed_step,
                                                 make_partial_prefill,
                                                 make_spec_step)
from bigdl_tpu_torch.parallel.ring_attention import online_block_update

# the JAX package's refusal, word for word: its quantize_params keeps
# expert-stacked weights in bf16
_MOE_QUANT = ("MoE expert-stacked FFN weights are not ggml-quantized yet "
              "(experts stay bf16; attention linears of an MoE model can "
              "be quantized through LowBitLinear module surgery)")


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
    tie_word_embeddings: bool = False
    # cache windows larger than this use blockwise online-softmax attention
    # (the (Tq, S) score matrix never materialises beyond one block column)
    attn_block_size: int = 1024
    # Mistral-style sliding-window attention: position p attends only to
    # [p - sliding_window + 1, p]. None = full causal (Llama).
    sliding_window: Optional[int] = None
    # Qwen2-style attention bias on the q/k/v projections
    attention_bias: bool = False
    # "half" = Llama rotate-half; "glm" = interleaved pairs over the first
    # head_dim * partial_rotary_factor dims
    rope_mode: str = "half"
    partial_rotary_factor: float = 1.0
    # mixture-of-experts FFN (0 = the dense SwiGLU MLP); a capacity
    # factor <= 0 is the no-drop mode
    num_experts: int = 0
    num_experts_per_tok: int = 2
    expert_capacity_factor: float = 1.25

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls(vocab_size=128256, intermediate_size=14336,
                   num_key_value_heads=8, rope_theta=500000.0,
                   max_position_embeddings=8192)

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        """Mistral-7B-v0.1: Llama block structure + GQA(8) + 4k sliding
        window."""
        return cls(intermediate_size=14336, num_key_value_heads=8,
                   max_position_embeddings=8192, sliding_window=4096,
                   rms_norm_eps=1e-5, rope_theta=10000.0)

    @classmethod
    def qwen2_7b(cls) -> "LlamaConfig":
        """Qwen2-7B: Llama block + GQA(4) + q/k/v biases."""
        return cls(vocab_size=152064, hidden_size=3584,
                   intermediate_size=18944, num_hidden_layers=28,
                   num_attention_heads=28, num_key_value_heads=4,
                   max_position_embeddings=32768, rope_theta=1e6,
                   rms_norm_eps=1e-6, attention_bias=True)

    @classmethod
    def tiny_qwen2(cls, vocab: int = 256) -> "LlamaConfig":
        return cls(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128,
                   attention_bias=True)

    @classmethod
    def glm4_9b(cls) -> "LlamaConfig":
        """GLM-4-9B (the ChatGLM lineage): Llama-shaped block +
        interleaved partial rotary (first half of the head dims),
        GQA(2), q/k/v biases."""
        return cls(vocab_size=151552, hidden_size=4096,
                   intermediate_size=13696, num_hidden_layers=40,
                   num_attention_heads=32, num_key_value_heads=2,
                   max_position_embeddings=8192, rms_norm_eps=1.5625e-07,
                   rope_theta=10000.0, attention_bias=True,
                   rope_mode="glm", partial_rotary_factor=0.5)

    @classmethod
    def tiny_glm(cls, vocab: int = 256) -> "LlamaConfig":
        return cls(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128,
                   attention_bias=True, rope_mode="glm",
                   partial_rotary_factor=0.5)

    @classmethod
    def mixtral_8x7b(cls) -> "LlamaConfig":
        """Mixtral-8x7B: Mistral block + 8-expert top-2 MoE FFN."""
        return cls(intermediate_size=14336, num_key_value_heads=8,
                   max_position_embeddings=8192, rope_theta=1e6,
                   num_experts=8, num_experts_per_tok=2)

    @classmethod
    def tiny_moe(cls, vocab: int = 256) -> "LlamaConfig":
        """Test-size MoE config (4 experts, top-2)."""
        return cls(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128,
                   num_experts=4, num_experts_per_tok=2)

    @classmethod
    def tiny(cls, vocab: int = 256) -> "LlamaConfig":
        """Test-size config (the JAX package's ``LlamaConfig.tiny``)."""
        return cls(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128)

    @classmethod
    def from_hf(cls, hf_config) -> "LlamaConfig":
        """An HF config object (or any attribute shim over config.json)
        → LlamaConfig, field for field as the JAX package reads it."""
        g = (lambda k, d: getattr(hf_config, k, d))
        return cls(
            vocab_size=g("vocab_size", 32000),
            hidden_size=g("hidden_size", 4096),
            intermediate_size=g("intermediate_size", 11008),
            num_hidden_layers=g("num_hidden_layers", 32),
            num_attention_heads=g("num_attention_heads", 32),
            num_key_value_heads=g("num_key_value_heads",
                                  g("num_attention_heads", 32)),
            max_position_embeddings=g("max_position_embeddings", 4096),
            rms_norm_eps=g("rms_norm_eps", 1e-5),
            rope_theta=g("rope_theta", 10000.0),
            tie_word_embeddings=g("tie_word_embeddings", False),
            # Qwen2 configs carry sliding_window=4096 but apply it only
            # when use_sliding_window is set (HF default False)
            sliding_window=(g("sliding_window", None)
                            if g("use_sliding_window", True) else None),
            attention_bias=bool(g("attention_bias",
                                  g("model_type", "") == "qwen2")),
            rope_mode=("glm" if g("model_type", "") == "glm" else "half"),
            partial_rotary_factor=g("partial_rotary_factor", 1.0) or 1.0,
            num_experts=g("num_local_experts", 0) or 0,
            num_experts_per_tok=g("num_experts_per_tok", 2) or 2)


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


def init_params(cfg: LlamaConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> Dict[str, Any]:
    """Random-init params (tests and benchmarks without checkpoints), made
    on ``device`` (``None`` = the GPU) from a seeded ``torch.Generator``:
    the JAX package's shapes, scales (``1/sqrt(fan_in)``, 0.02 for the
    embedding) and dtypes. ``jax.random`` cannot be reproduced, so a test
    that needs the JAX package's weights carries them across with
    ``params_from_numpy``. Stacked weights are drawn one layer at a time
    (an MoE config's gate/up/down one expert at a time, as ``(L, E, N,
    K)`` stacks, beside the router ``(L, E, H)``) in f32 and cast, so
    the f32 temporary is one layer's or one expert's, not L layers'."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, L = cfg.hidden_size, cfg.num_hidden_layers

    def mk(shape, scale=None, lead=()):
        scale = scale or (1.0 / np.sqrt(shape[-1]))
        out = torch.empty(lead + shape, dtype=dtype, device=dev)
        for idx in np.ndindex(*lead):
            out[idx] = (torch.randn(shape, generator=gen, device=dev,
                                    dtype=torch.float32) * scale).to(dtype)
        return out

    shapes = linear_shapes(cfg)
    moe = ("gate_proj", "up_proj", "down_proj") if cfg.num_experts else ()
    layers: Dict[str, Any] = {
        name: {"w": mk(shape, lead=(L, cfg.num_experts) if name in moe
                       else (L,))}
        for name, shape in shapes.items()}
    if cfg.num_experts:
        layers["router"] = {"w": mk((cfg.num_experts, h), lead=(L,))}
    if cfg.attention_bias:
        for name in ("q_proj", "k_proj", "v_proj"):
            layers[name]["b"] = torch.zeros((L, shapes[name][0]),
                                            dtype=dtype, device=dev)
    layers["input_layernorm"] = torch.ones((L, h), dtype=dtype, device=dev)
    layers["post_attention_layernorm"] = torch.ones((L, h), dtype=dtype,
                                                    device=dev)
    params = {"embed_tokens": mk((cfg.vocab_size, h), 0.02),
              "norm": torch.ones((h,), dtype=dtype, device=dev),
              "layers": layers}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": mk((cfg.vocab_size, h))}
    return params


def fuse_decoder_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Concatenate per-layer q/k/v → ``qkv_proj`` and gate/up →
    ``gate_up_proj`` along the output dim: dense stacked ``w`` (L, N, K)
    on dim 1, k-major quantized ``q``/``scale`` (L, ·, N) on the last dim
    (q4_0 groups run along K, so an N-concat never mixes groups). MoE
    expert-stacked weights (L, E, N, K) stay unfused. Idempotent."""
    layers = dict(params["layers"])
    for fused, parts in _FUSED_LINEARS.items():
        if fused in layers or not all(p in layers for p in parts):
            continue
        ds = [layers[p] for p in parts]
        if "w" in ds[0]:
            if any(d["w"].dim() != 3 for d in ds):
                continue                      # MoE expert-stacked: skip
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


def quantize_params(params: Dict[str, Any], qtype: str = "sym_int4",
                    quantize_lm_head: bool = False,
                    fuse: bool = True) -> Dict[str, Any]:
    """q4_0-quantize every decoder linear (stacked per layer) into the
    k-major kernel layout, on the weights' own device; with ``fuse``,
    then concatenate qkv and gate/up. Norms and embeddings stay as they
    are; ``lm_head`` stays dense unless ``quantize_lm_head``.
    Bit-identical to the JAX package's ``quantize_params`` on the same
    weights; like it, refuses MoE expert-stacked weights."""
    if qtype != "sym_int4":
        raise NotImplementedError(
            "the decoder path implements q4_0 (sym_int4) only")
    if any(isinstance(d, dict) and "w" in d and d["w"].dim() == 4
           for d in params["layers"].values()):
        raise NotImplementedError(_MOE_QUANT)
    out = dict(params)
    layers = dict(params["layers"])
    names = [n for n in _LAYER_LINEARS + tuple(_FUSED_LINEARS)
             if n in layers and "w" in layers[n]]
    for name in names:
        w = layers[name]["w"]
        tds = [quantize_tpu(w[l], qtype) for l in range(w.shape[0])]
        nd = {"q": torch.stack([td["q"] for td in tds]),
              "scale": torch.stack([td["scale"] for td in tds])}
        if "b" in layers[name]:
            nd["b"] = layers[name]["b"]
        layers[name] = nd
    out["layers"] = layers
    if fuse:
        out = fuse_decoder_params(out)
    if quantize_lm_head and "lm_head" in out:
        td = quantize_tpu(out["lm_head"]["w"], qtype)
        out["lm_head"] = {"q": td["q"], "scale": td["scale"],
                          "qtype": qtype}
    return out


def layer_params(layers: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer ``l``'s slice of the stacked layer tree (views, no copy); a
    shard's entries that are not tensors pass as they are."""
    return {k: (layer_params(v, l) if isinstance(v, dict) else
                v[l] if isinstance(v, torch.Tensor) else v)
            for k, v in layers.items()}


def param_pspecs(params: Dict[str, Any],
                 ep_axis: Optional[str] = None) -> Dict[str, Any]:
    """The JAX package's tensor-parallel specs over the ``model`` axis:
    q/k/v, gate/up (fused or not) cut along N, o_proj / down_proj along
    K, the embedding and ``lm_head`` over the vocabulary, norms
    replicated. Expert-stacked MLP weights (L, E, N, K) and the router
    (L, E, H) split their expert dimension over ``ep_axis`` when given.
    Dense ``w`` leaves are (…, N, K), quantized ones k-major (…, K-ish,
    N). :func:`shard_params` keeps the slices these name, cut by whole
    heads."""
    from bigdl_tpu_torch.parallel.mesh import P
    row = {"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
           "qkv_proj", "gate_up_proj"}

    def spec_for(keys, leaf):
        d0 = 1 if "layers" in keys else 0      # skip the layer-stack dim
        nd = leaf.dim() if isinstance(leaf, torch.Tensor) else 0
        if "router" in keys:
            if ep_axis and nd > d0:
                spec = [None] * nd
                spec[d0] = ep_axis
                return P(*spec)
            return P()
        name = next((k for k in keys if k in row
                     or k in ("o_proj", "down_proj", "lm_head",
                              "embed_tokens")), None)
        if name is None or nd <= d0:
            return P()
        if (name in ("gate_proj", "up_proj", "down_proj")
                and keys[-1] == "w" and nd == d0 + 3):
            spec = [None] * nd
            spec[d0] = ep_axis
            spec[d0 + (2 if name == "down_proj" else 1)] = "model"
            return P(*spec)
        kmajor = keys[-1] in ("q", "scale", "zero")
        spec = [None] * nd
        if name in row or name in ("lm_head", "embed_tokens"):
            spec[-1 if kmajor else d0] = "model"
        elif kmajor:
            spec[d0] = "model"
        elif nd > d0 + 1:
            spec[d0 + 1] = "model"
        return P(*spec)

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + [k]) for k, v in tree.items()}
        return spec_for(keys, tree)

    return walk(params, [])


def shard_params(params: Dict[str, Any], cfg: LlamaConfig, mesh,
                 ep_axis: Optional[str] = None):
    """This rank's Megatron slices of ``params`` over the mesh's
    ``model`` axis (and its experts over ``ep_axis``), with the
    collectives its forward runs (``_shard``). Every rank passes the
    same whole tree. Returns ``(rank params, rank config)``."""
    from bigdl_tpu_torch.llm.models import _shard as sh
    w, r, group = sh._axis(mesh, "model")
    ep, er, ep_group = sh._axis(mesh, ep_axis)
    hd, inter = cfg.head_dim, cfg.intermediate_size
    q0, nq, kv0, nkv = sh.head_cut(cfg.num_attention_heads,
                                   cfg.num_key_value_heads, w, r)
    if inter % w:
        raise ValueError(f"intermediate size {inter} does not split over "
                         f"{w} ranks")
    if cfg.num_experts and cfg.num_experts % ep:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{ep} ranks")
    tp = sh.TensorShard(group, sh.vocab_cut(w, r, cfg.vocab_size))
    il = inter // w
    qh, kvh = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    qr = (q0 * hd, (q0 + nq) * hd)
    kvr = (kv0 * hd, (kv0 + nkv) * hd)
    ir = (r * il, (r + 1) * il)
    expert = None
    if cfg.num_experts:
        el = cfg.num_experts // ep
        expert = (er * el, (er + 1) * el)
    moe_sum = sh.GroupSum([group, ep_group])
    n_ranges = {
        "q_proj": [qr], "k_proj": [kvr], "v_proj": [kvr],
        "qkv_proj": [qr, (qh + kvr[0], qh + kvr[1]),
                     (qh + kvh + kvr[0], qh + kvh + kvr[1])],
        "gate_proj": [ir], "up_proj": [ir],
        "gate_up_proj": [ir, (inter + ir[0], inter + ir[1])]}
    layers = {}
    for name, d in params["layers"].items():
        stacked = isinstance(d, dict) and "w" in d and d["w"].dim() == 4
        if name in n_ranges:
            d = sh.cut_n(d, n_ranges[name], expert if stacked else None)
        elif name == "o_proj":
            d = sh.cut_k(d, *qr, tp.reduce)
        elif name == "down_proj":
            d = sh.cut_k(d, *ir, moe_sum if stacked else tp.reduce,
                         expert if stacked else None)
        if stacked:
            d = dict(d, e0=expert[0])
        layers[name] = d
    out = {k: v for k, v in params.items() if k not in ("layers",
                                                       "embed_tokens",
                                                       "lm_head")}
    out["layers"] = layers
    out["tp"] = tp
    emb = params["embed_tokens"]
    out["embed_tokens"] = emb if tp.vocab is None else \
        emb[tp.vocab[0]:tp.vocab[1]].contiguous()
    if "lm_head" in params:
        out["lm_head"] = sh.cut_head(params["lm_head"], tp.vocab, tp)
    rank_cfg = sh.RankConfig(cfg, num_attention_heads=nq,
                             num_key_value_heads=nkv, intermediate_size=il)
    return out, rank_cfg


# ---------------------------------------------------------------------------
# compute
# ---------------------------------------------------------------------------

def _linear(wd: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Dense or q4_0 matmul: x (..., K) → (..., N), plus an optional bias
    ``b``. A quantized weight goes through :func:`int4_matmul`, which
    launches the CUDA kernel for a CUDA x and takes the plain version
    for a CPU x."""
    reduce = wd.get("reduce")
    # a K-cut linear of a tensor-parallel shard: its partial product is
    # summed over the group (in f32 across ranks), the bias added after
    wide = reduce is not None and reduce.size > 1
    if "w" in wd:
        y = (x.to(torch.float32) @ wd["w"].t().to(torch.float32) if wide
             else x @ wd["w"].t().to(x.dtype))
    else:
        shape = x.shape
        y = int4_matmul(x.reshape(-1, shape[-1]), wd["q"], wd["scale"],
                        out_dtype=torch.float32 if wide else x.dtype)
        y = y.reshape(shape[:-1] + (y.shape[-1],))
    if reduce is not None:
        y = reduce(y).to(x.dtype)
    if "b" in wd:
        y = y + wd["b"].to(y.dtype)
    if "gather" in wd:
        y = wd["gather"].gather(y)
    return y


def rms_norm(x, w, eps: float):
    """Normalise in f32, cast to the model dtype, THEN scale by ``w``
    (the JAX package's cast order)."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x, positions, theta: float, mode: str = "half",
         partial: float = 1.0):
    """RoPE. x (B, T, H, D); positions (B, T) int.

    Both rotate the first ``rot = int(D * partial)`` dims and pass the
    rest through: ``mode="half"`` rotate-half (Llama over the full head
    dim; GPT-NeoX's ``_partial_rope`` over ``rotary_pct`` of it),
    ``mode="glm"`` interleaved pairs (2i, 2i+1)."""
    d = x.shape[-1]
    rot = int(d * partial)
    if rot == 0:
        return x
    pos = positions.to(torch.float32)[..., None]
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, rot, 2, dtype=torch.float32, device=x.device) / rot))
    ang = pos * inv_freq                                  # (B, T, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x_rot = (x if rot == d else x[..., :rot]).to(torch.float32)
    if mode == "glm":
        xr = x_rot.reshape(x.shape[:-1] + (rot // 2, 2))
        x1, x2 = xr[..., 0], xr[..., 1]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(x.shape[:-1] + (rot,))
    else:
        x1, x2 = torch.chunk(x_rot, 2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rot == d:
        return out.to(x.dtype)
    return torch.cat([out.to(x.dtype), x[..., rot:]], dim=-1)


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


def _moe_ffn(lp: Dict[str, Any], h: torch.Tensor,
             cfg: LlamaConfig) -> torch.Tensor:
    """Mixtral-style mixture of experts for one decoder layer: every token
    routes to its top-k experts with renormalised gates; the expert FFNs
    run in bf16 whatever the params' dtype, as the JAX package's do.

    Routing runs in f32 on the device: router logits, softmax, top-k,
    the gates divided by their sum. With ``expert_capacity_factor <= 0``
    (no-drop mode) every expert runs on every token and its output is
    weighted by the token's scattered gates. Otherwise each expert takes
    at most ``C = ceil(S·k/E · factor)`` of the call's S rows (every row:
    padding and inactive rows count, as in the JAX package): the (token,
    slot) pairs are ranked slot-major (every token's best expert first)
    by a cumulative count, and a pair past its expert's capacity drops
    silently. ``C`` comes from the static shape and nothing is read on
    the host, so the layer runs inside a CUDA graph.

    The expert products are ``torch.matmul`` on transposed views of the
    ``(E, N, K)`` weights (batched over experts, no weight copy); the
    dispatch gathers each kept pair's row into its ``(expert, slot)``
    place and the combine gathers it back, where the JAX package
    contracts one-hot dispatch tensors (the same values: each place
    holds at most one row)."""
    b, t, hd = h.shape
    S = b * t
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    dev, bf = h.device, torch.bfloat16
    x = h.reshape(S, hd)
    logits = x.to(torch.float32) @ lp["router"]["w"].to(torch.float32).t()
    probs = torch.softmax(logits, dim=-1)                   # (S, E)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)      # (S, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    wg, wu, wd = (lp[n]["w"].to(bf)
                  for n in ("gate_proj", "up_proj", "down_proj"))
    # an expert-parallel shard runs its experts [e0, e0 + El) only, and
    # sums its part of every token's output over the groups
    e0, El = lp["gate_proj"].get("e0", 0), wg.shape[0]
    reduce = lp["down_proj"].get("reduce")

    def experts(xin):
        """(E, R, H) bf16 rows → (E, R, H) bf16 expert outputs."""
        gate = torch.matmul(xin, wg.transpose(1, 2))        # (E, R, I)
        up = torch.matmul(xin, wu.transpose(1, 2))
        act = (F.silu(gate.to(torch.float32))
               * up.to(torch.float32)).to(bf)
        return torch.matmul(act, wd.transpose(1, 2))        # (E, R, H)

    if not cfg.expert_capacity_factor or cfg.expert_capacity_factor <= 0:
        w_full = torch.zeros((S, E), dtype=torch.float32, device=dev
                             ).scatter_(1, gate_idx, gate_vals)
        out = experts(x.to(bf).expand(El, S, hd))          # (El, S, H)
        y = torch.bmm(w_full[:, e0:e0 + El].to(bf)[:, None, :],
                      out.transpose(0, 1))
        if reduce is not None:
            y = reduce(y)
        return y.reshape(b, t, hd).to(h.dtype)

    C = max(int(np.ceil(S * K / E * cfg.expert_capacity_factor)), 1)
    # slot-major order: slot 0 of every token first
    expert_of = gate_idx.t().reshape(-1)                    # (K*S,)
    gates = gate_vals.t().reshape(-1)
    sel = (expert_of[:, None] == torch.arange(E, device=dev)).to(
        torch.float32)                                      # (K*S, E)
    pos = ((torch.cumsum(sel, dim=0) - sel) * sel).sum(-1)
    local = expert_of - e0
    keep = (pos < C) & (local >= 0) & (local < El)
    # a kept pair's place in this rank's flat (El*C) slots; a dropped
    # pair (or another rank's) goes to row El*C, a zero row the combine
    # reads back as nothing
    place = torch.where(keep, local * C + pos.to(torch.int64),
                        torch.full_like(expert_of, El * C))
    xin = torch.zeros((El * C + 1, hd), dtype=bf, device=dev)
    xin.index_copy_(0, place, x.to(bf).repeat(K, 1))
    out = experts(xin[:El * C].view(El, C, hd)).reshape(El * C, hd)
    out = torch.cat([out, torch.zeros((1, hd), dtype=bf, device=dev)])
    y = (gates.to(bf).to(torch.float32)[:, None]
         * out.index_select(0, place).to(torch.float32)).to(bf)
    y = y.reshape(K, S, hd).sum(dim=0)
    if reduce is not None:
        y = reduce(y)
    return y.reshape(b, t, hd).to(h.dtype)


def lm_logits(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Final projection: the (possibly quantized) ``lm_head``, or the
    embedding-tied plain matmul."""
    head = params.get("lm_head")
    if head is None:
        logits = x @ params["embed_tokens"].t().to(x.dtype)
        tp = params.get("tp")
        return logits if tp is None or tp.vocab is None else \
            tp.gather(logits)
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
    if cfg.num_experts:
        x = x + _moe_ffn(lp, h2, cfg)
    else:
        x = x + mlp(lp, h2, x.dtype)
    return x, k, v


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """The dense KV cache ``{"k", "v": (L, B, max_len, Hkv, D), "pos"}``
    on ``device`` (``None`` = the GPU); ``pos`` is a Python int, the
    number of positions written."""
    dev = resolve_device(device)
    shape = (cfg.num_hidden_layers, batch, max_len,
             cfg.num_key_value_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": 0}


def _attention(q, k_all, v_all, q_positions, kv_len_mask, cfg,
               alibi_slopes=None):
    """q (B, Tq, Hq, D); k_all/v_all (B, S, Hkv, D), the full cache
    window; kv_len_mask (B or 1, S) True where the slot is valid;
    q_positions (B, Tq). Slot ``s`` attends iff ``s <= q_position`` (and
    ``s > q_position - sliding_window``). ``alibi_slopes`` (Hq,) adds
    Bloom-style per-head linear position biases (single-block path only).
    Returns (B, Tq, Hq·D) in q's dtype.

    GQA-aware: query heads are grouped onto their kv head inside the
    einsum, repeated K/V is never materialised. Scores, softmax and the
    V product run in f32 on f32 copies (the JAX einsums'
    ``preferred_element_type=float32``). A window longer than
    ``cfg.attn_block_size`` goes blockwise with the online softmax of
    :func:`online_block_update`, so one (Tq × block) score column lives
    at a time, never the (Tq × S) matrix. The last block is shorter
    instead of padded as in the JAX package: padded slots are masked and
    add exactly 0, so the result is the same."""
    b, tq, hq, d = q.shape
    s, hkv = k_all.shape[1], k_all.shape[2]
    g = hq // hkv
    qg = q.reshape(b, tq, hkv, g, d).to(torch.float32)
    scale = 1.0 / math.sqrt(d)
    qpos = q_positions.to(torch.int64)                      # (B, Tq)

    def _causal(slot_idx):
        """(B, Tq, S') causal (+ sliding window) mask for slot indices."""
        m = slot_idx[None, None, :] <= qpos[..., None]
        if cfg.sliding_window is not None:
            m &= slot_idx[None, None, :] > (qpos[..., None]
                                            - cfg.sliding_window)
        return m

    slots = torch.arange(s, device=q.device)
    if s <= cfg.attn_block_size:
        logits = torch.einsum("bthgd,bshd->bhgts", qg,
                              k_all.to(torch.float32)) * scale
        if alibi_slopes is not None:
            slopes = alibi_slopes.to(torch.float32).reshape(hkv, g)
            logits = logits + (slopes[None, :, :, None, None]
                               * slots.to(torch.float32))
        mask = _causal(slots) & kv_len_mask[:, None, :]     # (B, Tq, S)
        logits = logits.masked_fill_(~mask[:, None, None], -1e30)
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgts,bshd->bthgd", p, v_all.to(torch.float32))
        return out.to(q.dtype).reshape(b, tq, hq * d)

    if alibi_slopes is not None:
        raise NotImplementedError(
            "ALiBi rides the single-block path: set attn_block_size >= "
            "max_position_embeddings on ALiBi configs")
    blk = cfg.attn_block_size
    kv_len_mask = kv_len_mask.expand(b, s)
    acc = torch.zeros((b, hkv, g, tq, d), dtype=torch.float32,
                      device=q.device)
    rmax = torch.full((b, hkv, g, tq), -1e30, dtype=torch.float32,
                      device=q.device)
    rsum = torch.zeros((b, hkv, g, tq), dtype=torch.float32,
                       device=q.device)
    for s0 in range(0, s, blk):
        cols = slice(s0, min(s0 + blk, s))
        mask = _causal(slots[cols]) & kv_len_mask[:, None, cols]
        acc, rmax, rsum = online_block_update(
            qg, k_all[:, cols], v_all[:, cols], mask, acc, rmax, rsum,
            scale=scale)
    out = (acc / torch.clamp(rsum, min=1e-30)[..., None]).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq * d)


def _embed(params, cfg, toks, positions):
    """The llama family's input: the token embedding rows."""
    from bigdl_tpu_torch.llm.models._shard import embed_rows
    return embed_rows(params["embed_tokens"], toks, params.get("tp"))


def _head(params, cfg, x):
    """The llama family's output: final RMSNorm, then the (possibly
    quantized or tied) head."""
    return lm_logits(params, rms_norm(x, params["norm"], cfg.rms_norm_eps))


def dense_forward(params, cfg, tokens, cache, positions, *, embed, layer,
                  head, alibi_slopes=None):
    """The dense-cache forward pass of any family, from its three parts:
    ``embed(params, cfg, toks, positions) -> x``, the decoder
    ``layer(lp, x, positions, cfg, attend, kv_dtype=None) -> (x, k, v)``
    and ``head(params, cfg, x) -> logits``. Each layer writes its K/V
    into the cache at ``cache["pos"]`` IN PLACE and attends the cache
    window through :func:`_attention` (with ``alibi_slopes``, Bloom's
    ALiBi biases). Returns ``(logits (B, T, V) f32, cache)``."""
    k_cache, v_cache = cache["k"], cache["v"]
    start, t = int(cache["pos"]), tokens.shape[1]
    s_max = k_cache.shape[2]
    if start + t > s_max:
        raise ValueError(f"writing {t} positions at {start} overflows the "
                         f"cache of {s_max}")
    x = embed(params, cfg, tokens.long(), positions)       # (B, T, H)
    valid = (torch.arange(s_max, device=x.device) < start + t)[None, :]

    def attend(l, q, k, v):
        k_cache[l, :, start:start + t] = k.to(k_cache.dtype)
        v_cache[l, :, start:start + t] = v.to(v_cache.dtype)
        return _attention(q, k_cache[l], v_cache[l], positions, valid, cfg,
                          alibi_slopes=alibi_slopes)

    for l in range(cfg.num_hidden_layers):
        x, _, _ = layer(layer_params(params["layers"], l), x, positions, cfg,
                        lambda q, k, v, l=l: attend(l, q, k, v))
    logits = head(params, cfg, x)
    return logits.to(torch.float32), {"k": k_cache, "v": v_cache,
                                      "pos": start + t}


def forward(params: Dict[str, Any], cfg: LlamaConfig, tokens: torch.Tensor,
            cache: Dict[str, Any], positions: torch.Tensor,
            ring: Optional[tuple] = None,
            unroll: int = 1) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One forward pass over ``tokens`` (B, T), writing their K/V into the
    dense cache at ``cache["pos"]`` and attending the cache window;
    returns ``(logits (B, T, V) f32, new_cache)``. Works for prefill
    (T = prompt length) and decode (T = 1).

    The cache is written IN PLACE (the JAX package donates it; here the
    returned dict holds the same tensors): a caller that still needs the
    old cache must copy it first. ``unroll`` > 1 unrolled the JAX layer
    scan and has no meaning in eager PyTorch.

    ``ring=(mesh, axis)`` runs attention as ring attention over the
    sequence split across ``axis`` (:func:`ring_forward`). Only valid for
    a prefill from an empty cache at positions 0..T-1 (attention is over
    the current tokens, not the cache window); the facade enforces it."""
    if unroll not in (0, 1):
        raise NotImplementedError(
            "unroll= unrolls the JAX package's layer scan; it is not "
            "applicable in eager PyTorch, where layers run in a loop")
    parts = dict(embed=_embed, layer=decoder_layer, head=_head)
    if ring is not None:
        return ring_forward(params, cfg, tokens, cache, positions, ring,
                            **parts)
    return dense_forward(params, cfg, tokens, cache, positions, **parts)


def ring_forward(params, cfg, tokens, cache, positions, ring, *, embed,
                 layer, head):
    """The sequence-parallel prefill of any family: every rank passes the
    whole (B, T) prompt, keeps its T / n tokens of it (``n`` the size of
    ring axis ``ring[1]`` of mesh ``ring[0]``), runs the layers on them
    with ring attention (:func:`~bigdl_tpu_torch.parallel.ring_attention.
    ring_self_attention`, causal, on the projections before the cache
    cast, as the JAX ring does), and writes every layer's whole K/V into
    its cache (each chunk gathered over the ring), so decode continues
    from the cache on every rank. Returns the whole ``(logits (B, T, V)
    f32, cache)`` on every rank."""
    from bigdl_tpu_torch.parallel.collectives import all_gather
    from bigdl_tpu_torch.parallel.mesh import mesh_axis_size
    from bigdl_tpu_torch.parallel.ring_attention import ring_self_attention
    mesh, axis = ring
    n = mesh_axis_size(mesh, axis)
    g = mesh.get_group(axis)
    r = mesh.get_local_rank(axis)
    b, t = tokens.shape
    if int(cache["pos"]) != 0 or t % n:
        raise ValueError(f"the ring prefill takes {t} tokens from an empty "
                         f"cache over {n} ranks: T must split evenly and "
                         "the cache must be empty")
    k_cache, v_cache = cache["k"], cache["v"]
    if t > k_cache.shape[2]:
        raise ValueError(f"writing {t} positions overflows the cache of "
                         f"{k_cache.shape[2]}")
    tl = t // n
    toks = tokens[:, r * tl:(r + 1) * tl].long()
    pos = positions[:, r * tl:(r + 1) * tl]

    def attend(l, q, k, v):
        k_cache[l, :, :t] = all_gather(k.to(k_cache.dtype), g, axis=1)
        v_cache[l, :, :t] = all_gather(v.to(v_cache.dtype), g, axis=1)
        return ring_self_attention(q, k, v, g, causal=True)

    x = embed(params, cfg, toks, pos)
    for l in range(cfg.num_hidden_layers):
        x, _, _ = layer(layer_params(params["layers"], l), x, pos, cfg,
                        lambda q, k, v, l=l: attend(l, q, k, v))
    logits = all_gather(head(params, cfg, x).to(torch.float32), g, axis=1)
    return logits, {"k": k_cache, "v": v_cache, "pos": t}


def ragged_prefill(params, cfg, k_pages, v_pages, toks, length, offset,
                   bt_row, phys, slots, fork_dst, fork_src, *, page: int,
                   full_logits: bool = False, embed, layer, head):
    """:func:`paged_prefill_ragged` of any family, from the three parts
    :func:`dense_forward` takes."""
    from bigdl_tpu_torch.llm.kvcache.prefill import (device_i32,
                                                     fork_tail_pages,
                                                     ragged_prefill_attend,
                                                     scatter_suffix_kv)
    bucket, dev = toks.shape[1], toks.device
    offset, length = device_i32(offset, dev), device_i32(length, dev)
    k_pages, v_pages = fork_tail_pages(k_pages, v_pages, fork_dst,
                                       fork_src)
    positions = (offset + torch.arange(bucket, dtype=torch.int32,
                                       device=dev))[None]
    x = embed(params, cfg, toks.long(), positions)          # (1, Tq, H)
    attend_l = ragged_prefill_attend(k_pages, v_pages, bt_row, offset,
                                     length, page=page,
                                     sliding_window=cfg.sliding_window)
    k_new, v_new = [], []
    for l in range(cfg.num_hidden_layers):
        # the suffix K/V are attended at POOL precision: a later
        # re-prefill reads them back from the pages, so greedy parity
        # needs the cast BEFORE attention, not just at the scatter
        x, k, v = layer(layer_params(params["layers"], l), x, positions, cfg,
                        lambda q, k, v, l=l: attend_l(l, q, k, v),
                        kv_dtype=k_pages.dtype)
        k_new.append(k[0])
        v_new.append(v[0])
    logits = head(params, cfg, x)
    k_pages, v_pages = scatter_suffix_kv(k_pages, v_pages, phys, slots,
                                         torch.stack(k_new),
                                         torch.stack(v_new))
    if full_logits:
        return k_pages, v_pages, logits[0].to(torch.float32)
    # the last true token's row, picked by a device index
    last = logits[0].index_select(0, (length - 1).reshape(1).long())[0]
    return k_pages, v_pages, last.to(torch.float32)


def paged_prefill_ragged(params, cfg: LlamaConfig, k_pages, v_pages, toks,
                         length, offset, bt_row, phys, slots, fork_dst,
                         fork_src, *, page: int, full_logits: bool = False):
    """Ragged in-place prefill: the suffix tokens run through the layer
    math while attention reads the cached prefix directly from the page
    pool (kernels/ragged_prefill.py); after the layers, one scatter
    writes every layer's suffix K/V into the pools IN PLACE. The COW
    tail fork is one page copy ahead of the layers (a trash self-copy
    with no tail).

    toks (1, bucket) int; ``length``/``offset`` the true suffix length
    and its start position, and ``fork_dst``/``fork_src`` the fork's
    pages, as int32 device scalars (as in the JAX entry point) or ints;
    bt_row (pages_cap,) int32; phys/slots (bucket,) scatter targets
    (padding routed to trash page 0). Nothing here reads a device value
    on the host, so the prefill can run inside a CUDA graph (the engine's
    mixed step) and the whole-prompt prefill calls the same body.
    Returns ``(k_pages, v_pages, last_logits (V,) f32)``; with
    ``full_logits=True`` (the speculative verify leg) the logits of
    every bucket row instead, ``(bucket, V)`` f32."""
    return ragged_prefill(params, cfg, k_pages, v_pages, toks, length,
                          offset, bt_row, phys, slots, fork_dst, fork_src,
                          page=page, full_logits=full_logits, embed=_embed,
                          layer=decoder_layer, head=_head)


# the dense staging prefill behind LLMServer(ragged_prefill=False): the
# suffix through forward() over the gathered prefix, see kvcache/prefill.py
paged_prefill_partial = make_partial_prefill(forward, init_cache)


def paged_step_mixed(params, cfg, k_pages, v_pages, bt, lens, last,
                     active, temperature, generator, ctoks, clen, coff,
                     cbt_row, cphys, cslots, fork_dst, fork_src, *,
                     page: int, do_sample: bool = False, top_k: int = 0):
    """The engine's unified mixed prefill+decode step for the llama
    family: :func:`paged_prefill_ragged` over one chunk, then the sampled
    decode step over every row (``kvcache.prefill.make_mixed_step``).
    Returns ``(toks, logits, k_pages, v_pages, new_lens, clast)``."""
    from bigdl_tpu_torch.llm.serving import paged_decode_step
    return make_mixed_step(paged_decode_step, paged_prefill_ragged)(
        params, cfg, k_pages, v_pages, bt, lens, last, active,
        temperature, generator, ctoks, clen, coff, cbt_row, cphys, cslots,
        fork_dst, fork_src, page=page, do_sample=do_sample, top_k=top_k)


def paged_step_spec(params, cfg, k_pages, v_pages, bt, lens, last, active,
                    temperature, generator, srow, ctoks, n_draft, cbt_row,
                    cphys, cslots, *, page: int, do_sample: bool = False,
                    top_k: int = 0):
    """The engine's speculative verify step for the llama family: one
    row's drafts as a :func:`paged_prefill_ragged` chunk with full
    logits and the greedy accept, beside the sampled decode step over
    every other row (``kvcache.prefill.make_spec_step``). Returns
    ``(out (B + 1 + W,) int32, logits, k_pages, v_pages, new_lens)``."""
    from bigdl_tpu_torch.llm.serving import paged_decode_step
    return make_spec_step(paged_decode_step, paged_prefill_ragged)(
        params, cfg, k_pages, v_pages, bt, lens, last, active,
        temperature, generator, srow, ctoks, n_draft, cbt_row, cphys,
        cslots, page=page, do_sample=do_sample, top_k=top_k)


# ---------------------------------------------------------------------------
# token loops
# ---------------------------------------------------------------------------

def _pick_token(logits, generator, do_sample: bool, temperature,
                top_k: int):
    """logits (B, V) → (B,) int32 next tokens (the engine's
    :func:`sample_tokens`, noise from ``generator``)."""
    return sample_tokens(logits, generator, do_sample=do_sample,
                         temperature=temperature, top_k=top_k)


def _next_tokens(last, generator, temperature, finished, do_sample, top_k,
                 eos_token_id):
    nxt = _pick_token(last, generator, do_sample, temperature, top_k)
    if eos_token_id is not None:
        nxt = torch.where(finished, torch.full_like(nxt, eos_token_id), nxt)
        finished = finished | (nxt == eos_token_id)
    return nxt, finished


def decode_scan(params, cache, last_logits, generator, temperature,
                finished=None, *, cfg, num_tokens: int,
                do_sample: bool = False, top_k: int = 0,
                eos_token_id: Optional[int] = None, forward_fn=None):
    """``num_tokens`` autoregressive steps over the dense cache: each step
    picks a token from the previous logits and runs it through
    ``forward_fn`` (the family's dense forward; :func:`forward` by
    default) at position ``cache["pos"]``.

    Returns ``(tokens (B, num_tokens) int32, cache, last_logits,
    generator, finished)``. After EOS a row keeps emitting
    ``eos_token_id`` (HF padding semantics); ``finished`` (B,) bool
    carries that state across calls, so a caller decoding in chunks must
    pass the returned mask back in."""
    b = last_logits.shape[0]
    if finished is None:
        finished = torch.zeros((b,), dtype=torch.bool,
                               device=last_logits.device)
    forward_fn = forward_fn or forward
    last, toks = last_logits, []
    for _ in range(num_tokens):
        nxt, finished = _next_tokens(last, generator, temperature, finished,
                                     do_sample, top_k, eos_token_id)
        pos = torch.full((b, 1), int(cache["pos"]), dtype=torch.int32,
                         device=nxt.device)
        logits, cache = forward_fn(params, cfg, nxt[:, None], cache, pos)
        last = logits[:, -1]
        toks.append(nxt)
    return torch.stack(toks, dim=1), cache, last, generator, finished


def pageify_cache(cache: Dict[str, Any], page: int = 16
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense prefill cache (L, B, S, H, D) → page pools (L, 1 + B·maxp,
    H, page, D) and block tables (B, maxp) int32: row ``i`` gets the
    contiguous page run ``1 + i·maxp ..`` (page 0 is the trash page, as
    in the serving allocator), ``maxp`` padded to the JAX kernel's
    ``LANE // page`` multiple. Bit-identical to the JAX package's."""
    if page <= 0 or LANE % page:
        raise ValueError(
            f"page_size {page} must divide the kernel lane width "
            f"{LANE} (8/16/32/64/128)")
    k, v = cache["k"], cache["v"]
    L, B, S, H, D = k.shape
    ppb = LANE // page
    cap = -(-S // page)
    maxp = -(-cap // ppb) * ppb

    full, rem = divmod(S, page)

    def pageify(a):
        # (L, B, S, H, D) -> (L, 1 + B*maxp, H, page, D); the trash page,
        # the tail of the last page and the padding pages stay zero
        pages = torch.zeros((L, 1 + B * maxp, H, page, D), dtype=a.dtype,
                            device=a.device)
        body = pages[:, 1:].view(L, B, maxp, H, page, D)
        body[:, :, :full] = a[:, :, :full * page].reshape(
            L, B, full, page, H, D).permute(0, 1, 2, 4, 3, 5)
        if rem:
            body[:, :, full, :, :rem] = a[:, :, full * page:].permute(
                0, 1, 3, 2, 4)
        return pages

    bt = 1 + (torch.arange(B, device=k.device)[:, None] * maxp
              + torch.arange(maxp, device=k.device)[None, :]).to(torch.int32)
    return pageify(k), pageify(v), bt


class PagedDecodeLoop:
    """The token loop of :func:`decode_scan_paged` over persistent
    buffers. One token's step — pick it from ``last`` (with the EOS
    rule), run it through ``step_fn``, the family's paged decode step
    (the serving engine's llama ``paged_decode_step`` by default), at
    position ``lens``, write back ``last``, ``finished`` and ``lens + 1``
    in place — is a :class:`CapturedStep`, replayed once a token: the
    port's ``jax.jit(decode_scan_paged)``. Each token is copied out of
    the step's output buffer before the next replay. The graph holds the
    addresses of the pools and ``bt``, so a loop serves one set of pools
    (``generate`` makes one a call); ``close()`` frees it. ``capture=False``
    runs the step eagerly every token (a tensor-parallel shard over gloo:
    its collectives run on the host, which no graph may hide)."""

    def __init__(self, params, cfg, k_pages, v_pages, bt, pos, last_logits,
                 generator, temperature, finished=None, *, page: int,
                 do_sample: bool = False, top_k: int = 0,
                 eos_token_id: Optional[int] = None, step_fn=None,
                 capture: bool = True):
        from bigdl_tpu_torch.llm.graphs import CapturedStep
        if step_fn is None:
            from bigdl_tpu_torch.llm.serving import paged_decode_step
            step_fn = paged_decode_step
        b, dev = last_logits.shape[0], last_logits.device
        self.pos = int(pos)
        # the buffers the step reads and writes; its closure holds them,
        # not this object, so no reference cycle keeps the pools alive
        self.last = last = last_logits.to(torch.float32).clone()
        self.finished = fin = (
            torch.zeros((b,), dtype=torch.bool, device=dev)
            if finished is None else finished.clone())
        lens = torch.full((b,), self.pos, dtype=torch.int32, device=dev)
        self.tok = tok = torch.zeros((b,), dtype=torch.int32, device=dev)

        def step():
            nxt, fin_new = _next_tokens(last, generator, temperature, fin,
                                        do_sample, top_k, eos_token_id)
            logits, kp, vp = step_fn(
                params, cfg, k_pages, v_pages, bt, lens, nxt, page=page)
            if kp is not k_pages or vp is not v_pages:
                raise RuntimeError("the decode step must write the pools "
                                   "in place: a graph holds their addresses")
            tok.copy_(nxt)
            fin.copy_(fin_new)
            last.copy_(logits)
            lens.add_(1)

        self.step = CapturedStep(step, dev, generators=(
            (generator,) if do_sample else ()), eager=not capture)

    def run(self, num_tokens: int) -> torch.Tensor:
        """``num_tokens`` steps; returns their tokens (B, num_tokens)
        int32 on the device."""
        toks = torch.empty((self.tok.shape[0], num_tokens),
                           dtype=torch.int32, device=self.tok.device)
        for t in range(num_tokens):
            self.step()
            toks[:, t] = self.tok
        self.pos += num_tokens
        return toks

    def close(self):
        self.step.close()


def decode_scan_paged(params, k_pages, v_pages, bt, pos, last_logits,
                      generator, temperature, finished=None, *, cfg,
                      page: int, num_tokens: int, do_sample: bool = False,
                      top_k: int = 0, eos_token_id: Optional[int] = None):
    """The :func:`decode_scan` token loop over a PAGED pool, through the
    serving engine's ``paged_decode_step``: attention reads only the live
    pages (the stats kernel plus the merge of the current token), and
    each step writes every layer's new K/V into the pools in place. On
    the card the step runs as one CUDA graph from the second token on
    (:class:`PagedDecodeLoop`). ``pos`` is the shared position (generate
    is rectangular). Returns ``(tokens (B, T) int32, k_pages, v_pages,
    pos, last, generator, finished)``."""
    loop = PagedDecodeLoop(params, cfg, k_pages, v_pages, bt, pos,
                           last_logits, generator, temperature, finished,
                           page=page, do_sample=do_sample, top_k=top_k,
                           eos_token_id=eos_token_id)
    try:
        toks = loop.run(num_tokens)
    finally:
        loop.close()
    return (toks, k_pages, v_pages, loop.pos, loop.last, generator,
            loop.finished)


def as_tokens(ids, device) -> torch.Tensor:
    """Token ids (a tensor, array or nested list) as int32 on ``device``."""
    if isinstance(ids, torch.Tensor):
        return ids.to(device, torch.int32)
    return torch.as_tensor(np.asarray(ids), dtype=torch.int32, device=device)


def generate_tokens(model, input_ids, max_new_tokens: int, *, forward_fn,
                    step_fn=None, do_sample: bool = False,
                    temperature: float = 1.0, top_k: int = 0,
                    eos_token_id: Optional[int] = None, seed: int = 0,
                    decode_chunk: int = 32) -> np.ndarray:
    """``generate`` of any family's model holder (``model(tokens)`` is its
    dense prefill; ``device``, ``params``, ``config``, ``page_size`` and
    ``max_cache_len`` as :class:`LlamaForCausalLM` has them): one dense
    prefill, then the token loop in chunks of ``decode_chunk`` when
    ``eos_token_id`` is set (the host stops once every row finished),
    else in one go. With ``step_fn``, the family's paged decode step,
    the loop runs over a page pool cut from the prefill cache
    (:class:`PagedDecodeLoop`, one captured step for the whole call);
    without, over the dense cache through ``forward_fn``
    (:func:`decode_scan`), eagerly. Returns (B, T0 + new) int32 numpy."""
    tokens = as_tokens(input_ids, model.device)
    b, t0 = tokens.shape
    if t0 + max_new_tokens > model.max_cache_len:
        raise ValueError(
            f"sequence {t0}+{max_new_tokens} exceeds cache "
            f"{model.max_cache_len}")
    logits, cache = model(tokens)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    last = logits[:, -1].clone()       # not a view pinning (B, T, V)
    del logits
    pieces = [tokens.cpu().numpy()]
    remaining = max_new_tokens
    chunk = max_new_tokens if eos_token_id is None else decode_chunk
    finished = torch.zeros((b,), dtype=torch.bool, device=model.device)
    kw = dict(do_sample=do_sample, top_k=top_k, eos_token_id=eos_token_id)
    loop = None
    with torch.no_grad():
        if step_fn is not None:
            k_pages, v_pages, bt = pageify_cache(cache, page=model.page_size)
            tp = model.params.get("tp")
            loop = PagedDecodeLoop(
                model.params, model.config, k_pages, v_pages, bt,
                cache["pos"], last, gen, temperature, finished,
                page=model.page_size, step_fn=step_fn,
                capture=tp is None or tp.capturable, **kw)
            del cache, k_pages, v_pages
        try:
            while remaining > 0:
                n = min(chunk, remaining)
                if loop is not None:
                    toks, finished = loop.run(n), loop.finished
                else:
                    toks, cache, last, gen, finished = decode_scan(
                        model.params, cache, last, gen, temperature,
                        finished, cfg=model.config, num_tokens=n,
                        forward_fn=forward_fn, **kw)
                pieces.append(toks.cpu().numpy())
                remaining -= n
                if eos_token_id is not None and bool(finished.all()):
                    break
        finally:
            if loop is not None:
                loop.close()
    return np.concatenate(pieces, axis=1)


# ---------------------------------------------------------------------------
# model holder
# ---------------------------------------------------------------------------

class ModelHolder:
    """What every family's model holder carries, as the serving engine
    and ``generate`` read it: ``config``, ``params`` on ``device``, the
    KV ``cache_dtype``, ``page_size``, ``paged_decode`` and
    ``max_cache_len`` (at most the config's positions); and ``__call__``,
    a forward through the class's ``_forward`` / ``_init_cache`` (the
    family's, set as ``staticmethod`` class attributes).
    ``device=None`` means the GPU (and raises without one)."""

    _forward = None
    _init_cache = None

    def __init__(self, cfg, params: Dict[str, Any], max_cache_len: int = 512,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 paged_decode: bool = True, page_size: int = 16,
                 device=None):
        self.device = resolve_device(device)
        self.config = cfg
        self.params = _to_device(params, self.device)
        self.cache_dtype = cache_dtype
        self.max_cache_len = min(max_cache_len, cfg.max_position_embeddings)
        self.paged_decode = paged_decode
        self.page_size = page_size

    def __call__(self, tokens, cache=None, positions=None):
        """Forward ``tokens`` (B, T) from ``cache`` (a fresh dense cache of
        ``max_cache_len`` in ``cache_dtype`` when None) at ``positions``
        (default ``cache["pos"] + 0..T-1``); returns ``(logits (B, T, V)
        f32, cache)``. A cache passed in is written in place."""
        tokens = as_tokens(tokens, self.device)
        b, t = tokens.shape
        if cache is None:
            cache = type(self)._init_cache(self.config, b, self.max_cache_len,
                                           dtype=self.cache_dtype,
                                           device=self.device)
        if positions is None:
            positions = (int(cache["pos"]) + torch.arange(
                t, dtype=torch.int32, device=self.device)).expand(b, t)
        with torch.no_grad():
            return type(self)._forward(self.params, self.config, tokens,
                                       cache, positions)


class LlamaForCausalLM(ModelHolder):
    """Generation facade of the Llama stack (:class:`ModelHolder` over
    :func:`forward`), with sampling in ``generate``.

    ``paged_decode`` (default) runs ``generate``'s token loop over a page
    pool (:class:`PagedDecodeLoop`): the dense prefill cache is cut into
    pages once, attention reads only live pages each token, and on the
    card the token step replays one CUDA graph from the second token on.
    ``paged_decode=False`` keeps the dense-cache loop
    (:func:`decode_scan`), eagerly: ``forward`` slices the cache at a
    host position, which a graph would bake in. ``decode_unroll`` unrolled the JAX layer scan
    and only 1 is meaningful here.

    ``shard(mesh)`` keeps this rank's tensor-parallel slices
    (:func:`shard_params`); ``sequence_parallel(mesh, axis)`` runs the
    prefill of a fresh prompt as ring attention over ``axis``. Every
    rank of the group calls the same entry points on the same inputs."""

    _forward = staticmethod(forward)
    _init_cache = staticmethod(init_cache)

    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any],
                 max_cache_len: int = 512,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 decode_unroll: int = 1, paged_decode: bool = True,
                 page_size: int = 16, device=None):
        if decode_unroll not in (0, 1):
            raise NotImplementedError(
                "decode_unroll unrolls the JAX package's layer scan; it is "
                "not applicable in eager PyTorch")
        super().__init__(cfg, params, max_cache_len, cache_dtype,
                         paged_decode, page_size, device)
        self._ring = None          # (mesh, axis) once sequence_parallel()

    @classmethod
    def from_config(cls, cfg: LlamaConfig, seed: int = 0,
                    load_in_low_bit: Optional[str] = None,
                    max_cache_len: int = 512,
                    device=None) -> "LlamaForCausalLM":
        """Random weights from ``seed`` (:func:`init_params`), made on
        ``device``, optionally quantized (``lm_head`` stays dense; an MoE
        config refuses, before any weight is made)."""
        dev = resolve_device(device)
        if load_in_low_bit and cfg.num_experts:
            raise NotImplementedError(_MOE_QUANT)
        params = init_params(cfg, seed, device=dev)
        if load_in_low_bit:
            params = quantize_params(params, load_in_low_bit)
        return cls(cfg, params, max_cache_len, device=dev)

    def quantize(self, qtype: str = "sym_int4") -> "LlamaForCausalLM":
        self.params = quantize_params(self.params, qtype)
        return self

    def shard(self, mesh) -> "LlamaForCausalLM":
        """Keep this rank's tensor-parallel slices of the params over the
        mesh's ``model`` axis; the config becomes this rank's
        (:func:`shard_params`, which also takes an expert axis)."""
        self.params, self.config = shard_params(self.params, self.config,
                                                mesh)
        return self

    def sequence_parallel(self, mesh, axis: str = "seq"
                          ) -> "LlamaForCausalLM":
        """Run the prefill of fresh prompts as ring attention over
        ``axis``: each rank takes T / n of the prompt and K/V chunks ride
        the ring (decode keeps the cache-window path)."""
        self._ring = (mesh, axis)
        return self

    def __call__(self, tokens, cache=None, positions=None):
        """:meth:`ModelHolder.__call__`, with the ring prefill where
        :meth:`sequence_parallel` set one and it is valid: from an empty
        cache with the default positions 0..T-1 (given positions may be
        packed or offset, which the ring mask does not model), more than
        one token, no sliding window (the ring mask is plain causal), and
        T a multiple of the ring's size."""
        from bigdl_tpu_torch.parallel.mesh import mesh_axis_size
        tokens = as_tokens(tokens, self.device)
        b, t = tokens.shape
        use_ring = (cache is None and positions is None and t > 1
                    and self._ring is not None
                    and self.config.sliding_window is None
                    and t % mesh_axis_size(*self._ring) == 0)
        if not use_ring:
            return super().__call__(tokens, cache, positions)
        cache = init_cache(self.config, b, self.max_cache_len,
                           dtype=self.cache_dtype, device=self.device)
        positions = torch.arange(t, dtype=torch.int32,
                                 device=self.device).expand(b, t)
        with torch.no_grad():
            return forward(self.params, self.config, tokens, cache,
                           positions, ring=self._ring)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, eos_token_id: Optional[int] = None,
                 seed: int = 0, decode_chunk: int = 32) -> np.ndarray:
        """Greedy or sampled autoregressive decode. input_ids (B, T0);
        returns (B, T0 + new) int32 numpy (:func:`generate_tokens`).
        Sampling noise comes from a ``torch.Generator`` seeded with
        ``seed`` on the model's device."""
        step_fn = None
        if self.paged_decode:
            from bigdl_tpu_torch.llm.serving import paged_decode_step
            step_fn = paged_decode_step
        return generate_tokens(self, input_ids, max_new_tokens,
                               forward_fn=forward, step_fn=step_fn,
                               do_sample=do_sample, temperature=temperature,
                               top_k=top_k, eos_token_id=eos_token_id,
                               seed=seed, decode_chunk=decode_chunk)

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
