"""GPT-NeoX family — the port of ``bigdl_tpu/llm/models/gptneox.py``
(Pythia, Dolly, RedPajama-INCITE, GPT-NeoX-20B). Distinct from Llama:
LayerNorm with bias, biased linears, **parallel residual** (``x +
attn(ln1 x) + mlp(ln2 x)``; sequential with
``use_parallel_residual=False``), partial rotary embedding (rotate-half
over the first ``rotary_pct`` of the head dims), exact-GELU MLP, no GQA.

The layer math (:func:`_layer`) runs on every path through the shared
skeletons: the dense-cache :func:`forward` (``llama.dense_forward``),
the serving engine's :func:`paged_decode_step` (``serving.paged_decode``:
the stats kernel plus the merge of the current token, one scatter),
:func:`paged_prefill_ragged` (``llama.ragged_prefill``: the ragged
kernel over the cached prefix, in place), the dense staging
``paged_prefill_partial``, and the engine's mixed and verify steps
(``paged_step_mixed``, ``paged_step_spec``). Every decoder linear is a
q4_0 ``int4_matmul`` (kernel 1) once quantized; llama's ``_linear`` adds
the bias after it, as the JAX package's ``_linear_b`` does. The head
``embed_out`` stays bf16. ``param_pspecs`` gives the JAX package's
tensor-parallel specs and ``shard`` keeps this rank's Megatron slices
(``_shard``: q/k/v and fc_in cut by heads and columns, o_proj and fc_out
by rows, their biases added once after the sum, the embeddings over the
vocabulary).
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
from bigdl_tpu_torch.llm.models import _shard as sh
from bigdl_tpu_torch.llm.models.llama import (_linear, dense_forward,
                                              init_cache, ragged_prefill,
                                              rope)
from bigdl_tpu_torch.llm.transformers.st_reader import SafetensorsReader


@dataclasses.dataclass
class GptNeoXConfig:
    """GPT-NeoX-20B by default."""
    vocab_size: int = 50432
    hidden_size: int = 6144
    intermediate_size: int = 24576
    num_hidden_layers: int = 44
    num_attention_heads: int = 64
    rotary_pct: float = 0.25
    rotary_emb_base: float = 10000.0
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    attn_block_size: int = 1024
    sliding_window = None          # read by the shared attention paths

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def pythia_70m(cls) -> "GptNeoXConfig":
        return cls(vocab_size=50304, hidden_size=512, intermediate_size=2048,
                   num_hidden_layers=6, num_attention_heads=8)

    @classmethod
    def tiny(cls, vocab: int = 256) -> "GptNeoXConfig":
        return cls(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   max_position_embeddings=128)

    @classmethod
    def from_hf(cls, hf) -> "GptNeoXConfig":
        g = (lambda k, d: getattr(hf, k, d))
        return cls(
            vocab_size=g("vocab_size", 50432),
            hidden_size=g("hidden_size", 6144),
            intermediate_size=g("intermediate_size", 24576),
            num_hidden_layers=g("num_hidden_layers", 44),
            num_attention_heads=g("num_attention_heads", 64),
            rotary_pct=g("rotary_pct", 0.25),
            rotary_emb_base=g("rotary_emb_base", 10000.0),
            max_position_embeddings=g("max_position_embeddings", 2048),
            layer_norm_eps=g("layer_norm_eps", 1e-5),
            use_parallel_residual=g("use_parallel_residual", True))


_LAYER_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj",
                  "fc_in", "fc_out")


def linear_shapes(cfg: GptNeoXConfig) -> Dict[str, Tuple[int, int]]:
    h = cfg.hidden_size
    return {"q_proj": (h, h), "k_proj": (h, h), "v_proj": (h, h),
            "o_proj": (h, h), "fc_in": (cfg.intermediate_size, h),
            "fc_out": (h, cfg.intermediate_size)}


def init_params(cfg: GptNeoXConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None, qtype: Optional[str] = None) -> Dict[str, Any]:
    """Random weights (the JAX package's shapes, scales and dtypes) from a
    seeded ``torch.Generator`` on ``device``; with ``qtype`` every
    decoder linear is q4_0 as drawn, one layer at a time."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    v, h = cfg.vocab_size, cfg.hidden_size
    return {"layers": init_layers(cfg, linear_shapes(cfg), gen, dtype, dev,
                                  qtype),
            "embed_in": draw(gen, (v, h), 0.02, dtype, dev),
            "final_norm": norm_params(h, dtype, dev),
            "embed_out": {"w": draw(gen, (v, h), None, dtype, dev)}}


def quantize_params(params: Dict[str, Any], qtype: str = "sym_int4"
                    ) -> Dict[str, Any]:
    """q4_0 of every decoder linear (weights only; biases stay)."""
    return quantize_layers(params, _LAYER_LINEARS, qtype)


def param_pspecs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's Megatron specs over ``model``: q/k/v and fc_in
    cut along N (their biases with them), o_proj / fc_out along K (their
    biases replicated), the embeddings over the vocabulary, norms
    replicated. Quantized leaves are k-major (…, K-ish, N)."""
    from bigdl_tpu_torch.parallel.mesh import P
    row = {"q_proj", "k_proj", "v_proj", "fc_in"}

    def spec_for(keys, leaf):
        d0 = 1 if "layers" in keys else 0
        nd = leaf.dim() if isinstance(leaf, torch.Tensor) else 0
        name = next((k for k in keys if k in row or k in (
            "o_proj", "fc_out", "embed_in", "embed_out")), None)
        if name is None or nd <= d0:
            return P()
        kmajor = keys[-1] in ("q", "scale", "zero")
        spec = [None] * nd
        if name in row or name in ("embed_in", "embed_out"):
            spec[-1 if kmajor else d0] = "model"
        elif keys[-1] != "b":
            if kmajor:
                spec[d0] = "model"
            elif nd > d0 + 1:
                spec[d0 + 1] = "model"
        return P(*spec)

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + [k]) for k, v in tree.items()}
        return spec_for(keys, tree)

    return walk(params, [])


def shard_params(params: Dict[str, Any], cfg: GptNeoXConfig, mesh):
    """This rank's Megatron slices over the mesh's ``model`` axis (every
    rank passes the same whole tree); returns ``(rank params, rank
    config)``. As llama's :func:`~bigdl_tpu_torch.llm.models.llama.
    shard_params`, without GQA or experts."""
    w, r, group = sh._axis(mesh, "model")
    hd, inter = cfg.head_dim, cfg.intermediate_size
    q0, nq, _, _ = sh.head_cut(cfg.num_attention_heads,
                               cfg.num_attention_heads, w, r)
    if inter % w:
        raise ValueError(f"intermediate size {inter} does not split over "
                         f"{w} ranks")
    tp = sh.TensorShard(group, sh.vocab_cut(w, r, cfg.vocab_size))
    hr = (q0 * hd, (q0 + nq) * hd)
    ir = (r * inter // w, (r + 1) * inter // w)
    layers = {}
    for name, d in params["layers"].items():
        if name in ("q_proj", "k_proj", "v_proj"):
            d = sh.cut_n(d, [hr])
        elif name == "fc_in":
            d = sh.cut_n(d, [ir])
        elif name == "o_proj":
            d = sh.cut_k(d, *hr, tp.reduce)
        elif name == "fc_out":
            d = sh.cut_k(d, *ir, tp.reduce)
        layers[name] = d
    emb = params["embed_in"]
    out = dict(params, layers=layers, tp=tp,
               embed_in=emb if tp.vocab is None else
               emb[tp.vocab[0]:tp.vocab[1]].contiguous(),
               embed_out=sh.cut_head(params["embed_out"], tp.vocab, tp))
    return out, sh.RankConfig(cfg, num_attention_heads=nq,
                              num_key_value_heads=nq,
                              intermediate_size=inter // w)


def _layer_norm(x, wd, eps: float):
    """LayerNorm in f32 (population variance), cast to the model dtype,
    THEN scaled and shifted (the JAX package's cast order)."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * wd["w"].to(x.dtype) + wd["b"].to(x.dtype)


def _partial_rope(x, positions, cfg: GptNeoXConfig):
    """Rotate-half over the first ``rotary_pct`` of the head dims (24 of
    96 at 20B); ``positions`` a device tensor, so a captured step reads
    them."""
    return rope(x, positions, cfg.rotary_emb_base, "half", cfg.rotary_pct)


def _embed(params, cfg, toks, positions):
    return sh.embed_rows(params["embed_in"], toks, params.get("tp"))


def _layer(lp, x, positions, cfg: GptNeoXConfig, attend, kv_dtype=None):
    """One GPT-NeoX layer around ``attend(q, k, v)`` (the skeletons'
    attention closure); returns (x, k, v) with k/v post-rotary, cast to
    ``kv_dtype`` before attention when given."""
    b, t, _ = x.shape
    nh, hd, eps = cfg.num_attention_heads, cfg.head_dim, cfg.layer_norm_eps
    h1 = _layer_norm(x, lp["input_layernorm"], eps)
    q = _partial_rope(_linear(lp["q_proj"], h1).reshape(b, t, nh, hd),
                      positions, cfg)
    k = _partial_rope(_linear(lp["k_proj"], h1).reshape(b, t, nh, hd),
                      positions, cfg)
    v = _linear(lp["v_proj"], h1).reshape(b, t, nh, hd)
    if kv_dtype is not None:
        k, v = k.to(kv_dtype), v.to(kv_dtype)
    attn = _linear(lp["o_proj"], attend(q, k, v).to(x.dtype).reshape(b, t, -1))
    h2_in = x if cfg.use_parallel_residual else x + attn
    h2 = _layer_norm(h2_in, lp["post_attention_layernorm"], eps)
    mlp = _linear(lp["fc_out"], F.gelu(
        _linear(lp["fc_in"], h2).to(torch.float32)).to(x.dtype))
    x = x + attn + mlp if cfg.use_parallel_residual else h2_in + mlp
    return x, k, v


def _head(params, cfg, x):
    return _linear(params["embed_out"],
                   _layer_norm(x, params["final_norm"], cfg.layer_norm_eps))


_PARTS = dict(embed=_embed, layer=_layer, head=_head)


def forward(params: Dict[str, Any], cfg: GptNeoXConfig, tokens, cache,
            positions):
    """Dense-cache forward (prefill or decode); the cache is written in
    place. Returns ``(logits (B, T, V) f32, cache)``."""
    return dense_forward(params, cfg, tokens, cache, positions, **_PARTS)


def paged_decode_step(params, cfg, k_pages, v_pages, bt, lens, toks, *,
                      page: int):
    """The engine's paged decode step for GPT-NeoX (the llama step's
    structure, ``serving.paged_decode``). Returns ``(logits (B, V) f32,
    k_pages, v_pages)``, the pools written in place."""
    from bigdl_tpu_torch.llm.serving import paged_decode
    return paged_decode(params, cfg, k_pages, v_pages, bt, lens, toks,
                        page=page, **_PARTS)


def paged_prefill_ragged(params, cfg, k_pages, v_pages, toks, length,
                         offset, bt_row, phys, slots, fork_dst, fork_src, *,
                         page: int, full_logits: bool = False):
    """Ragged in-place prefill (``llama.paged_prefill_ragged``'s
    contract) with the GPT-NeoX layer."""
    return ragged_prefill(params, cfg, k_pages, v_pages, toks, length,
                          offset, bt_row, phys, slots, fork_dst, fork_src,
                          page=page, full_logits=full_logits, **_PARTS)


paged_decode_step_sampled = make_sampled_step(paged_decode_step)
paged_prefill_partial = make_partial_prefill(forward, init_cache)
paged_step_mixed = make_mixed_step(paged_decode_step, paged_prefill_ragged)
paged_step_spec = make_spec_step(paged_decode_step, paged_prefill_ragged)


class GptNeoXForCausalLM(CausalLMFacade):
    """Generation facade (``_facade.CausalLMFacade``)."""

    _forward = staticmethod(forward)
    _init_cache = staticmethod(init_cache)
    _init_params = staticmethod(init_params)
    _paged_step = staticmethod(paged_decode_step)

    def shard(self, mesh) -> "GptNeoXForCausalLM":
        """Keep this rank's tensor-parallel slices over the mesh's
        ``model`` axis; the config becomes this rank's
        (:func:`shard_params`)."""
        self.params, self.config = shard_params(self.params, self.config,
                                                mesh)
        return self


def load_hf_gptneox_safetensors(path: str,
                                cfg: Optional[GptNeoXConfig] = None,
                                qtype: Optional[str] = None, dtype=None,
                                device=None) -> Dict[str, Any]:
    """An HF ``GPTNeoXForCausalLM`` checkpoint (config.json +
    safetensors) → the stacked layout on ``device``, one layer at a time,
    each linear q4_0-quantized as it is read with ``qtype``. HF fuses
    q/k/v as ``query_key_value`` interleaved per head ``[q1 k1 v1 q2 ..]``;
    it is split back into three linears. Bit-identical to the JAX
    package's loader."""
    from bigdl_tpu_torch.llm.transformers.model import _read_raw_config
    if qtype and qtype != "sym_int4":
        raise NotImplementedError("q4_0 only on the scanned path")
    dev = resolve_device(device)
    dtype = dtype or torch.bfloat16
    if cfg is None:
        cfg = GptNeoXConfig.from_hf(type("HFConfig", (), _read_raw_config(
            path))())
    nh, hd, h = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
    hf_lin = {"o_proj": "attention.dense", "fc_in": "mlp.dense_h_to_4h",
              "fc_out": "mlp.dense_4h_to_h",
              "input_layernorm": "input_layernorm",
              "post_attention_layernorm": "post_attention_layernorm"}
    with SafetensorsReader(path) as reader:
        def get(name):
            return torch.from_numpy(reader.get(name)).to(dev)

        def read_layer(l):
            pre = f"gpt_neox.layers.{l}."
            w = get(pre + "attention.query_key_value.weight").view(
                nh, 3, hd, h)
            b = get(pre + "attention.query_key_value.bias").view(nh, 3, hd)
            out = {n: (w[:, i].reshape(h, h), b[:, i].reshape(h))
                   for i, n in enumerate(("q_proj", "k_proj", "v_proj"))}
            out.update({n: (get(pre + hf + ".weight"), get(pre + hf + ".bias"))
                        for n, hf in hf_lin.items()})
            return out

        return {"layers": load_layers(cfg.num_hidden_layers, read_layer,
                                      qtype, dtype),
                "embed_in": get("gpt_neox.embed_in.weight").to(dtype),
                "final_norm": {
                    "w": get("gpt_neox.final_layer_norm.weight").to(dtype),
                    "b": get("gpt_neox.final_layer_norm.bias").to(dtype)},
                "embed_out": {"w": get("embed_out.weight").to(dtype)}}
