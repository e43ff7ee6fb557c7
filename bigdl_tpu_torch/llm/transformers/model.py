"""``AutoModelForCausalLM`` — the port of
``bigdl_tpu/llm/transformers/model.py``, bigdl-llm's public entry point:
``AutoModelForCausalLM.from_pretrained(path, load_in_4bit=True)
.generate(ids)``.

Three inputs load:
- a ``LlamaConfig`` instance (or ``config=``): random weights from
  ``seed``, made on the device — the test and benchmark path (an MoE
  config such as ``LlamaConfig.mixtral_8x7b()`` runs bf16: like the JAX
  package, low-bit refuses its expert-stacked weights);
- an HF checkpoint directory with ``config.json`` and safetensors
  weights, dispatched on its ``model_type`` as the JAX package does:
  ``gpt_neox``, ``bloom`` and ``gpt_bigcode`` to their families'
  loaders, anything else to the llama lineage's (llama, mistral, qwen2,
  glm). Each is read straight into the stacked layout by the port's own
  reader, one layer at a time, each linear quantized the moment it is
  read when low-bit is asked;
- nothing: ``LlamaConfig.tiny()``.

A checkpoint without safetensors weights (or a hub id) needs the
``transformers`` fallback, ROADMAP Queue 1 item 13, and raises.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional

import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.llm.kernels.int4_matmul import quantize_tpu
from bigdl_tpu_torch.llm.models.llama import (
    _LAYER_LINEARS, LlamaConfig, LlamaForCausalLM, fuse_decoder_params)
from bigdl_tpu_torch.llm.transformers.st_reader import SafetensorsReader

_HF_LINEAR = {
    "q_proj": "model.layers.{}.self_attn.q_proj.weight",
    "k_proj": "model.layers.{}.self_attn.k_proj.weight",
    "v_proj": "model.layers.{}.self_attn.v_proj.weight",
    "o_proj": "model.layers.{}.self_attn.o_proj.weight",
    "gate_proj": "model.layers.{}.mlp.gate_proj.weight",
    "up_proj": "model.layers.{}.mlp.up_proj.weight",
    "down_proj": "model.layers.{}.mlp.down_proj.weight",
}


def _read_raw_config(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _read_hf_config(path: str) -> LlamaConfig:
    """config.json → LlamaConfig (an attribute shim over the raw dict)."""
    return LlamaConfig.from_hf(type("HFConfig", (), _read_raw_config(path))())


def load_hf_llama_safetensors(path: str, cfg: Optional[LlamaConfig] = None,
                              qtype: Optional[str] = None, dtype=None,
                              device=None) -> Dict[str, Any]:
    """Read an HF llama-lineage checkpoint (config.json + *.safetensors)
    into the stacked layout on ``device`` (``None`` = the GPU), one
    tensor at a time: each f32 weight goes to the device and, with
    ``qtype``, is q4_0-quantized there at once (quantize-on-load;
    bit-identical to the JAX package's numpy quantizer), so the dense
    model is never held. GLM checkpoints' fused ``mlp.gate_up_proj`` is
    split back into gate and up. Dense weights, norms and embeddings are
    cast to ``dtype`` (bf16 by default), biases stay f32; quantized
    linears come back fused (qkv, gate_up). Parameters are bit-identical
    to the JAX package's loader."""
    if qtype and qtype != "sym_int4":
        raise NotImplementedError(
            "the decoder path implements q4_0 (sym_int4) only")
    dev = resolve_device(device)
    dtype = dtype or torch.bfloat16
    cfg = cfg or _read_hf_config(path)
    L = cfg.num_hidden_layers

    with SafetensorsReader(path, prefix_fallbacks=("",)) as reader:
        def get(name):
            return torch.from_numpy(reader.get(name)).to(dev)

        def stack_linear(weights):
            if not qtype:
                return {"w": torch.stack([w.to(dtype) for w in weights])}
            tds = [quantize_tpu(w, qtype) for w in weights]
            return {"q": torch.stack([td["q"] for td in tds]),
                    "scale": torch.stack([td["scale"] for td in tds])}

        layers: Dict[str, Any] = {}
        glm_fused = "model.layers.0.mlp.gate_up_proj.weight" in reader.key_map
        if glm_fused:
            # each fused (2I, H) tensor is read once, feeding both halves
            inter = cfg.intermediate_size
            halves = {"gate_proj": [], "up_proj": []}
            for l in range(L):
                gu = get(f"model.layers.{l}.mlp.gate_up_proj.weight")
                halves["gate_proj"].append(gu[:inter])
                halves["up_proj"].append(gu[inter:])
            for name, ws in halves.items():
                layers[name] = stack_linear(ws)
        for name in _LAYER_LINEARS:
            if glm_fused and name in ("gate_proj", "up_proj"):
                continue
            layers[name] = stack_linear(
                [get(_HF_LINEAR[name].format(l)) for l in range(L)])
        for name in ("q_proj", "k_proj", "v_proj"):
            key = "model.layers.{}.self_attn." + name + ".bias"
            if key.format(0) in reader.key_map:
                layers[name]["b"] = torch.stack(
                    [get(key.format(l)) for l in range(L)])
        for norm in ("input_layernorm", "post_attention_layernorm"):
            layers[norm] = torch.stack(
                [get(f"model.layers.{l}.{norm}.weight") for l in range(L)]
            ).to(dtype)
        params: Dict[str, Any] = {
            "embed_tokens": get("model.embed_tokens.weight").to(dtype),
            "norm": get("model.norm.weight").to(dtype),
            "layers": layers,
        }
        if not cfg.tie_word_embeddings and "lm_head.weight" in reader.key_map:
            params["lm_head"] = {"w": get("lm_head.weight").to(dtype)}
    if qtype:
        params = fuse_decoder_params(params)
    return params


def _families():
    """``model_type`` → (config class, model class, safetensors loader)
    of the non-llama families (imported here: their modules import this
    package's reader)."""
    from bigdl_tpu_torch.llm.models import bloom, gptneox, starcoder
    return {"gpt_neox": (gptneox.GptNeoXConfig, gptneox.GptNeoXForCausalLM,
                         gptneox.load_hf_gptneox_safetensors),
            "bloom": (bloom.BloomConfig, bloom.BloomForCausalLM,
                      bloom.load_hf_bloom_safetensors),
            "gpt_bigcode": (starcoder.StarCoderConfig,
                            starcoder.StarCoderForCausalLM,
                            starcoder.load_hf_starcoder_safetensors)}


class AutoModelForCausalLM:
    """bigdl-llm's API: ``AutoModelForCausalLM.from_pretrained(path,
    load_in_4bit=True | load_in_low_bit="sym_int4")``."""

    @staticmethod
    def from_pretrained(pretrained_model_name_or_path=None,
                        load_in_4bit: bool = False,
                        load_in_low_bit: Optional[str] = None,
                        config: Optional[LlamaConfig] = None,
                        max_cache_len: int = 512, seed: int = 0,
                        device=None):
        """A :class:`LlamaForCausalLM` — or, for a ``gpt_neox``, ``bloom``
        or ``gpt_bigcode`` checkpoint, the family's model — on ``device``
        (``None`` = the GPU, raising without one). ``lm_head`` (and the
        families' bf16 heads) stay dense when quantizing."""
        qtype = load_in_low_bit or ("sym_int4" if load_in_4bit else None)
        dev = resolve_device(device)
        path = pretrained_model_name_or_path
        if isinstance(path, LlamaConfig):
            config, path = path, None

        if path is None:
            return LlamaForCausalLM.from_config(
                config or LlamaConfig.tiny(), seed=seed,
                load_in_low_bit=qtype, max_cache_len=max_cache_len,
                device=dev)
        if not (os.path.isdir(path)
                and glob.glob(os.path.join(path, "*.safetensors"))):
            raise NotImplementedError(
                f"{path!r} is not a directory of safetensors weights: "
                "hub ids and torch checkpoints need the transformers "
                "fallback, which is ROADMAP Queue 1 item 13")
        raw = _read_raw_config(path)
        hf_shim = type("HFConfig", (), raw)()
        family = _families().get(raw.get("model_type"))
        if family is not None:
            cfg_cls, model_cls, load = family
            cfg = cfg_cls.from_hf(hf_shim)
            return model_cls(cfg, load(path, cfg, qtype=qtype, device=dev),
                             max_cache_len=max_cache_len, device=dev)
        cfg = LlamaConfig.from_hf(hf_shim)
        params = load_hf_llama_safetensors(path, cfg, qtype=qtype,
                                           device=dev)
        return LlamaForCausalLM(cfg, params, max_cache_len=max_cache_len,
                                device=dev)
