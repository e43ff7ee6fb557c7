"""The port's ``AutoModelForCausalLM.from_pretrained`` and its own
safetensors reader, held against the JAX package on tiny HF checkpoints
written here with ``transformers``' ``save_pretrained(
safe_serialization=True)`` (Llama, Mistral with a window that bites,
Qwen2 with q/k/v biases; f32 and bf16 files): parameters bit-identical
to the JAX loader's with and without ``load_in_4bit``, and greedy
tokens identical (both trees taken to f32 with an f32 cache, so argmax
near-ties cannot flip). The reader equals ``safetensors.safe_open`` on
f32, bf16, f16 and integer tensors, on a glob, a single file and a
sharded index."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm.models.llama import LlamaForCausalLM as JModel
from bigdl_tpu.llm.transformers import AutoModelForCausalLM as JAuto
from bigdl_tpu.llm.transformers.model import (
    load_hf_llama_safetensors as j_load)

from bigdl_tpu_torch.llm.models.llama import LlamaForCausalLM
from bigdl_tpu_torch.llm.transformers import (AutoModelForCausalLM,
                                              SafetensorsReader)
from bigdl_tpu_torch.llm.transformers.model import (
    _read_hf_config, load_hf_llama_safetensors)

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

_SMALL = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
FAMILIES = {
    "llama": (transformers.LlamaConfig, transformers.LlamaForCausalLM, {}),
    "mistral": (transformers.MistralConfig, transformers.MistralForCausalLM,
                {"sliding_window": 8}),
    "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM, {}),
}


@pytest.fixture(scope="module", params=[(f, d) for f in FAMILIES
                                        for d in ("f32", "bf16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def ckpt(request, tmp_path_factory):
    family, dt = request.param
    cfg_cls, model_cls, extra = FAMILIES[family]
    torch.manual_seed(0)
    hf = model_cls(cfg_cls(**_SMALL, **extra))
    if family == "qwen2":
        with torch.no_grad():           # non-zero biases, so they count
            for layer in hf.model.layers:
                for lin in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                            layer.self_attn.v_proj):
                    lin.bias.normal_(0, 0.5)
    if dt == "bf16":
        hf = hf.to(torch.bfloat16)
    path = str(tmp_path_factory.mktemp("hf") / f"{family}-{dt}")
    hf.save_pretrained(path, safe_serialization=True)
    return family, path


def _assert_same_tree(want, got, where=""):
    assert set(want) == set(got), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_same_tree(w, g, f"{where}/{k}")
            continue
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, f"{where}/{k}"
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            assert g.numpy().dtype == w.dtype, f"{where}/{k}"
            np.testing.assert_array_equal(g.numpy(), w)


def _f32_jax(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        tree)


def _f32_port(tree):
    if isinstance(tree, dict):
        return {k: _f32_port(v) for k, v in tree.items()}
    return tree.float() if tree.dtype == torch.bfloat16 else tree


class TestFromPretrained:
    @pytest.mark.parametrize("qtype", [None, "sym_int4"])
    def test_params_bit_identical_to_jax_loader(self, ckpt, qtype):
        _, path = ckpt
        want = j_load(path, qtype=qtype)
        got = load_hf_llama_safetensors(path, qtype=qtype, device="cpu")
        _assert_same_tree(jax.tree_util.tree_map(np.asarray, want), got)

    @pytest.mark.parametrize("load_in_4bit", [False, True])
    def test_generate_identical_to_jax(self, ckpt, load_in_4bit):
        """The public entry on both sides, then both trees in f32 with an
        f32 cache: the same greedy tokens; a 20-token prompt passes the
        Mistral checkpoint's window of 8."""
        family, path = ckpt
        jm = JAuto.from_pretrained(path, load_in_4bit=load_in_4bit,
                                   max_cache_len=48)
        tm = AutoModelForCausalLM.from_pretrained(
            path, load_in_4bit=load_in_4bit, max_cache_len=48, device="cpu")
        assert isinstance(tm, LlamaForCausalLM)
        assert tm.config == _read_hf_config(path)
        assert (tm.config.sliding_window == 8) == (family == "mistral")
        assert tm.config.attention_bias == (family == "qwen2")
        assert ("qkv_proj" in tm.params["layers"]) == load_in_4bit
        ids = np.random.RandomState(1).randint(0, 96, (2, 20)).astype(
            np.int32)
        want = JModel(jm.config, _f32_jax(jm.params), max_cache_len=48,
                      cache_dtype=jnp.float32).generate(ids,
                                                        max_new_tokens=10)
        got = LlamaForCausalLM(tm.config, _f32_port(tm.params),
                               max_cache_len=48, cache_dtype=torch.float32,
                               device="cpu").generate(ids, max_new_tokens=10)
        np.testing.assert_array_equal(got, want)

    def test_config_input(self):
        """A LlamaConfig (positional or ``config=``) gives random weights
        from the seed, quantized with a dense lm_head."""
        from bigdl_tpu_torch.llm.models.llama import LlamaConfig
        a = AutoModelForCausalLM.from_pretrained(
            LlamaConfig.tiny_glm(), load_in_4bit=True, seed=3, device="cpu")
        b = AutoModelForCausalLM.from_pretrained(
            config=LlamaConfig.tiny_glm(), load_in_low_bit="sym_int4",
            seed=3, device="cpu")
        assert a.config.rope_mode == "glm"
        assert torch.equal(a.params["layers"]["qkv_proj"]["q"],
                           b.params["layers"]["qkv_proj"]["q"])
        assert "w" in a.params["lm_head"]
        default = AutoModelForCausalLM.from_pretrained(device="cpu")
        assert default.config == LlamaConfig.tiny()
        assert default.generate(np.array([[4, 5]]), max_new_tokens=3).shape \
            == (1, 5)

    def test_glm_fused_gate_up_split(self, tmp_path):
        """A GLM checkpoint stores ``mlp.gate_up_proj``; both loaders
        split it back into gate and up, bit for bit."""
        rs = np.random.RandomState(2)
        H, I, L = 32, 64, 2
        tensors = {"model.embed_tokens.weight": (50, H),
                   "model.norm.weight": (H,), "lm_head.weight": (50, H)}
        for l in range(L):
            p = f"model.layers.{l}."
            tensors.update({
                p + "self_attn.q_proj.weight": (H, H),
                p + "self_attn.k_proj.weight": (16, H),
                p + "self_attn.v_proj.weight": (16, H),
                p + "self_attn.q_proj.bias": (H,),
                p + "self_attn.k_proj.bias": (16,),
                p + "self_attn.v_proj.bias": (16,),
                p + "self_attn.o_proj.weight": (H, H),
                p + "mlp.gate_up_proj.weight": (2 * I, H),
                p + "mlp.down_proj.weight": (H, I),
                p + "input_layernorm.weight": (H,),
                p + "post_attention_layernorm.weight": (H,)})
        safetensors_torch.save_file(
            {k: torch.from_numpy(rs.randn(*s).astype(np.float32))
             for k, s in tensors.items()}, str(tmp_path / "model.safetensors"))
        with open(tmp_path / "config.json", "w") as f:
            json.dump({"model_type": "glm", "vocab_size": 50,
                       "hidden_size": H, "intermediate_size": I,
                       "num_hidden_layers": L, "num_attention_heads": 4,
                       "num_key_value_heads": 2, "attention_bias": True,
                       "partial_rotary_factor": 0.5}, f)
        for qtype in (None, "sym_int4"):
            want = jax.tree_util.tree_map(
                np.asarray, j_load(str(tmp_path), qtype=qtype))
            got = load_hf_llama_safetensors(str(tmp_path), qtype=qtype,
                                            device="cpu")
            _assert_same_tree(want, got)

    def test_other_families_and_fallback_raise(self, tmp_path):
        """The gpt_neox, bloom and gpt_bigcode families load (each as its
        own model class); hub ids and other low-bit formats raise."""
        from bigdl_tpu_torch.llm.models import (BloomForCausalLM,
                                                GptNeoXForCausalLM,
                                                StarCoderForCausalLM)
        models = {"gpt_neox": (transformers.GPTNeoXConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2),
            transformers.GPTNeoXForCausalLM, GptNeoXForCausalLM),
            "bloom": (transformers.BloomConfig(
                vocab_size=64, hidden_size=32, n_layer=1, n_head=2),
                transformers.BloomForCausalLM, BloomForCausalLM),
            "gpt_bigcode": (transformers.GPTBigCodeConfig(
                vocab_size=64, n_embd=32, n_layer=1, n_head=2),
                transformers.GPTBigCodeForCausalLM, StarCoderForCausalLM)}
        for mt, (hf_cfg, hf_cls, cls) in models.items():
            hf_cls(hf_cfg).save_pretrained(str(tmp_path / mt),
                                           safe_serialization=True)
            m = AutoModelForCausalLM.from_pretrained(
                str(tmp_path / mt), load_in_4bit=True, device="cpu")
            assert type(m) is cls and m.config.hidden_size == 32
            assert m.generate([[1, 2, 3]], max_new_tokens=2).shape == (1, 5)
        (tmp_path / "neox").mkdir()
        safetensors_torch.save_file({"x": torch.zeros(2)},
                                    str(tmp_path / "neox" / "m.safetensors"))
        with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
            AutoModelForCausalLM.from_pretrained("meta-llama/Llama-2-7b",
                                                 device="cpu")
        with pytest.raises(NotImplementedError, match="sym_int4"):
            load_hf_llama_safetensors(str(tmp_path / "neox"),
                                      qtype="asym_int4", device="cpu")

    def test_raises_without_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AutoModelForCausalLM.from_pretrained()


def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "a.f32": torch.randn((3, 5), generator=g),
        "a.bf16": torch.randn((4, 6), generator=g).to(torch.bfloat16),
        "a.f16": torch.randn((7,), generator=g).to(torch.float16),
        "a.i32": torch.randint(-2 ** 20, 2 ** 20, (2, 3), generator=g,
                               dtype=torch.int32),
        "a.i64": torch.randint(-1000, 1000, (5,), generator=g,
                               dtype=torch.int64),
        "a.u8": torch.randint(0, 256, (9,), generator=g, dtype=torch.uint8),
        "a.i8": torch.randint(-128, 128, (2, 2), generator=g,
                              dtype=torch.int8),
        "a.scalar": torch.tensor(2.5),
        "a.empty": torch.zeros((0, 4)),
    }


def _safe_open_f32(fname, name):
    from safetensors import safe_open
    with safe_open(fname, framework="pt") as f:
        return f.get_tensor(name).to(torch.float32).numpy()


class TestReader:
    def test_matches_safe_open_every_dtype(self, tmp_path):
        fname = str(tmp_path / "model.safetensors")
        safetensors_torch.save_file(_tensors(0), fname,
                                    metadata={"format": "pt"})
        with SafetensorsReader(str(tmp_path)) as r:
            assert set(r.key_map) == set(_tensors(0))
            for name in r.key_map:
                got = r.get(name)
                want = _safe_open_f32(fname, name)
                assert got.dtype == np.float32 and got.shape == want.shape
                np.testing.assert_array_equal(got, want)

    def test_single_file_glob_and_prefix(self, tmp_path):
        for i in range(2):
            safetensors_torch.save_file(
                {f"transformer.w{i}": torch.full((2,), float(i))},
                str(tmp_path / f"part{i}.safetensors"))
        one = SafetensorsReader(str(tmp_path / "part1.safetensors"))
        assert set(one.key_map) == {"transformer.w1"}
        both = SafetensorsReader(str(tmp_path / "part*.safetensors"))
        assert "w0" in both and "w1" in both and "w2" not in both
        np.testing.assert_array_equal(both.get("w1"), [1.0, 1.0])
        with pytest.raises(KeyError):
            both.get("w2")
        bare = SafetensorsReader(str(tmp_path), prefix_fallbacks=("",))
        assert "w0" not in bare and "transformer.w0" in bare

    def test_sharded_index(self, tmp_path):
        tensors = _tensors(1)
        names = sorted(tensors)
        shards = {"model-00001-of-00002.safetensors": names[:4],
                  "model-00002-of-00002.safetensors": names[4:]}
        weight_map = {}
        for fname, keys in shards.items():
            safetensors_torch.save_file({k: tensors[k] for k in keys},
                                        str(tmp_path / fname))
            weight_map.update({k: fname for k in keys})
        with open(tmp_path / "model.safetensors.index.json", "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
        r = SafetensorsReader(str(tmp_path))
        assert r.key_map == {k: os.path.join(str(tmp_path), v)
                             for k, v in weight_map.items()}
        for name in names:
            np.testing.assert_array_equal(
                r.get(name), _safe_open_f32(r.key_map[name], name))

    def test_not_a_checkpoint(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            SafetensorsReader(str(tmp_path))
        (tmp_path / "bad.safetensors").write_bytes(b"\x01")
        with pytest.raises(ValueError, match="not a safetensors"):
            SafetensorsReader(str(tmp_path))
