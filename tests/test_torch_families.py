"""The port's GPT-NeoX (parallel and sequential residual), StarCoder and
Bloom families against the JAX package on their ``tiny`` configs, q4_0
weights with random biases and LayerNorms carried across by
``params_from_numpy`` (f32 and bf16): ``forward`` prefill and decode
logits, greedy ``generate`` (paged and dense), ``paged_decode_step``,
``paged_prefill_ragged``, the mixed and verify steps, ``alibi_slopes``,
the q4_0 quantizers, and ``from_pretrained`` on a checkpoint of each
``model_type`` written here with ``transformers``."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm.models import bloom as jb
from bigdl_tpu.llm.models import gptneox as jn
from bigdl_tpu.llm.models import starcoder as js
from bigdl_tpu.llm.transformers import AutoModelForCausalLM as JAuto

from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import bloom as tb
from bigdl_tpu_torch.llm.models import gptneox as tn
from bigdl_tpu_torch.llm.models import starcoder as ts
from bigdl_tpu_torch.llm.transformers import AutoModelForCausalLM

PAGE = 8
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# as tests/test_torch_llama.py: f32 differs only in summation order; in
# bf16 the JAX CPU path multiplies bf16-rounded dequantized weights
LOGIT_ATOL = {"f32": 1e-4, "bf16": 6e-2}
FAMILIES = {"neox": (jn, tn, "GptNeoXConfig", {}),
            "neox-seq": (jn, tn, "GptNeoXConfig",
                         {"use_parallel_residual": False}),
            "starcoder": (js, ts, "StarCoderConfig", {}),
            "bloom": (jb, tb, "BloomConfig", {})}
PAGED = ["neox", "neox-seq", "starcoder"]
_CACHE = {}


def family(name, dt="f32"):
    """(JAX module, port module, JAX cfg, port cfg, JAX params, port
    params): tiny, q4_0, random biases and norms, made once."""
    key = (name, dt)
    if key not in _CACHE:
        jm, tm, cls, over = FAMILIES[name]
        jc = dataclasses.replace(getattr(jm, cls).tiny(), **over)
        tc = getattr(tm, cls)(**dataclasses.asdict(jc))
        tree = jax.tree_util.tree_map(
            lambda a: np.array(a, np.float32),
            jm.init_params(jc, 0, dtype=jnp.float32))
        rs = np.random.RandomState(1)

        def perturb(d):
            for k, v in d.items():
                if isinstance(v, dict):
                    perturb(v)
                elif k == "b" or (k == "w" and "b" in d and v.ndim <= 2):
                    d[k] = (v + 0.1 * rs.randn(*v.shape)).astype(np.float32)

        perturb(tree)
        jp = jm.quantize_params(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, JDT[dt]), tree))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _CACHE[key] = (jm, tm, jc, tc, jp, tp)
    return _CACHE[key]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _f32(t):
    return t.to(torch.float32).numpy()


def _pools(seed, cfg, dt, P=12):
    rs = np.random.RandomState(seed)
    shape = (cfg.num_hidden_layers, P, cfg.num_key_value_heads, PAGE,
             cfg.head_dim)
    k, v = (jnp.asarray(rs.randn(*shape).astype(np.float32), JDT[dt])
            for _ in range(2))
    return k, v, params_from_numpy(np.asarray(k), "cpu"), \
        params_from_numpy(np.asarray(v), "cpu")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward(name, dt):
    """A 6-token prefill, then the same tokens one at a time from an
    empty cache: logits within ``LOGIT_ATOL`` of the JAX ``forward``."""
    jm, tm, jc, tc, jp, tp = family(name, dt)
    toks = np.array([[5, 9, 3, 7, 11, 2], [1, 4, 250, 8, 0, 66]], np.int32)
    runs = []
    for m, c, p, cache, mk in (
            (jm, jc, jp, jm.init_cache(jc, 2, 16, dtype=JDT[dt]),
             jnp.asarray),
            (tm, tc, tp, tm.init_cache(tc, 2, 16, dtype=TDT[dt],
                                       device="cpu"), _t)):
        full, _ = m.forward(p, c, mk(toks), dict(cache),
                            mk(np.tile(np.arange(6, dtype=np.int32), (2, 1))))
        steps = []
        for i in range(6):
            lg, cache = m.forward(p, c, mk(toks[:, i:i + 1]), cache,
                                  mk(np.full((2, 1), i, np.int32)))
            steps.append(np.asarray(lg)[:, 0])
        runs.append((np.asarray(full), np.stack(steps, 1)))
    (jfull, jstep), (tfull, tstep) = runs
    for got, want in ((tfull, jfull), (tstep, jstep)):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL[dt])


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_generate(name, paged):
    """Greedy ``generate`` on two rows, f32 weights and cache: the JAX
    facade's tokens, over the family's paged token loop and the dense
    one (Bloom has no paged step: always dense); and with an EOS that
    occurs, each row padded with it after its first hit."""
    jm, tm, jc, tc, jp, tp = family(name)
    tmod = _model(name, paged_decode=paged)
    jmod = getattr(jm, type(tmod).__name__)(jc, jp, max_cache_len=64,
                                            cache_dtype=jnp.float32)
    ids = np.random.RandomState(2).randint(0, 250, (2, 9)).astype(np.int32)
    want = np.asarray(jmod.generate(ids, max_new_tokens=10))
    assert tmod.generate(ids, max_new_tokens=10).tolist() == want.tolist()
    eos = int(want[0, 12])
    got = tmod.generate(ids, max_new_tokens=10, eos_token_id=eos,
                        decode_chunk=4)
    assert got.tolist() == np.asarray(jmod.generate(
        ids, max_new_tokens=10, eos_token_id=eos, decode_chunk=4)).tolist()


def _model(name, **kw):
    _, tm, _, tc, _, tp = family(name)
    cls = {"neox": tn.GptNeoXForCausalLM, "neox-seq": tn.GptNeoXForCausalLM,
           "starcoder": ts.StarCoderForCausalLM,
           "bloom": tb.BloomForCausalLM}[name]
    return cls(tc, tp, 64, torch.float32, page_size=PAGE, device="cpu", **kw)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", PAGED)
def test_paged_decode_step(name, dt):
    """Logits and every pool write of the family's paged decode step."""
    jm, tm, jc, tc, jp, tp = family(name, dt)
    jk, jv, tk, tv = _pools(2, jc, dt)
    bt = np.array([[3, 4, 5, 0], [6, 7, 0, 0], [0, 0, 0, 0]], np.int32)
    lens = np.array([20, 9, 0], np.int32)
    toks = np.array([5, 77, 200], np.int32)
    wl, wk, wv = jm.paged_decode_step(jp, jc, jk, jv, *map(
        jnp.asarray, (bt, lens, toks)), page=PAGE)
    gl, gk, gv = tm.paged_decode_step(tp, tc, tk, tv, *map(
        _t, (bt, lens, toks)), page=PAGE)
    assert gk is tk and gv is tv
    for g, w in ((gl, wl), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(_f32(g), np.asarray(w, np.float32),
                                   atol=LOGIT_ATOL[dt], rtol=0)


@pytest.mark.parametrize("offset,length", [(0, 13), (11, 5)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", PAGED)
def test_paged_prefill_ragged(name, dt, offset, length):
    """Last-token logits and every real page, whole prompt (offset 0)
    and a suffix behind prefix pages read in place."""
    jm, tm, jc, tc, jp, tp = family(name, dt)
    jk, jv, tk, tv = _pools(3, jc, dt)
    bucket = 16
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :length] = np.random.RandomState(4).randint(0, 256, length)
    bt_row = np.array([2, 3, 4, 5], np.int32)
    pos = offset + np.arange(bucket)
    phys = np.where(pos < offset + length,
                    bt_row[np.minimum(pos // PAGE, 3)], 0).astype(np.int32)
    slots = (pos % PAGE).astype(np.int32)
    ops = (toks, length, offset, bt_row, phys, slots, 0, 0)
    wk, wv, wl = jm.paged_prefill_ragged(
        jp, jc, jk, jv, *(jnp.asarray(a, jnp.int32) for a in ops), page=PAGE)
    gk, gv, gl = tm.paged_prefill_ragged(
        tp, tc, tk, tv, *(_t(np.asarray(a, np.int32)) for a in ops),
        page=PAGE)
    for g, w in ((gl, wl), (gk[:, 1:], np.asarray(wk)[:, 1:]),
                 (gv[:, 1:], np.asarray(wv)[:, 1:])):
        np.testing.assert_allclose(_f32(g), np.asarray(w, np.float32),
                                   atol=LOGIT_ATOL[dt], rtol=0)


@pytest.mark.parametrize("kind", ["mixed", "spec"])
@pytest.mark.parametrize("name", PAGED)
def test_mixed_and_spec_steps(name, kind):
    """One mixed step (a 5-token chunk at 13 forking page 6 into 3,
    beside 3 decode rows and an empty slot) and one verify step (row 2's
    5 drafts at 14, 2 decode rows): the family's steps against the JAX
    family's, ids and lengths equal, logits and real pages to 1e-4."""
    jm, tm, jc, tc, jp, tp = family(name)
    rs = np.random.RandomState(5)
    kp, vp = (rs.randn(jc.num_hidden_layers, 14, jc.num_key_value_heads,
                       PAGE, jc.head_dim).astype(np.float32)
              for _ in range(2))
    bt = np.array([[1, 2, 0, 0], [4, 5, 0, 0], [9, 10, 11, 12], [0] * 4],
                  np.int32)
    last = rs.randn(4, jc.vocab_size).astype(np.float32)
    bucket = 8
    ctoks = np.zeros((1, bucket), np.int32)
    if kind == "mixed":
        lens, active, c, off = [9, 15, 0, 3], [True, True, False, True], 5, 13
        bt[3] = [7, 8, 0, 0]
        ctoks[0, :c] = rs.randint(0, 256, c)
        cbt = np.array([9, 10, 3, 11], np.int32)
    else:
        lens, active, c, off = [9, 15, 14, 0], [True, True, False, False], \
            6, 14
        ctoks[0, 1:c] = last[2].argmax()
        cbt = bt[2]
    pos = off + np.arange(bucket)
    cphys = np.where(pos < off + c, cbt[np.minimum(pos // PAGE, 3)],
                     0).astype(np.int32)
    cslots = (pos % PAGE).astype(np.int32)
    args = (bt, np.array(lens, np.int32), last, np.array(active))
    ops = ((ctoks, c, off, cbt, cphys, cslots, 3, 6) if kind == "mixed"
           else (2, ctoks, c - 1, cbt, cphys, cslots))
    jstep, tstep = (getattr(m, f"paged_step_{kind}") for m in (jm, tm))
    want = jstep(jp, jc, jnp.asarray(kp), jnp.asarray(vp),
                 *map(jnp.asarray, args), 1.0, jax.random.PRNGKey(0),
                 *(jnp.asarray(a, jnp.int32) for a in ops), page=PAGE)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = tstep(tp, tc, tk, tv, *map(_t, args), 1.0, None,
                *(_t(np.asarray(a, np.int32)) for a in ops), page=PAGE)
    assert got[2] is tk and got[3] is tv
    # the JAX ids end in a fence element, which the port has not
    ids = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), ids[:4] if kind == "mixed"
                                  else ids[:-1])
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    pairs = [(got[1], want[1]), (tk[:, 1:], np.asarray(want[2])[:, 1:]),
             (tv[:, 1:], np.asarray(want[3])[:, 1:])]
    if kind == "mixed":
        pairs.append((got[5], want[6]))
    for g, w in pairs:
        np.testing.assert_allclose(_f32(g), np.asarray(w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [1, 4, 6, 8, 12, 32, 48, 64])
def test_alibi_slopes_bit_equal(n):
    np.testing.assert_array_equal(tb.alibi_slopes(n), jb.alibi_slopes(n))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_quantizers_and_presets(name):
    """The port's ``quantize_params`` on the carried dense weights equals
    the JAX one bit for bit; ``init_params(qtype=)``, drawn and quantized
    a layer at a time, equals quantizing the dense draw; the presets and
    linear shapes are the JAX package's."""
    jm, tm, jc, tc, _, _ = family(name)
    dense = jm.init_params(jc, 3, dtype=jnp.bfloat16)
    want = jax.tree_util.tree_map(np.asarray, jm.quantize_params(dense))
    got = tm.quantize_params(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, dense), "cpu"))
    _assert_same_tree(want, got)
    direct = tm.init_params(tc, 7, device="cpu", qtype="sym_int4")
    _assert_same_tree(_np(tm.quantize_params(tm.init_params(tc, 7,
                                                            device="cpu"))),
                      direct)
    with pytest.raises(NotImplementedError, match="sym_int4"):
        tm.quantize_params(tm.init_params(tc, 7, device="cpu"), "asym_int4")
    assert tm.linear_shapes(tc) == jm.linear_shapes(jc)
    for preset in ("pythia_70m", "starcoder_15b", "bloom_7b1"):
        if hasattr(jm, FAMILIES[name][2]) and hasattr(
                getattr(jm, FAMILIES[name][2]), preset):
            assert dataclasses.asdict(getattr(getattr(tm, FAMILIES[name][2]),
                                              preset)()) == \
                dataclasses.asdict(getattr(getattr(jm, FAMILIES[name][2]),
                                           preset)())


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else
            (v.view(torch.int16).numpy().view(jnp.bfloat16)
             if v.dtype == torch.bfloat16 else v.numpy())
            for k, v in tree.items()}


def _assert_same_tree(want, got):
    """Same keys, shapes, dtypes and bits."""
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_same_tree(w, g)
            continue
        g = _np({"x": g})["x"] if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def _hf_checkpoint(path, model_type):
    """A tiny HF checkpoint of ``model_type`` with every parameter
    random (biases and norms included), saved as safetensors."""
    transformers = pytest.importorskip("transformers")
    cfg, cls = {
        "gpt_neox": (dict(vocab_size=96, hidden_size=64,
                          intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=4, rotary_pct=0.25,
                          max_position_embeddings=64), "GPTNeoX"),
        "bloom": (dict(vocab_size=96, hidden_size=64, n_layer=2, n_head=4),
                  "Bloom"),
        "gpt_bigcode": (dict(vocab_size=96, n_embd=128, n_inner=512,
                             n_layer=2, n_head=4, n_positions=64,
                             multi_query=True), "GPTBigCode")}[model_type]
    torch.manual_seed(0)
    hf = getattr(transformers, cls + "ForCausalLM")(
        getattr(transformers, cls + "Config")(**cfg))
    with torch.no_grad():
        for p in hf.parameters():
            p.normal_(0, 0.2)
    hf.save_pretrained(str(path), safe_serialization=True)
    with open(path / "config.json") as f:
        assert json.load(f)["model_type"] == model_type


@pytest.mark.parametrize("qtype", [None, "sym_int4"])
@pytest.mark.parametrize("model_type", ["gpt_neox", "bloom", "gpt_bigcode"])
def test_from_pretrained(tmp_path, model_type, qtype):
    """``from_pretrained`` on a checkpoint of each ``model_type``: the
    family's model, parameters bit-identical to the JAX loader's, and
    prefill logits within bf16 tolerance of the JAX model's."""
    _hf_checkpoint(tmp_path, model_type)
    jmod = JAuto.from_pretrained(str(tmp_path), load_in_low_bit=qtype,
                                 max_cache_len=32)
    tmod = AutoModelForCausalLM.from_pretrained(
        str(tmp_path), load_in_low_bit=qtype, max_cache_len=32, device="cpu")
    assert type(tmod).__name__ == type(jmod).__name__
    assert dataclasses.asdict(tmod.config) == dataclasses.asdict(jmod.config)
    _assert_same_tree(jax.tree_util.tree_map(np.asarray, jmod.params),
                      tmod.params)
    ids = np.array([[3, 17, 42, 9, 60]], np.int32)
    want = np.asarray(jmod(jnp.asarray(ids))[0])
    np.testing.assert_allclose(tmod(ids)[0].numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())
