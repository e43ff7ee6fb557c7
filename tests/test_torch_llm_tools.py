"""The port's converter, CLI and LangChain wrappers
(``bigdl_tpu_torch/llm/{convert_model,cli,langchain}.py``) against the
JAX package's: a directory written by either package's ``save_model``
loads in the other with the same tree (every leaf's values bit for bit)
and the same greedy ids, the on-disk size order of q4_0 against dense,
the refusals, ``cli.main`` printing the JAX CLI's text, ``BigdlTpuLLM``
and ``BigdlTpuOpenAI`` giving the JAX wrappers' strings, and
``BigdlTpuEmbeddings`` within the f32 logit tolerance of the port's
Llama tests (``LOGIT_ATOL["f32"]`` = 1e-4)."""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm import cli as jcli
from bigdl_tpu.llm import convert_model as jconv
from bigdl_tpu.llm import langchain as jlc
from bigdl_tpu.llm.models import llama as jllama

from bigdl_tpu_torch.llm import cli as tcli
from bigdl_tpu_torch.llm import convert_model as tconv
from bigdl_tpu_torch.llm import langchain as tlc
from bigdl_tpu_torch.llm.api import ByteTokenizer
from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import llama as tllama
from bigdl_tpu_torch.llm.serving import LLMServer
from bigdl_tpu_torch.llm.worker import LLMWorker

LOGIT_ATOL_F32 = 1e-4        # tests/test_torch_llama.py LOGIT_ATOL["f32"]


def _convert(side, out, dtype="int4"):
    if side == "jax":
        return jconv.convert_model(jllama.LlamaConfig.tiny(), out,
                                   dtype=dtype, max_cache_len=64)
    return tconv.convert_model(tllama.LlamaConfig.tiny(), out, dtype=dtype,
                               max_cache_len=64, device="cpu")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A q4_0 and a dense directory written by each package."""
    root = tmp_path_factory.mktemp("llm")
    out = {}
    for side in ("jax", "torch"):
        for dtype in ("int4", None):
            out[side, dtype] = _convert(side, str(root / f"{side}-{dtype}"),
                                        dtype)
    return out


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _bits(a):
    """A leaf's values as comparable bits: bf16 through its 16-bit
    pattern, the rest as stored."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


@pytest.mark.parametrize("dtype", ["int4", None])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_directory_loads_in_either_package(dirs, writer, dtype):
    """Either package's directory: the same files' keys and config, the
    two loaders' trees equal leaf for leaf (a q4_0 scale, narrowed to
    bf16 by both loaders, is f32 in the port — its kernels' dtype — with
    the bf16 value), and the same greedy ids."""
    d = dirs[writer, dtype]
    other = dirs["torch" if writer == "jax" else "jax", dtype]
    with np.load(os.path.join(d, "weights.npz")) as z, \
            np.load(os.path.join(other, "weights.npz")) as zo:
        assert sorted(z.files) == sorted(zo.files)
        assert {k: z[k].dtype for k in z.files} == \
            {k: zo[k].dtype for k in zo.files}
    with open(os.path.join(d, "config.json")) as f, \
            open(os.path.join(other, "config.json")) as g:
        assert json.load(f) == json.load(g)
    jm = jconv.load_model(d, max_cache_len=64)
    tm = tconv.load_model(d, max_cache_len=64, device="cpu")
    want = _leaves(jax.tree_util.tree_map(np.asarray, jm.params))
    got = _leaves(tm.params)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k.endswith((".scale", ".zero")) and dtype == "int4":
            assert w.dtype.name == "bfloat16" and g.dtype == torch.float32
            w = w.astype(np.float32)
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)
    ids = np.array([[1, 2, 3, 200, 17]], np.int32)
    assert tm.generate(ids, max_new_tokens=8).tolist() == \
        jm.generate(ids, max_new_tokens=8).tolist()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_sizes_and_refusals(dirs, tmp_path, side):
    """q4_0 is smaller on disk than dense; ``int8`` (``sym_int8``) and any
    family but llama raise ``NotImplementedError`` in both packages."""
    size = {dt: os.path.getsize(os.path.join(dirs[side, dt], "weights.npz"))
            for dt in ("int4", None)}
    assert size["int4"] < size[None]
    with pytest.raises(NotImplementedError, match="q4_0"):
        _convert(side, str(tmp_path / "q8"), dtype="int8")
    conv = jconv if side == "jax" else tconv
    with pytest.raises(NotImplementedError, match="bloom"):
        conv.convert_model(None, str(tmp_path / "x"), model_family="bloom")


@pytest.mark.parametrize("argv", [
    ["-p", "hello", "-n", "4"],
    ["-p", "Once", "-n", "6", "--ctx_size", "32", "-t", "4"],
    ["-n", "3", "--temperature", "0"]])
def test_cli_main(dirs, capsys, argv):
    """``cli.main`` prints the JAX CLI's completion and its stderr
    ``[N tokens in Xs — Y tok/s]`` line."""
    d = dirs["torch", "int4"]
    outs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        assert main(["-m", d, "--ctx_size", "64"] + argv + extra) == 0
        outs.append(capsys.readouterr())
    assert outs[1].out == outs[0].out
    pat = r"\[(\d+) tokens in \d+\.\d\ds — \d+\.\d\d tok/s\]\n"
    assert [re.fullmatch(pat, o.err).group(1) for o in outs] == \
        [argv[argv.index("-n") + 1]] * 2


def test_cli_default_device_is_the_card(dirs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["-m", dirs["torch", "int4"], "-n", "1"])


@pytest.mark.parametrize("prompt,stop", [("hi", None), ("hi", "first"),
                                         ("abc", ["zz", "last"])])
def test_langchain_llm(dirs, prompt, stop):
    """``invoke`` / ``_call`` with ``stop``: the JAX wrapper's strings."""
    d = dirs["jax", "int4"]
    jl = jlc.BigdlTpuLLM(d, max_new_tokens=6, ctx_size=64)
    tl = tlc.BigdlTpuLLM(d, max_new_tokens=6, ctx_size=64, device="cpu")
    text = jl.invoke(prompt)
    assert tl.invoke(prompt) == text and tl(prompt) == text
    if stop == "first":
        stop = [text[1:2] or "x"]
    elif stop == "last":
        stop = ["zz", text[-1:] or "x"]
    assert tl._call(prompt, stop=stop) == jl._call(prompt, stop=stop)
    fm = tlc.BigdlTpuLLM.from_model(tl.model, max_new_tokens=3)
    assert fm.invoke(prompt) == jlc.BigdlTpuLLM.from_model(
        jl.model, max_new_tokens=3).invoke(prompt)
    assert (fm._llm_type, fm.temperature) == ("bigdl_tpu", 0.0)


def test_embeddings_f32():
    """Mean-pooled tied logits on the same f32 weights, within the f32
    logit tolerance."""
    cfg = jllama.LlamaConfig.tiny()
    p = jllama.init_params(cfg, 0, dtype=jnp.float32)
    jm = jllama.LlamaForCausalLM(cfg, p, max_cache_len=64)
    tm = tllama.LlamaForCausalLM(
        tllama.LlamaConfig.tiny(),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu"),
        device="cpu")
    je, te = jlc.BigdlTpuEmbeddings(jm), tlc.BigdlTpuEmbeddings(tm)
    want = je.embed_documents(["abc", "héllo"])
    got = te.embed_documents(["abc", "héllo"])
    assert [len(v) for v in got] == [cfg.vocab_size] * 2
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=LOGIT_ATOL_F32, rtol=0)


@pytest.fixture(scope="module")
def gateway():
    cfg = tllama.LlamaConfig.tiny()
    tm = tllama.LlamaForCausalLM.from_config(
        cfg, seed=0, load_in_low_bit="sym_int4", max_cache_len=64,
        device="cpu")
    srv = LLMServer(tm, max_batch=2, max_seq_len=64, page_size=16,
                    device="cpu").start()
    w = LLMWorker(srv, api=True, tokenizer=ByteTokenizer()).start()
    yield w
    w.stop()
    srv.stop()


@pytest.mark.parametrize("call", [
    lambda c: c.models(),
    lambda c: c.invoke([5, 9, 2, 6]),
    lambda c: c.invoke("hi", stop=["\x00"]),
    lambda c: c("abc"),
    lambda c: "".join(c.stream("hey")),      # chunks follow drain timing
    lambda c: c.chat([{"role": "user", "content": "hi"}]),
    lambda c: c._parse("http://h:1/v1") + c._parse("h:2")],
    ids=["models", "ids", "stop", "call", "stream", "chat", "parse"])
def test_openai_client(gateway, call):
    """The JAX client and the port's over one gateway: the same text."""
    url = "http://%s:%d/v1" % tuple(gateway.address)
    out = [call(lc.BigdlTpuOpenAI(url, max_tokens=5)) for lc in (jlc, tlc)]
    assert out[1] == out[0] and out[1]


@pytest.mark.parametrize("kw,call", [
    ({"model": "gpt-4o"}, lambda c: c.invoke([1])),
    ({"model": "gpt-4o"}, lambda c: list(c.stream([1]))),
    ({"model": "gpt-4o"}, lambda c: c.chat([])),
    ({}, lambda c: c.chat("oops"))])
def test_openai_client_errors(gateway, kw, call):
    """The API error mapping: the same ``RuntimeError`` text."""
    url = "%s:%d" % tuple(gateway.address)
    msgs = []
    for lc in (jlc, tlc):
        with pytest.raises(RuntimeError, match="gateway answered") as e:
            call(lc.BigdlTpuOpenAI(url, **kw))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    with pytest.raises(ValueError, match="host:port"):
        tlc.BigdlTpuOpenAI("http://nohost/v1")
