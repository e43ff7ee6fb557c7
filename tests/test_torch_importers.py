"""The port's legacy importers (``bigdl_tpu_torch.utils.importers``) and
HF BERT loader (``bigdl_tpu_torch.models.bert.load_hf_bert_weights``)
held to the JAX package's on the CPU: each reads a file the test writes
(a torch ``.pt``, a TF2 checkpoint, a hand-encoded ``.caffemodel``, a
safetensors BERT) into a module of each package, and the two parameter
trees must be equal, bit for bit, with the same count assigned."""

import sys

import numpy as np
import pytest
import torch

import jax

import bigdl_tpu.nn as jnn
from bigdl_tpu.models import bert as jbert
from bigdl_tpu.utils import importers as jimp

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.models import bert as tbert
from bigdl_tpu_torch.utils import importers as timp


@pytest.fixture(autouse=True)
def _keep_jax_init_stream():
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    yield
    RNG._key, FORWARD_RNG._key = keys


def _tree(m):
    return jax.tree_util.tree_map(
        lambda a: a.detach().numpy() if isinstance(a, torch.Tensor)
        else np.asarray(a), m.parameters_dict())


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


def _net(nn):
    """conv1 (4, 3, 3, 3) + bias, fc (5, 6) + bias, fc2 (2, 5), no bias."""
    return (nn.Sequential()
            .add(nn.SpatialConvolution(3, 4, 3, 3, name="conv1"))
            .add(nn.Linear(6, 5, name="fc"))
            .add(nn.Linear(5, 2, with_bias=False, name="fc2")))


def _arrays(rs, transposed=False):
    fc = rs.randn(6, 5) if transposed else rs.randn(5, 6)
    return {"conv1.weight": rs.randn(4, 3, 3, 3), "conv1.bias": rs.randn(4),
            "fc.weight": fc, "fc.bias": rs.randn(5),
            "head.weight": rs.randn(2, 5)}


def _varint(v):
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _ld(field, payload):     # length-delimited field
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _blob(arr, legacy=False):
    a = np.asarray(arr, np.float32)
    if legacy:                 # V1 num / channels / height / width
        dims = (list(a.shape) + [1] * 4)[:4]
        head = b"".join(_varint((f << 3) | 0) + _varint(d)
                        for f, d in zip((1, 2, 3, 4), dims))
    else:
        head = _ld(7, b"".join(_varint((1 << 3) | 0) + _varint(d)
                               for d in a.shape))
    return head + _ld(5, a.astype("<f4").tobytes())


def _write(kind, tmp_path, rs):
    """The file (or object) each loader reads, and the loader's extra
    arguments."""
    if kind in ("pt file", "pt mapping", "pt transposed"):
        sd = {k: torch.from_numpy(v.astype(np.float32))
              for k, v in _arrays(rs, kind == "pt transposed").items()}
        p = str(tmp_path / "w.pt")
        torch.save(sd, p)
        kw = {"mapping": {"2.weight": "head.weight"}} \
            if kind == "pt mapping" else \
            {"transpose_linear": True} if kind == "pt transposed" else {}
        return "load_torch_state_dict", p, kw
    if kind == "tf2 checkpoint":
        tf = pytest.importorskip("tensorflow")
        v = {k.replace(".", "_"): tf.Variable(a.astype(np.float32))
             for k, a in _arrays(rs, transposed=True).items()}
        return "load_tf_checkpoint", tf.train.Checkpoint(**v).write(
            str(tmp_path / "ck")), {}
    a = _arrays(rs)
    v2 = (_ld(1, b"conv1") + _ld(2, b"Convolution")
          + _ld(6, _ld(1, b"shared_w"))     # a ParamSpec, not a blob
          + _ld(7, _blob(a["conv1.weight"])) + _ld(7, _blob(a["conv1.bias"])))
    v1 = (_ld(2, b"data") + _ld(3, b"fc_out") + _ld(4, b"fc")
          + _ld(6, _blob(a["fc.weight"], legacy=True))
          + _ld(6, _blob(a["fc.bias"], legacy=True)))
    p = tmp_path / "net.caffemodel"
    p.write_bytes(_ld(1, b"net") + _ld(100, v2) + _ld(2, v1))
    return "CaffeLoader.load_into", str(p), {}


def _loader(mod, name):
    if name == "CaffeLoader.load_into":
        return mod.CaffeLoader.load_into
    return getattr(mod, name)


@pytest.mark.parametrize("kind", ["pt file", "pt mapping", "pt transposed",
                                  "tf2 checkpoint", "caffemodel"])
def test_importer_loads_what_the_jax_loader_loads(kind, tmp_path):
    name, src, kw = _write(kind, tmp_path, np.random.RandomState(0))
    jm, tm = _net(jnn), _net(tnn)
    tm.load_parameters_dict(_tree(jm))     # the same starting weights
    n_j = _loader(jimp, name)(jm, src, **kw)
    n_t = _loader(timp, name)(tm, src, **kw)
    assert n_t == n_j > 0
    _assert_trees_equal(_tree(tm), _tree(jm))
    if kind == "caffemodel":
        got, want = timp.CaffeLoader.load(src), jimp.CaffeLoader.load(src)
        assert list(got) == list(want)
        for k in want:
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, b)


def test_importer_errors_and_missing_tensorflow(tmp_path, monkeypatch):
    name, src, _ = _write("pt file", tmp_path, np.random.RandomState(0))
    for mod, m in ((jimp, _net(jnn)), (timp, _net(tnn))):
        with pytest.raises(KeyError):
            mod.load_torch_state_dict(m, src, mapping={"0.weight": "nope"})
        with pytest.raises(ValueError):
            mod.load_torch_state_dict(m, src,
                                      mapping={"0.weight": "fc.bias"})
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="tensorflow"):
        timp.load_tf_checkpoint(_net(tnn), str(tmp_path / "ck"))


def _hf_bert(path, cfg, rs):
    """A HF-named BERT safetensors file of random weights (one name with
    the ``bert.`` prefix, the pooler in f16)."""
    from safetensors.numpy import save_file
    m = jbert.BertModel(cfg)
    p = jax.tree_util.tree_map(np.asarray, m.parameters_dict())
    names = {"embeddings.word_embeddings.weight": p["embeddings"]["word"],
             "embeddings.position_embeddings.weight":
                 p["embeddings"]["position"],
             "embeddings.token_type_embeddings.weight":
                 p["embeddings"]["token_type"],
             "embeddings.LayerNorm.weight": p["embeddings"]["norm"],
             "pooler.dense.weight": p["pooler"]}
    t = {}
    for hf, ours in names.items():
        leaf = ours["weight"] if isinstance(ours, dict) else ours
        t[hf] = rs.randn(*leaf.shape).astype(np.float32)
    t["embeddings.LayerNorm.bias"] = rs.randn(cfg.hidden_size)
    t["pooler.dense.bias"] = rs.randn(cfg.hidden_size)
    for i in range(cfg.num_hidden_layers):
        for hf, ours in jbert._HF_LAYER_MAP.items():
            leaf = p[f"layer{i}"]
            for seg in ours:
                leaf = leaf[seg]
            for w in ("weight", "bias"):
                t[f"encoder.layer.{i}.{hf}.{w}"] = rs.randn(
                    *leaf[w].shape)
    t = {k: v.astype(np.float16 if k.startswith("pooler") else np.float32)
         for k, v in t.items()}
    t["bert.embeddings.word_embeddings.weight"] = t.pop(
        "embeddings.word_embeddings.weight")
    save_file(t, str(path / "model.safetensors"))


def test_hf_bert_weights_equal_the_jax_loader(tmp_path):
    cfg_j, cfg_t = jbert.BertConfig.tiny(), tbert.BertConfig.tiny()
    _hf_bert(tmp_path, cfg_j, np.random.RandomState(1))
    jm = jbert.load_hf_bert_weights(jbert.BertModel(cfg_j), str(tmp_path))
    tm = tbert.load_hf_bert_weights(tbert.BertModel(cfg_t), str(tmp_path))
    _assert_trees_equal(_tree(tm), _tree(jm))
    ids = np.random.RandomState(2).randint(0, cfg_j.vocab_size, (2, 6))
    want = np.asarray(jm.evaluate().forward(ids.astype(np.int32))["pooled"])
    got = tm.eval()(torch.from_numpy(ids))["pooled"].detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
