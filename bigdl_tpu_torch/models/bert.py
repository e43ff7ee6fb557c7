"""BERT on the port's nn stack — the port of ``bigdl_tpu/models/bert.py``
(ref: BASELINE config 4, BERT-base).

The module tree, keys and weight names are the JAX package's, so its
weights carry across with ``load_parameters_dict``.
:func:`load_hf_bert_weights` maps a HF ``bert-base-uncased``-family
safetensors checkpoint onto this tree, read by the port's own
``llm/transformers/st_reader.SafetensorsReader`` (no ``safetensors``
package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.nn.layers.attention import TransformerEncoderLayer
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab: int = 64) -> "BertConfig":
        return cls(vocab_size=vocab, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=64,
                   max_position_embeddings=64, hidden_dropout_prob=0.0)


def _split_bert_input(x):
    """token_ids | Table/tuple(token_ids[, segment_ids[, mask]])."""
    if isinstance(x, Table):
        vals = list(x.values())
    elif isinstance(x, (tuple, list)):
        vals = list(x)
    else:
        vals = [x]
    ids = vals[0]
    segs = vals[1] if len(vals) > 1 else None
    mask = vals[2] if len(vals) > 2 else None
    return ids, segs, mask


class BertEmbeddings(Module):
    def __init__(self, cfg: BertConfig, name: Optional[str] = None):
        super().__init__(name)
        self.cfg = cfg
        self._modules["word"] = nn.Embedding(cfg.vocab_size,
                                             cfg.hidden_size)
        self._modules["position"] = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self._modules["token_type"] = nn.Embedding(cfg.type_vocab_size,
                                                   cfg.hidden_size)
        self._modules["norm"] = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)
        self._modules["drop"] = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x):
        ids, segs, _ = _split_bert_input(x)
        b, t = ids.shape
        if segs is None:
            segs = torch.zeros_like(ids)
        pos = torch.arange(t, device=ids.device).expand(b, t)
        h = self.word(ids) + self.position(pos) + self.token_type(segs)
        return self.drop(self.norm(h))


class BertModel(Module):
    """Encoder + pooler. Output: Table(output=sequence, pooled=pooled)."""

    def __init__(self, cfg: BertConfig, name: Optional[str] = None):
        super().__init__(name)
        self.cfg = cfg
        self._modules["embeddings"] = BertEmbeddings(cfg)
        for i in range(cfg.num_hidden_layers):
            self._modules[f"layer{i}"] = TransformerEncoderLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.intermediate_size, dropout=cfg.hidden_dropout_prob)
        self._modules["pooler"] = nn.Linear(cfg.hidden_size,
                                            cfg.hidden_size)
        self._modules["pooler_act"] = nn.Tanh()

    def forward(self, x):
        _, _, mask = _split_bert_input(x)
        h = self.embeddings(x)
        for i in range(self.cfg.num_hidden_layers):
            h = self._modules[f"layer{i}"](
                (h, mask) if mask is not None else h)
        pooled = self.pooler_act(self.pooler(h[:, 0]))
        return Table(output=h, pooled=pooled)


class BertForSequenceClassification(Module):
    """BERT + classifier head; emits f32 log-probs."""

    def __init__(self, cfg: BertConfig, num_labels: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.cfg = cfg
        self.num_labels = num_labels
        self._modules["bert"] = BertModel(cfg)
        self._modules["drop"] = nn.Dropout(cfg.hidden_dropout_prob)
        self._modules["classifier"] = nn.Linear(cfg.hidden_size, num_labels)

    def forward(self, x):
        pooled = self.bert(x)["pooled"]
        logits = self.classifier(self.drop(pooled))
        return torch.log_softmax(logits.float(), dim=-1)


def build_classifier(cfg: Optional[BertConfig] = None, num_labels: int = 2,
                     device=None) -> BertForSequenceClassification:
    """A classifier with weights from the global init stream
    (``nn.set_seed``), on ``device`` (``None`` = the GPU)."""
    dev = resolve_device(device)
    return BertForSequenceClassification(cfg or BertConfig.base(),
                                         num_labels).to(dev)


# ---------------------------------------------------------------------------
# HF checkpoint interop
# ---------------------------------------------------------------------------

_HF_LAYER_MAP = {
    "attention.self.query": ("attention", "q"),
    "attention.self.key": ("attention", "k"),
    "attention.self.value": ("attention", "v"),
    "attention.output.dense": ("attention", "out"),
    "attention.output.LayerNorm": ("attn_norm",),
    "intermediate.dense": ("ffn1",),
    "output.dense": ("ffn2",),
    "output.LayerNorm": ("ffn_norm",),
}


def load_hf_bert_weights(model: BertModel, path: str) -> BertModel:
    """Map a HF BERT safetensors checkpoint (a file, or a directory of
    ``*.safetensors``) onto a :class:`BertModel` (names per
    transformers' bert-base; a ``bert.`` prefix is tolerated). Each
    weight lands in f32 on its param's device."""
    from bigdl_tpu_torch.llm.transformers.st_reader import SafetensorsReader

    with SafetensorsReader(path, prefix_fallbacks=("", "bert.")) as r:
        def get(name):
            return r.get(name)

        p = model.parameters_dict()
        emb = p["embeddings"]
        emb["word"]["weight"] = get("embeddings.word_embeddings.weight")
        emb["position"]["weight"] = get(
            "embeddings.position_embeddings.weight")
        emb["token_type"]["weight"] = get(
            "embeddings.token_type_embeddings.weight")
        emb["norm"]["weight"] = get("embeddings.LayerNorm.weight")
        emb["norm"]["bias"] = get("embeddings.LayerNorm.bias")
        for i in range(model.cfg.num_hidden_layers):
            layer = p[f"layer{i}"]
            for hf_name, ours in _HF_LAYER_MAP.items():
                dst = layer
                for seg in ours:
                    dst = dst[seg]
                base = f"encoder.layer.{i}.{hf_name}"
                dst["weight"] = get(f"{base}.weight")
                dst["bias"] = get(f"{base}.bias")
        p["pooler"]["weight"] = get("pooler.dense.weight")
        p["pooler"]["bias"] = get("pooler.dense.bias")
        model.load_parameters_dict(p)
    return model
