"""BERT / ERNIE encoders: configuration, presets, the encoder, the
pretraining (MLM + NSP) and sequence-classification heads, and the
pretraining loss (counterpart of `paddle_tpu/models/bert.py`).

Parameter names and shapes are the JAX models' state dicts, so a JAX
model's weights load by name (`convert.state_dict_from_numpy`). The
port's own initial weights are drawn at construction, in construction
order, from one `torch.Generator` seeded with `seed` on the parameters'
device, by the JAX initializers (embeddings N(0, 0.02), Linear
XavierUniform, LayerNorm 1/0, biases 0, the padding row 0); each encoder
layer draws its own (the JAX copies start equal). Dropout salts and
attention dropout seeds come from a CPU generator seeded with `seed`, so
a draw costs no host sync and a run on the card draws what a run on the
CPU draws. `cfg.dtype` "bfloat16"/"float16" casts every parameter,
LayerNorm's included, as the JAX models do.

The padding mask [B, L] of 1/0 becomes the additive (1 - m) * -1e4
[B, 1, 1, L], which the flash route reads as a per-key bias (kvb).
"""
import dataclasses

import torch
from torch import nn as tnn

from .. import nn
from ..device import get_device
from ..nn import functional as F
from ..nn.initializer import Normal
from .gpt import _TiedHead

__all__ = ["BertConfig", "BertEmbeddings", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "BertPretrainingCriterion",
           "ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "bert_base", "bert_large", "bert_tiny"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 0
    dtype: str = "float32"


def _generators(device, seed):
    """(parameter generator on `device`, CPU dropout generator), both
    seeded with `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    rng = torch.Generator()
    rng.manual_seed(int(seed))
    return g, rng


def _cast(module, cfg):
    if cfg.dtype in ("bfloat16", "float16"):
        module.to(getattr(torch, cfg.dtype))


class BertEmbeddings(tnn.Module):
    """word + position + token-type embeddings, LayerNorm (eps 1e-12),
    dropout; token types default to zeros."""

    def __init__(self, cfg, device=None, generator=None,
                 dropout_generator=None):
        super().__init__()
        init = Normal(0.0, 0.02)
        kw = dict(weight_init=init, device=device, generator=generator)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            padding_idx=cfg.pad_token_id,
                                            **kw)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size, **kw)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, epsilon=1e-12,
                                       device=device)
        self.dropout = nn.Dropout(cfg.hidden_dropout,
                                  generator=dropout_generator)

    def forward(self, input_ids, token_type_ids=None):
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertModel(tnn.Module):
    """Embeddings, a post-LN encoder (exact GELU, attention and hidden
    dropout, no activation dropout) and the pooler tanh(Linear(seq[:,
    0])). Returns (seq [B, L, H], pooled [B, H])."""

    def __init__(self, cfg, device=None, seed=0, generator=None,
                 dropout_generator=None):
        super().__init__()
        self.cfg = cfg
        dev = get_device(device)
        if generator is None or dropout_generator is None:
            generator, dropout_generator = _generators(dev, seed)
        self._rng = dropout_generator
        kw = dict(device=dev, generator=generator)
        self.embeddings = BertEmbeddings(cfg, dropout_generator=self._rng,
                                         **kw)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout, activation="gelu",
            attn_dropout=cfg.attention_dropout, act_dropout=0.0,
            dropout_generator=self._rng, **kw)
        self.encoder = nn.TransformerEncoder(enc_layer, cfg.num_layers,
                                             generator=generator)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        _cast(self, cfg)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        if attention_mask is not None:
            attention_mask = ((1.0 - attention_mask.float())
                              * -1e4)[:, None, None, :]
        x = self.embeddings(input_ids, token_type_ids)
        seq = self.encoder(x, attention_mask)
        pooled = F.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


class BertForPretraining(tnn.Module):
    """MLM + NSP heads. The MLM decoder is tied to the word embeddings:
    h @ E^T accumulated in f32 (f32 logits) plus `mlm_bias`, through
    GPT's `_TiedHead` (whose bf16 backward rounds the logits' gradient
    to bf16, as the TPU's default matmul precision does)."""

    def __init__(self, cfg, device=None, seed=0):
        super().__init__()
        dev = get_device(device)
        g, rng = _generators(dev, seed)
        self.cfg = cfg
        kw = dict(device=dev, generator=g)
        self.bert = BertModel(cfg, device=dev, generator=g,
                              dropout_generator=rng)
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                       **kw)
        self.mlm_norm = nn.LayerNorm(cfg.hidden_size, epsilon=1e-12,
                                     device=dev)
        self.mlm_bias = tnn.Parameter(torch.zeros(cfg.vocab_size,
                                                  device=dev))
        self.nsp = nn.Linear(cfg.hidden_size, 2, **kw)
        _cast(self, cfg)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        B, L, H = h.shape
        logits = _TiedHead.apply(
            h.reshape(B * L, H),
            self.bert.embeddings.word_embeddings.weight)
        mlm_logits = logits.reshape(B, L, -1) + self.mlm_bias
        return mlm_logits, self.nsp(pooled)


class BertPretrainingCriterion(tnn.Module):
    """Mean MLM cross-entropy over the labelled positions (-100 left
    out) plus the mean NSP cross-entropy, in f32."""

    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels):
        mlm = F.cross_entropy(mlm_logits.reshape(-1, self.vocab_size),
                              mlm_labels.reshape(-1), ignore_index=-100)
        return mlm + F.cross_entropy(nsp_logits, nsp_labels)


class BertForSequenceClassification(tnn.Module):
    """classifier(dropout(pooled)); `dropout` defaults to the config's
    hidden dropout."""

    def __init__(self, cfg, num_classes=2, dropout=None, device=None,
                 seed=0):
        super().__init__()
        dev = get_device(device)
        g, rng = _generators(dev, seed)
        self.bert = BertModel(cfg, device=dev, generator=g,
                              dropout_generator=rng)
        self.dropout = nn.Dropout(
            dropout if dropout is not None else cfg.hidden_dropout,
            generator=rng)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes,
                                    device=dev, generator=g)
        _cast(self, cfg)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


# ERNIE shares the architecture (the JAX package's aliases)
ErnieConfig = BertConfig
ErnieModel = BertModel
ErnieForSequenceClassification = BertForSequenceClassification


def bert_tiny(**kw):
    base = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
                intermediate_size=256, max_position_embeddings=128)
    base.update(kw)
    return BertConfig(**base)


def bert_base(**kw):
    return BertConfig(**kw)


def bert_large(**kw):
    base = dict(hidden_size=1024, num_layers=24, num_heads=16,
                intermediate_size=4096)
    base.update(kw)
    return BertConfig(**base)
