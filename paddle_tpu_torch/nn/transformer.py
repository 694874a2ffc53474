"""Transformer encoder layers (counterpart of
`paddle_tpu/nn/layer/transformer.py`: `MultiHeadAttention`,
`TransformerEncoderLayer`, `TransformerEncoder`).

Parameter names are the JAX layers' (`self_attn.q_proj`, `linear1`,
`norm1`, ...), so a JAX encoder's state dict loads by name. Attention
goes through `F.scaled_dot_product_attention`: the flash kernel with the
mask and dropout branches where head_dim is 64, 128 or 256, else
`mha_reference`. Dropout salts and attention dropout seeds are drawn from
the CPU generator `dropout_generator`. Decoding caches (`Cache`,
`StaticCache`) and `need_weights` are not ported and raise.
"""
import collections
import copy

from torch import nn

from . import functional as F
from .layer import Dropout, LayerList, LayerNorm, Linear

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention over [B, L, embed_dim] with separate q, k,
    v projections and `out_proj`; `attn_mask` is additive or boolean,
    broadcastable to [B, num_heads, Lq, Lk]."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_init=None, bias=True,
                 device=None, generator=None, dropout_generator=None):
        super().__init__()
        if need_weights:
            raise NotImplementedError(
                "MultiHeadAttention(need_weights=True) is not ported: the "
                "flash kernel never forms the weights")
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = float(dropout)
        self.generator = dropout_generator
        kw = dict(weight_init=weight_init, bias=bias, device=device,
                  generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        raise NotImplementedError("attention caches (decoding) are not "
                                  "ported")

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError("attention caches (decoding) are not "
                                      "ported")
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, generator=self.generator)
        out = out.reshape(out.shape[0], out.shape[1], self.embed_dim)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Self-attention then a feed-forward block, each with dropout and a
    residual: post-LN (`normalize_before=False`, BERT's) or pre-LN."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_init=None, bias=True,
                 device=None, generator=None, dropout_generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(weight_init=weight_init, bias=bias, device=device,
                  generator=generator)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, dropout_generator=dropout_generator,
            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout, generator=dropout_generator)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout, generator=dropout_generator)
        self.dropout2 = Dropout(dropout, generator=dropout_generator)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError("attention caches (decoding) are not "
                                      "ported")
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """`num_layers` deep copies of `encoder_layer` (the first is the layer
    itself), then the optional `norm`. With `generator`, each copy's
    parameters are drawn anew from it, in order (the JAX package's copies
    start equal); without, the copies keep the layer's values. The copies
    share the layer's dropout generators."""

    def __init__(self, encoder_layer, num_layers, norm=None, generator=None):
        super().__init__()
        shared = {id(m.generator): m.generator
                  for m in encoder_layer.modules()
                  if getattr(m, "generator", None) is not None}
        copies = [copy.deepcopy(encoder_layer, dict(shared))
                  for _ in range(num_layers - 1)]
        if generator is not None:
            for layer in copies:
                for m in layer.modules():
                    if hasattr(m, "reset_parameters"):
                        m.reset_parameters(generator)
        self.layers = LayerList([encoder_layer] + copies)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError("attention caches (decoding) are not "
                                      "ported")
        for layer in self.layers:
            src = layer(src, src_mask)
        return src if self.norm is None else self.norm(src)
