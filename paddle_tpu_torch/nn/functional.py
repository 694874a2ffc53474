"""Functionals of the GPT and BERT training paths and of sparse
attention (counterparts of `paddle_tpu/nn/functional`): Paddle's
signatures and layouts, PyTorch inside. `layer_norm`, `rms_norm`,
`scaled_dot_product_attention` and `sparse_attention` route to the
port's kernels by the JAX package's own rules; `dropout` draws its mask
from the JAX package's counter hash and scales as it does, bit for bit,
through the hash dropout kernel (`ops/dropout.py`)."""
import functools

import numpy as np
import torch
import torch.nn.functional as TF

from ..ops import block_sparse_attention as _bsa
from ..ops import dropout as _drop
from ..ops.attention import (_next_seed, flash_attention,
                             flash_attention_available, mha_reference)
from ..ops.layer_norm import fused_layer_norm, fused_rms_norm

__all__ = ["linear", "embedding", "gelu", "tanh", "relu", "dropout",
           "layer_norm", "rms_norm", "scaled_dot_product_attention",
           "sparse_attention", "cross_entropy"]


def linear(x, weight, bias=None, name=None):
    """y = x @ W (+ b), with Paddle's [in, out] weight. A bf16/fp16
    weight casts an f32 x down to its dtype (the JAX AMP rule,
    `amp_compute_cast`); any other mix of dtypes promotes, as `v @ w`
    does in JAX (a bf16 x and an f32 weight give f32), and the bias is
    added in the output's dtype."""
    if weight.dtype in (torch.bfloat16, torch.float16) and \
            x.dtype == torch.float32:
        x = x.to(weight.dtype)
    dtype = torch.promote_types(x.dtype, weight.dtype)
    return TF.linear(x.to(dtype), weight.t().to(dtype),
                     None if bias is None else bias.to(dtype))


def embedding(x, weight, padding_idx=None):
    """Rows of `weight` at the ids `x`. With `padding_idx`, the output is
    multiplied by (ids != padding_idx) — the JAX semantics, which also
    zeroes that row's gradient."""
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(weight.dtype)
    return out


def gelu(x, approximate=False):
    """GELU; `approximate=True` is the tanh form (jax.nn.gelu's)."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)


def relu(x):
    return torch.relu(x)


def _hash_keep(salt, shape, p, device=None):
    """Counter-hash bernoulli(1 - p) of `shape` for one 31-bit `salt`
    (the JAX `_hash_keep` after its salt draw): keep element i iff
    h32((i * 0x9E3779B1) ^ (salt * 0x85EBCA77)) >= min(int(p * 2^32),
    2^32 - 1), all mod 2^32."""
    return _drop._hash_keep_ref(salt, shape, p, device)


def _draw_salt(generator=None):
    """One dropout salt in [0, 2^31 - 1) from a CPU generator (the JAX
    `_hash_keep`'s `randint(key, (), 0, 2**31 - 1)`)."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))


_DROPOUT_MODES = ("upscale_in_train", "downscale_in_infer")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Paddle's dropout with the JAX package's mask and arithmetic: a salt
    in [0, 2^31 - 1) drawn per call from the CPU `generator` (None:
    torch's default CPU generator), then `_hash_keep(salt, mask_shape,
    p)`. The mask covers x, or with `axis` (an int or a list) only the
    listed axes, broadcast over the others (axes are matched as given, as
    in JAX). `mode="upscale_in_train"` gives where(keep, c(f32(x) /
    f32(c(1 - p))), 0), c() a cast to x's dtype (the JAX scalar 1 - p
    takes x's dtype); "downscale_in_infer" keeps without scaling. In eval
    or at p 0, x itself. Over the whole of x, the hash dropout kernel and
    its backward (`ops.dropout.hash_dropout`, which reads x contiguous);
    with `axis`, the mask kernel, then a broadcast `where`."""
    if mode not in _DROPOUT_MODES:
        raise ValueError(f"mode must be one of {_DROPOUT_MODES}, got "
                         f"{mode!r}")
    if not training or p == 0.0:
        return x
    upscale = mode == "upscale_in_train"
    salt = _draw_salt(generator)
    # a named range, so a profile can price the hash
    with torch.profiler.record_function("dropout_hash"):
        if axis is None:
            return _drop.hash_dropout(x, p, salt, upscale)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        mask_shape = tuple(x.shape[i] if i in axes else 1
                           for i in range(x.dim()))
        keep = _drop.hash_keep_mask(salt, mask_shape, p, x.device)
    return _drop._apply_keep(x, keep, p, upscale)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing `normalized_shape` axes. One axis with
    weight and bias takes `ops.layer_norm.fused_layer_norm` (as the JAX
    `F.layer_norm` takes its Pallas op); otherwise the plain form: f32
    statistics, cast, then scale and shift in x's dtype."""
    ns = (list(normalized_shape) if isinstance(normalized_shape, (list, tuple))
          else [normalized_shape])
    if len(ns) == 1 and weight is not None and bias is not None:
        return fused_layer_norm(x, weight, bias, eps=epsilon)
    axes = tuple(range(x.dim() - len(ns), x.dim()))
    x32 = x.float()
    mean = x32.mean(axes, keepdim=True)
    var = (x32 - mean).square().mean(axes, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis. With a weight, `ops.layer_norm.
    fused_rms_norm` (as the JAX `F.rms_norm` takes its Pallas op);
    without one, the plain form: f32 mean of squares, then the cast."""
    if weight is not None:
        return fused_rms_norm(x, weight, eps=epsilon)
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + epsilon)).to(x.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *,
                                 dropout_seed=None, generator=None):
    """[B, L, H, D] attention with an additive or boolean `attn_mask` and
    dropout on the probabilities (the JAX routing): the flash kernel
    where the JAX package takes it (head_dim 64, 128 or 256), else
    `mha_reference`. The dropout seed, unless given, is drawn in
    [0, 2^24) from the CPU `generator` (the JAX `_next_seed`)."""
    rate = float(dropout_p or 0.0) if training else 0.0
    if rate and dropout_seed is None:
        dropout_seed = _next_seed(generator)
    if flash_attention_available(query, attn_mask, rate):
        return flash_attention(query, key, value, causal=is_causal,
                               attn_mask=attn_mask, dropout_rate=rate,
                               dropout_seed=dropout_seed)
    return mha_reference(query, key, value, causal=is_causal,
                         attn_mask=attn_mask, dropout_rate=rate,
                         dropout_seed=dropout_seed or 0)


@functools.lru_cache(maxsize=16)
def _cached_block_layout(off_bytes, off_shape, col_bytes, col_shape, L,
                         device):
    """Sparsity patterns are static across steps: the O(L^2) host-side
    block-alignment detection runs once per distinct CSR (and device),
    not per call. Returns None or (block_size, block_cols, block_counts)
    with the arrays already on `device`."""
    off = np.frombuffer(off_bytes, np.int32).reshape(off_shape)
    cols = np.frombuffer(col_bytes, np.int32).reshape(col_shape)
    layout = _bsa.csr_to_block_layout(off, cols, L)
    if layout is None:
        return None
    bs, bcols, bcounts = layout
    return (bs, torch.from_numpy(bcols).to(device),
            torch.from_numpy(bcounts).to(device))


def _host_int32(t):
    """A CSR array read to the host once, as int32 numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t).astype(np.int32)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """CSR-sparsified softmax(QK^T/sqrt(d))V (the reference's
    `F.sparse_attention`). q/k/v: [B, H, L, D]; offset [B, H, L+1];
    columns [B, H, nnz]; masks use 0 = masked. A mask-free CSR that is
    exactly block-aligned (`csr_to_block_layout`, cached per CSR) runs
    the block-sparse kernel, whose work scales with the nonzero blocks;
    anything else, or a `key_padding_mask` / `attn_mask`, runs the dense
    masked path (plain torch) with the same semantics."""
    L = query.shape[-2]
    off, cols = _host_int32(sparse_csr_offset), _host_int32(sparse_csr_columns)
    if key_padding_mask is None and attn_mask is None:
        layout = _cached_block_layout(off.tobytes(), off.shape, cols.tobytes(),
                                      cols.shape, L, str(query.device))
        if layout is not None:
            bs, bcols, bcounts = layout
            return _bsa.block_sparse_attention(query, key, value, bcols,
                                               bcounts, bs)
    dev = query.device
    mask = _bsa.csr_element_mask(torch.from_numpy(off).to(dev),
                                 torch.from_numpy(cols).to(dev), L)
    return _bsa.dense_mask_sparse_attention(
        query, key, value, mask,
        None if key_padding_mask is None else torch.as_tensor(
            key_padding_mask, device=dev),
        None if attn_mask is None else torch.as_tensor(attn_mask,
                                                       device=dev))


def cross_entropy(input, label, weight=None, ignore_index=-100):
    """Mean hard-label softmax cross-entropy over the last axis, in f32;
    rows whose label is `ignore_index` are left out of the mean. Class
    weights (`weight`) are not ported and raise."""
    if weight is not None:
        raise NotImplementedError("cross_entropy class weights are not "
                                  "ported")
    logp = torch.log_softmax(input.float(), dim=-1)
    lab = label.long()
    if lab.dim() == logp.dim():
        lab = lab.squeeze(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    loss = -logp.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / valid.sum().float().clamp_min(1.0)
