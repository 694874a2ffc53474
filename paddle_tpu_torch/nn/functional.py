"""Functionals of the GPT, BERT and ResNet training paths and of sparse
attention (counterparts of `paddle_tpu/nn/functional`): Paddle's
signatures and layouts, PyTorch inside. `layer_norm`, `rms_norm`,
`scaled_dot_product_attention` and `sparse_attention` route to the
port's kernels by the JAX package's own rules; `dropout` draws its mask
from the JAX package's counter hash and scales as it does, bit for bit,
through the hash dropout kernel (`ops/dropout.py`). `conv2d`,
`batch_norm`, `max_pool2d` and `adaptive_avg_pool2d` (ResNet's; XLA code
in the JAX package, no Pallas kernel) take NCHW or NHWC tensors and
return the layout they were given: an NHWC tensor runs through PyTorch
as its NCHW permutation, a `channels_last` tensor, with no copy.
Scalars enter low-precision arithmetic rounded to the tensor's dtype
first, as JAX's weakly typed Python scalars do (`_weak`)."""
import functools
import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..ops import block_sparse_attention as _bsa
from ..ops import dropout as _drop
from ..ops.attention import (_next_seed, flash_attention,
                             flash_attention_available, mha_reference)
from ..ops.layer_norm import fused_layer_norm, fused_rms_norm
from .layout import resolve_data_format

__all__ = ["amp_compute_cast", "linear", "embedding", "gelu", "tanh",
           "relu", "dropout", "layer_norm", "rms_norm",
           "scaled_dot_product_attention", "sparse_attention",
           "cross_entropy", "conv2d", "batch_norm", "max_pool2d",
           "adaptive_avg_pool2d"]


def amp_compute_cast(x, w):
    """The JAX AMP rule shared by linear and conv: a bf16/fp16 weight
    casts an f32 x down to its dtype; any other pair is left as it is."""
    if w.dtype in (torch.bfloat16, torch.float16) and \
            x.dtype == torch.float32:
        return x.to(w.dtype)
    return x


def linear(x, weight, bias=None, name=None):
    """y = x @ W (+ b), with Paddle's [in, out] weight. A bf16/fp16
    weight casts an f32 x down to its dtype (the JAX AMP rule,
    `amp_compute_cast`); any other mix of dtypes promotes, as `v @ w`
    does in JAX (a bf16 x and an f32 weight give f32), and the bias is
    added in the output's dtype."""
    x = amp_compute_cast(x, weight)
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


def _weak(value, dtype):
    """A Python scalar as JAX's weak typing makes it beside a tensor of
    `dtype`: rounded to that dtype (bf16(0.9) = 0.8984375), handed back
    as a Python float. Exact in the f32 arithmetic PyTorch then does, so
    `t * _weak(c, t.dtype)` rounds where JAX's `c * t` does."""
    if not dtype.is_floating_point:
        return value
    return float(torch.tensor(value, dtype=dtype))


def _ntuple(v, n):
    """The JAX `_tuple` (conv's and pooling's): an int repeated, a list
    of n, or its first entry repeated."""
    if isinstance(v, (list, tuple)):
        return (tuple(int(x) for x in v) if len(v) == n
                else tuple(int(v[0]) for _ in range(n)))
    return (int(v),) * n


def _same_pads(size, k, s, d=1):
    """`lax.padtype_to_pads` "SAME" for one dim: out = ceil(size / s),
    the total pad split low-first (the extra one on the high side)."""
    eff = d * (k - 1) + 1
    total = max((-(-size // s) - 1) * s + eff - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(pad, size, k, s, d):
    """[(lo, hi)] per spatial dim from a resolved padding (a list of
    pairs, "SAME" or "VALID")."""
    if pad == "SAME":
        return [_same_pads(*a) for a in zip(size, k, s, d)]
    if pad == "VALID":
        return [(0, 0)] * len(size)
    if isinstance(pad, str):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {pad!r}")
    return list(pad)


def _symmetric(pads):
    """The per-dim pad PyTorch's own `padding=` takes, or None where a pad
    is uneven or negative (then the caller pads explicitly)."""
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        return [lo for lo, _ in pads]
    return None


def _explicit_pad(v, pads, value=0.0):
    """`v` [N, C, H, W] padded by [(lo, hi)] per spatial dim (negative
    pads crop, as in lax)."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return TF.pad(v, flat, value=value)


def _padding(padding, n):
    """The JAX `_padding` (conv's; pooling's `_pads` is the same without
    the nested form): a string upper-cased; n values; 2n values (lo, hi
    per dim); the nested form [[lo, hi], ...], with or without the batch
    and channel dims' pairs; an int. (The JAX functions test the lengths
    n and 2n first, so for 2-D the nested forms, 2 or 4 pairs, raise
    TypeError there; the port reads them as pairs.)"""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (list, tuple)):
        nested = any(isinstance(p, (list, tuple)) for p in padding)
        if len(padding) == n and not nested:
            return [(int(p), int(p)) for p in padding]
        if len(padding) == 2 * n and not nested:
            return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                    for i in range(n)]
        flat = [tuple(int(q) for q in p) if isinstance(p, (list, tuple))
                else (int(p), int(p)) for p in padding]
        if len(flat) == n + 2:
            flat = flat[2:]
        return flat
    return [(int(padding), int(padding))] * n


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format=None, name=None):
    """2-D convolution with Paddle's weight [O, I/groups, kH, kW] in
    either layout. The JAX rules: `amp_compute_cast`, then the weight
    cast to x's dtype; the bias added after the convolution in its
    dtype. Padding as an int, 2 values, 4 (lo, hi per dim), the nested
    form, "SAME" (low-first, as lax) or "VALID"; an uneven pad is applied
    by `F.pad` before the convolution. NHWC in, NHWC out (the convolution
    runs on its channels_last NCHW view)."""
    data_format = resolve_data_format(data_format, 2)
    channel_last = data_format == "NHWC"
    stride, dilation = _ntuple(stride, 2), _ntuple(dilation, 2)
    x = amp_compute_cast(x, weight)
    w = weight.to(x.dtype)
    v = x.permute(0, 3, 1, 2) if channel_last else x
    pads = _spatial_pads(_padding(padding, 2), v.shape[2:],
                         w.shape[2:], stride, dilation)
    sym = _symmetric(pads)
    if sym is None:
        v, sym = _explicit_pad(v, pads), [0, 0]
    out = TF.conv2d(v, w, None, stride, sym, dilation, groups)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out.permute(0, 2, 3, 1) if channel_last else out


class _BatchStatsNorm(torch.autograd.Function):
    """(f32(x) - mean) * rsqrt(var + eps) over `dims`, cast to x's dtype,
    with the batch's f32 mean and biased variance (returned beside it,
    not differentiated) in jnp.var's order: mean = sum / n, var =
    sum((x - mean)^2) / n, true divisions. Saves x, mean and rstd only;
    the backward is the batch-statistics vjp in f32, rstd (dy - mean(dy)
    - xhat mean(dy xhat))."""

    @staticmethod
    def forward(ctx, x, dims, shape, eps):
        x32 = x.float()
        n = torch.full((), x32.numel() // max(math.prod(shape), 1),
                       dtype=torch.float32, device=x.device)
        mean = x32.sum(dims) / n
        xc = x32 - mean.reshape(shape)
        var = xc.square().sum(dims) / n
        rstd = torch.rsqrt(var + eps)
        out = (xc * rstd.reshape(shape)).to(x.dtype)
        ctx.save_for_backward(x, mean, rstd)
        ctx.dims, ctx.shape = dims, shape
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        x, mean, rstd = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        rstd = rstd.reshape(shape)
        xhat = (x.float() - mean.reshape(shape)) * rstd
        g32 = g.float()
        dx = rstd * (g32 - g32.mean(dims, keepdim=True)
                     - xhat * (g32 * xhat).mean(dims, keepdim=True))
        return dx.to(x.dtype), None, None, None


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format=None, use_global_stats=None, name=None):
    """Batch norm with the JAX semantics. Channel axis 1 ("NC...") or -1.
    Statistics: the batch's f32 mean and biased variance in training
    (unless `use_global_stats`), the running buffers otherwise. x - mean
    is normalized in f32 and cast to x's dtype, then scaled and shifted
    in x's dtype (two roundings in bf16). In training the buffers are
    updated in place, momentum * running + (1 - momentum) *
    batch_stat.astype(running.dtype), Paddle's sense of momentum, the
    biased variance, and each scalar rounded to the buffer's dtype first
    (bf16: 0.8984375 and 0.10009765625 at momentum 0.9)."""
    # a named range, so a profile can price the eager chain
    with torch.profiler.record_function("batch_norm"):
        return _batch_norm(x, running_mean, running_var, weight, bias,
                           training, momentum, epsilon,
                           resolve_data_format(data_format, 2),
                           use_global_stats)


def _batch_norm(x, running_mean, running_var, weight, bias, training,
                momentum, epsilon, data_format, use_global_stats):
    use_global = (not training) if use_global_stats is None \
        else use_global_stats
    ax = (1 if data_format.startswith("NC") else -1) % x.dim()
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    dims = tuple(i for i in range(x.dim()) if i != ax)
    if use_global:
        var = running_var + _weak(epsilon, running_var.dtype)
        out = ((x.float() - running_mean.reshape(shape))
               * torch.rsqrt(var).reshape(shape)).to(x.dtype)
    else:
        out, mean, var = _BatchStatsNorm.apply(x, dims, shape, epsilon)
    if weight is not None:
        out = out * weight.reshape(shape).to(x.dtype)
    if bias is not None:
        out = out + bias.reshape(shape).to(x.dtype)
    if training and not use_global:
        with torch.no_grad():
            for buf, stat in ((running_mean, mean), (running_var, var)):
                dt = buf.dtype
                buf.copy_(buf * _weak(momentum, dt)
                          + stat.to(dt) * _weak(1 - momentum, dt))
    return out


def _ceil_extend(size, k, s, pad):
    """The JAX `_ceil_extend`: ceil_mode's extra high pad, with the
    torch/Paddle rule that a window starting past input + low pad is
    dropped."""
    pl, ph = pad
    eff = size + pl + ph
    out_floor = (eff - k) // s + 1
    out_ceil = -(-(eff - k) // s) + 1
    if out_ceil > out_floor and (out_ceil - 1) * s >= size + pl:
        out_ceil -= 1
    return pl, ph + max(0, (out_ceil - 1) * s + k - eff)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format=None, name=None):
    """Max pooling over padding of -inf (the lowest integer for integer
    x), in either layout; `ceil_mode` extends the high pad by the JAX
    rule. A window's gradient goes to its first largest element in
    row-major order, as the vjp of JAX's `reduce_window` max does.
    `return_mask` is not ported and raises."""
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not "
                                  "ported")
    data_format = resolve_data_format(data_format, 2)
    channel_last = data_format == "NHWC"
    k = _ntuple(kernel_size, 2)
    s = _ntuple(stride if stride is not None else kernel_size, 2)
    v = x.permute(0, 3, 1, 2) if channel_last else x
    size = v.shape[2:]
    pads = _spatial_pads(_padding(padding, 2), size, k, s, (1, 1))
    if ceil_mode:
        pads = [_ceil_extend(*a) for a in zip(size, k, s, pads)]
    sym = _symmetric(pads)
    with torch.profiler.record_function("pooling"):
        if sym is None or any(p > kk // 2 for p, kk in zip(sym, k)):
            low = (-float("inf") if v.dtype.is_floating_point
                   else torch.iinfo(v.dtype).min)
            v, sym = _explicit_pad(v, pads, low), [0, 0]
        out = TF.max_pool2d(v, k, s, sym)
    return out.permute(0, 2, 3, 1) if channel_last else out


def _mean_keepdim(v, ax):
    """jnp.mean over one axis, kept: summed in f32 (bf16/fp16 upcast),
    divided by the count as a true division (a 0-d tensor on v's device:
    PyTorch's division by a Python scalar multiplies by its reciprocal on
    CUDA), then cast back to a floating v's dtype."""
    s = v.sum(ax, keepdim=True, dtype=torch.float32)
    out = s / torch.full((), v.shape[ax], dtype=torch.float32,
                         device=v.device)
    return out.to(v.dtype) if v.dtype.is_floating_point else out


def adaptive_avg_pool2d(x, output_size, data_format=None, name=None):
    """Adaptive average pooling as the JAX `_adaptive_avg`: one spatial
    axis after the other (H, then W), bin i of o over [floor(i s / o),
    ceil((i + 1) s / o)), each bin's mean rounded to x's dtype, so a bf16
    x rounds after each axis. `output_size` an int or a pair (None keeps
    that axis's size)."""
    data_format = resolve_data_format(data_format, 2)
    spatial = [1, 2] if data_format == "NHWC" else [x.dim() - 2, x.dim() - 1]
    osz = (output_size if isinstance(output_size, (list, tuple))
           else [output_size] * 2)
    osz = [x.shape[ax] if o is None else int(o) for ax, o in zip(spatial, osz)]
    out = x
    with torch.profiler.record_function("pooling"):
        for ax, o in zip(spatial, osz):
            s_in = out.shape[ax]
            bins = [_mean_keepdim(out.narrow(ax, (i * s_in) // o,
                                             -(-(i + 1) * s_in // o)
                                             - (i * s_in) // o), ax)
                    for i in range(o)]
            out = bins[0] if o == 1 else torch.cat(bins, dim=ax)
    return out
