"""Functionals the GPT training path uses (counterparts of
`paddle_tpu/nn/functional`): Paddle's signatures and layouts, PyTorch
inside. `layer_norm` and `scaled_dot_product_attention` route to the
port's kernels by the JAX package's own rules."""
import torch
import torch.nn.functional as TF

from ..ops.attention import (flash_attention, flash_attention_available,
                             mha_reference)
from ..ops.layer_norm import fused_layer_norm

__all__ = ["linear", "embedding", "gelu", "dropout", "layer_norm",
           "scaled_dot_product_attention", "cross_entropy"]


def linear(x, weight, bias=None):
    """y = x @ W (+ b), with Paddle's [in, out] weight. A bf16/fp16
    weight casts an f32 x down to its dtype (the JAX AMP rule,
    `amp_compute_cast`)."""
    if weight.dtype in (torch.bfloat16, torch.float16) and \
            x.dtype == torch.float32:
        x = x.to(weight.dtype)
    return TF.linear(x, weight.t(), bias)


def embedding(x, weight):
    return TF.embedding(x, weight)


def gelu(x, approximate=False):
    """GELU; `approximate=True` is the tanh form (jax.nn.gelu's)."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def dropout(x, p=0.5, training=True, generator=None):
    """Paddle's upscale-in-train dropout: keep with probability 1 - p and
    scale the kept values by 1 / (1 - p); the mask is drawn from
    `generator`."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


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


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """[B, L, H, D] attention. Takes the flash kernel where the JAX
    package does (head_dim 64, 128 or 256), else `mha_reference`. Masks
    and attention dropout are not ported yet and raise."""
    rate = float(dropout_p or 0.0) if training else 0.0
    if flash_attention_available(query, attn_mask, rate):
        return flash_attention(query, key, value, causal=is_causal,
                               attn_mask=attn_mask, dropout_p=rate)
    if attn_mask is not None or rate > 0.0:
        raise NotImplementedError(
            "scaled_dot_product_attention: masks and dropout are not "
            "ported yet (ROADMAP queue 2)")
    return mha_reference(query, key, value, causal=is_causal)


def cross_entropy(input, label, ignore_index=-100):
    """Mean hard-label softmax cross-entropy over the last axis, in f32;
    rows whose label is `ignore_index` are left out of the mean."""
    logp = torch.log_softmax(input.float(), dim=-1)
    lab = label.long()
    if lab.dim() == logp.dim():
        lab = lab.squeeze(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    loss = -logp.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / valid.sum().float().clamp_min(1.0)
