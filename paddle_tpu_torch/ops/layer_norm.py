"""Fused LayerNorm (counterpart of `paddle_tpu/ops/layer_norm.py`).

`fused_layer_norm(x, w, b, eps)` normalises the last axis. Its forward is
the hand-written CUDA kernel `csrc/layer_norm.cu` (the JAX `_ln_kernel`:
f32 mean and variance, `y*w + b` in f32, then the cast); its plain
version `_ln_kernel_ref` does the same arithmetic in PyTorch. The
backward is PyTorch autograd of `_ln_ref`, which casts first and then
scales — the JAX `_ln_bwd`, which has no kernel either.

The JAX shape rule stands: rows of a width that is not a multiple of 128,
or fewer than 8 rows, take `_ln_ref` in the forward too. A wrapper takes
the plain version only for tensors on the CPU; on CUDA tensors it
launches the kernel or raises. `kernel_launches` counts the kernel,
`plain_launches` every forward that did not launch it.
"""
import ctypes

import torch

from . import _build

__all__ = ["fused_layer_norm", "kernel_launches", "plain_launches",
           "reset_counts"]

kernel_launches = 0
plain_launches = 0


def reset_counts():
    global kernel_launches, plain_launches
    kernel_launches = 0
    plain_launches = 0


def _stats(x, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps)


def _ln_ref(x, w, b, eps):
    """The JAX `_ln_ref`: normalise in f32, cast, then scale and shift in
    x's dtype."""
    return _stats(x, eps).to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


def _ln_kernel_ref(x, w, b, eps):
    """Plain version of the kernel (the JAX `_ln_kernel`): the affine in
    f32, then one cast."""
    return (_stats(x, eps) * w.float() + b.float()).to(x.dtype)


_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("layer_norm")
        lib.layer_norm_forward.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.layer_norm_forward.restype = ctypes.c_int
        lib.layer_norm_error_string.argtypes = [ctypes.c_int]
        lib.layer_norm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(x, w, b, eps):
    global kernel_launches
    h = x.shape[-1]
    for t in (x, w, b):
        if t.device != x.device:
            raise ValueError(f"fused_layer_norm: operands on {t.device} "
                             f"and {x.device}")
        if not t.is_contiguous():
            raise ValueError("fused_layer_norm: operands must be contiguous")
    if x.dtype not in _CODES or w.dtype not in _CODES or b.dtype != w.dtype:
        raise TypeError(f"fused_layer_norm kernel takes float32/bfloat16 x "
                        f"and w/b of one such dtype, got {x.dtype}, "
                        f"{w.dtype}/{b.dtype}")
    if w.shape != (h,) or b.shape != (h,):
        raise ValueError(f"fused_layer_norm: w/b {tuple(w.shape)}/"
                         f"{tuple(b.shape)} do not match width {h}")
    if h > 8192:
        raise ValueError(f"fused_layer_norm kernel takes width <= 8192, "
                         f"got {h}")
    out = torch.empty_like(x)
    lib = _kernel_lib()
    rc = lib.layer_norm_forward(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        x.numel() // h, h, float(eps), _CODES[x.dtype], _CODES[w.dtype],
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(
            "layer_norm kernel launch failed: "
            f"{lib.layer_norm_error_string(rc).decode()} ({rc})")
    kernel_launches += 1
    return out


def _forward(x, w, b, eps):
    global plain_launches
    h = x.shape[-1]
    n = x.numel() // max(h, 1)
    if h % 128 or n < 8:
        plain_launches += 1
        return _ln_ref(x, w, b, eps)
    if x.device.type == "cpu":
        plain_launches += 1
        return _ln_kernel_ref(x, w, b, eps)
    return _launch(x, w, b, eps)


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(x, w, b)
        ctx.eps = eps
        return _forward(x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        with torch.enable_grad():
            xs, ws, bs = (t.detach().requires_grad_() for t in (x, w, b))
            y = _ln_ref(xs, ws, bs, ctx.eps)
            dx, dw, db = torch.autograd.grad(y, (xs, ws, bs), g)
        return dx, dw, db, None


def fused_layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm over the last axis with weight and bias [h]."""
    return _FusedLayerNorm.apply(x.contiguous(), weight.contiguous(),
                                 bias.contiguous(), float(eps))
