"""Fused LayerNorm and RMSNorm (counterpart of
`paddle_tpu/ops/layer_norm.py`).

`fused_layer_norm(x, w, b, eps)` normalises the last axis. Its forward is
the hand-written CUDA kernel `csrc/layer_norm.cu` (the JAX `_ln_kernel`:
f32 mean and variance, `y*w + b` in f32, then the cast); its plain
version `_ln_kernel_ref` does the same arithmetic in PyTorch. The
backward is PyTorch autograd of `_ln_ref`, which casts first and then
scales — the JAX `_ln_bwd`, which has no kernel either.

`fused_rms_norm(x, w, eps)` is the same for RMSNorm: the kernel
`rms_norm_kernel` of the same source (the JAX `_rms_kernel`: f32
mean(x^2), `x * rsqrt(var + eps) * w` in f32, one cast), its plain
version `_rms_kernel_ref`, and a backward by autograd of `_rms_ref` (the
JAX `_rms_bwd`).

The JAX shape rule stands: rows of a width that is not a multiple of 128,
or fewer than 8 rows, take `_ln_ref` / `_rms_ref` in the forward too. A
wrapper takes the plain version only for tensors on the CPU; on CUDA
tensors it launches the kernel or raises. `kernel_launches` counts the
LayerNorm kernel, `plain_launches` every LayerNorm forward that did not
launch it; `rms_kernel_launches` / `rms_plain_launches` count RMSNorm's
apart.
"""
import ctypes

import torch

from . import _build

__all__ = ["fused_layer_norm", "fused_rms_norm", "kernel_launches",
           "plain_launches", "rms_kernel_launches", "rms_plain_launches",
           "reset_counts"]

kernel_launches = 0
plain_launches = 0
rms_kernel_launches = 0
rms_plain_launches = 0


def reset_counts():
    global kernel_launches, plain_launches
    global rms_kernel_launches, rms_plain_launches
    kernel_launches = 0
    plain_launches = 0
    rms_kernel_launches = 0
    rms_plain_launches = 0


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


def _rms_ref(x, w, eps):
    """The JAX `_rms_ref`: normalise in f32, cast, then scale in x's
    dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _rms_kernel_ref(x, w, eps):
    """Plain version of the RMSNorm kernel (the JAX `_rms_kernel`): the
    scale in f32, then one cast."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


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
        lib.rms_norm_forward.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.rms_norm_forward.restype = ctypes.c_int
        lib.layer_norm_error_string.argtypes = [ctypes.c_int]
        lib.layer_norm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name, x, *params):
    h = x.shape[-1]
    for t in (x,) + params:
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if x.dtype not in _CODES or params[0].dtype not in _CODES or \
            any(t.dtype != params[0].dtype for t in params):
        raise TypeError(f"{name} kernel takes float32/bfloat16 x and "
                        f"weights of one such dtype, got {x.dtype}, "
                        f"{[t.dtype for t in params]}")
    if any(t.shape != (h,) for t in params):
        raise ValueError(f"{name}: weights {[tuple(t.shape) for t in params]}"
                         f" do not match width {h}")
    if h > 8192:
        raise ValueError(f"{name} kernel takes width <= 8192, got {h}")


def _launch(x, w, b, eps):
    global kernel_launches
    h = x.shape[-1]
    _check("fused_layer_norm", x, w, b)
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


def _rms_launch(x, w, eps):
    global rms_kernel_launches
    h = x.shape[-1]
    _check("fused_rms_norm", x, w)
    out = torch.empty_like(x)
    lib = _kernel_lib()
    rc = lib.rms_norm_forward(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // h, h,
        float(eps), _CODES[x.dtype], _CODES[w.dtype], x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(
            "rms_norm kernel launch failed: "
            f"{lib.layer_norm_error_string(rc).decode()} ({rc})")
    rms_kernel_launches += 1
    return out


def _rms_forward(x, w, eps):
    global rms_plain_launches
    h = x.shape[-1]
    n = x.numel() // max(h, 1)
    if h % 128 or n < 8:
        rms_plain_launches += 1
        return _rms_ref(x, w, eps)
    if x.device.type == "cpu":
        rms_plain_launches += 1
        return _rms_kernel_ref(x, w, eps)
    return _rms_launch(x, w, eps)


class _FusedRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rms_forward(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xs, ws = (t.detach().requires_grad_() for t in (x, w))
            dx, dw = torch.autograd.grad(_rms_ref(xs, ws, ctx.eps),
                                         (xs, ws), g)
        return dx, dw, None


def fused_rms_norm(x, weight, eps=1e-6):
    """RMSNorm over the last axis with a weight [h]."""
    return _FusedRMSNorm.apply(x.contiguous(), weight.contiguous(),
                               float(eps))
