"""Fused LayerNorm and RMSNorm (counterpart of
`paddle_tpu/ops/layer_norm.py`).

`fused_layer_norm(x, w, b, eps)` normalises the last axis. Its forward is
the hand-written CUDA kernel `csrc/layer_norm.cu` (the JAX `_ln_kernel`:
f32 mean and variance, `y*w + b` in f32, then the cast), which also
writes each row's mean and rstd; its plain version `_ln_fwd_ref` does the
same arithmetic in PyTorch. The backward is the vjp of `_ln_ref`, which
casts first and then scales (the JAX `_ln_bwd`, a custom VJP that XLA
fuses on the TPU): the kernel `layer_norm_backward` of the same source,
from the saved mean and rstd, and its plain version `_ln_bwd_kernel_ref`.

`fused_rms_norm(x, w, eps)` is the same for RMSNorm: the kernel
`rms_norm_forward` of the same source (the JAX `_rms_kernel`: f32
mean(x^2), `x * rsqrt(var + eps) * w` in f32, one cast), its plain
version `_rms_kernel_ref`, and a backward by autograd of `_rms_ref` (the
JAX `_rms_bwd`; no model calls it).

The JAX shape rule stands: rows of a width that is not a multiple of 128,
or fewer than 8 rows, take `_ln_ref` / `_rms_ref` in the forward and
autograd of them in the backward. A wrapper takes the plain version only
for tensors on the CPU; on CUDA tensors it launches the kernel or raises.
`kernel_launches` counts the LayerNorm forward kernel, `plain_launches`
every LayerNorm forward that did not launch it; `bwd_kernel_launches` /
`bwd_plain_launches` count LayerNorm's backwards the same way;
`rms_kernel_launches` / `rms_plain_launches` count RMSNorm's forwards.
"""
import ctypes
import functools

import torch

from . import _build

__all__ = ["fused_layer_norm", "fused_rms_norm", "kernel_launches",
           "plain_launches", "bwd_kernel_launches", "bwd_plain_launches",
           "rms_kernel_launches", "rms_plain_launches", "reset_counts"]

kernel_launches = 0
plain_launches = 0
bwd_kernel_launches = 0
bwd_plain_launches = 0
rms_kernel_launches = 0
rms_plain_launches = 0


def reset_counts():
    global kernel_launches, plain_launches
    global bwd_kernel_launches, bwd_plain_launches
    global rms_kernel_launches, rms_plain_launches
    kernel_launches = 0
    plain_launches = 0
    bwd_kernel_launches = 0
    bwd_plain_launches = 0
    rms_kernel_launches = 0
    rms_plain_launches = 0


def _mean_rstd(x32, eps):
    """Each row's mean and 1 / sqrt(var + eps) of f32 x32, [..., 1]."""
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return mu, torch.rsqrt(var + eps)


def _stats(x, eps):
    x32 = x.float()
    mu, rstd = _mean_rstd(x32, eps)
    return (x32 - mu) * rstd


def _ln_ref(x, w, b, eps):
    """The JAX `_ln_ref`: normalise in f32, cast, then scale and shift in
    x's dtype."""
    return _stats(x, eps).to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


def _ln_fwd_ref(x, w, b, eps):
    """Plain version of the forward kernel (the JAX `_ln_kernel`): the
    affine in f32, then one cast; with each row's mean and rstd, [n] f32
    over the rows of x's leading axes."""
    x32 = x.float()
    mu, rstd = _mean_rstd(x32, eps)
    out = ((x32 - mu) * rstd * w.float() + b.float()).to(x.dtype)
    return out, mu.reshape(-1), rstd.reshape(-1)


def _ln_kernel_ref(x, w, b, eps):
    """The forward kernel's output in plain PyTorch."""
    return _ln_fwd_ref(x, w, b, eps)[0]


def _ln_bwd_f32(x, g, w, mean, rstd):
    """The backward's f32 values before their last casts: dx, and the
    column sums of dw's and db's terms (see `_ln_bwd_kernel_ref`)."""
    dt, h = x.dtype, x.shape[-1]
    mu = mean.reshape(*x.shape[:-1], 1)
    rs = rstd.reshape(*x.shape[:-1], 1)
    xhat = (x.float() - mu) * rs
    dxh = (g * w.to(dt)).float()
    dx = rs * (dxh - dxh.mean(-1, keepdim=True)
               - xhat * (dxh * xhat).mean(-1, keepdim=True))
    dw = (g * xhat.to(dt)).float().reshape(-1, h).sum(0)
    db = g.float().reshape(-1, h).sum(0)
    return dx, dw, db


def _ln_bwd_kernel_ref(x, g, w, mean, rstd):
    """Plain version of the backward kernel: the vjp of `_ln_ref` (cast
    first, then scale and shift in x's dtype, the JAX `_ln_bwd`) at its
    rounding points, written out. With c() a cast to x's dtype and xhat
    = (x - mean) * rstd in f32: dxh = f32(c(g * c(w))); dx = c(rstd *
    (dxh - mean(dxh) - xhat * mean(dxh * xhat))); dw = c(sum over rows of
    f32(c(g * c(xhat)))) and db = c(sum over rows of f32(g)), both then
    cast to w's dtype. Returns (dx, dw, db)."""
    dt = x.dtype
    dx, dw, db = _ln_bwd_f32(x, g, w, mean, rstd)
    return dx.to(dt), dw.to(dt).to(w.dtype), db.to(dt).to(w.dtype)


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
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.layer_norm_forward.restype = ctypes.c_int
        lib.layer_norm_backward_grid.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)])
        lib.layer_norm_backward_grid.restype = ctypes.c_int
        lib.layer_norm_backward.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.layer_norm_backward.restype = ctypes.c_int
        lib.rms_norm_forward.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.rms_norm_forward.restype = ctypes.c_int
        # the dropout + residual + LayerNorm mode (ops/fused_ops.py)
        lib.dropout_res_ln_forward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
            + [ctypes.c_float, ctypes.c_double, ctypes.c_uint]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.dropout_res_ln_forward.restype = ctypes.c_int
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


def _aligned(t):
    """t, or a copy of it if its data is not 16-byte aligned (the kernels
    read and write 16-byte vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, w, b, eps):
    """The forward kernel: (out, mean, rstd), mean and rstd [n] f32."""
    global kernel_launches
    h = x.shape[-1]
    _check("fused_layer_norm", x, w, b)
    x, w, b = (_aligned(t) for t in (x, w, b))
    n = x.numel() // h
    out = torch.empty_like(x)
    mean, rstd = torch.empty((2, n), dtype=torch.float32, device=x.device)
    lib = _kernel_lib()
    rc = lib.layer_norm_forward(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), n, h, float(eps), _CODES[x.dtype],
        _CODES[w.dtype], x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(
            "layer_norm kernel launch failed: "
            f"{lib.layer_norm_error_string(rc).decode()} ({rc})")
    kernel_launches += 1
    return out, mean, rstd


@functools.lru_cache(maxsize=None)
def _bwd_grid(n, h, dtype, wdtype, device):
    """The backward kernel's grid for [n, h] on `device` (its partials
    are [2, grid, h] f32)."""
    lib = _kernel_lib()
    grid = ctypes.c_int(0)
    rc = lib.layer_norm_backward_grid(n, h, dtype, wdtype, device,
                                      ctypes.byref(grid))
    if rc:
        raise RuntimeError(
            "layer_norm backward: no launch shape: "
            f"{lib.layer_norm_error_string(rc).decode()} ({rc})")
    return grid.value


def _bwd_launch(x, g, w, mean, rstd):
    """The backward kernel: (dx, dw, db)."""
    global bwd_kernel_launches
    h = x.shape[-1]
    _check("layer_norm backward", x, w)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"layer_norm backward: gradient {g.dtype} "
                         f"{tuple(g.shape)} for x {x.dtype} "
                         f"{tuple(x.shape)}")
    x, g, w = (_aligned(t.contiguous()) for t in (x, g, w))
    n = x.numel() // h
    dev = x.device.index or 0
    grid = _bwd_grid(n, h, _CODES[x.dtype], _CODES[w.dtype], dev)
    dx = torch.empty_like(x)
    dw, db = torch.empty((2, h), dtype=w.dtype, device=x.device)
    part = torch.empty((2, grid, h), dtype=torch.float32, device=x.device)
    lib = _kernel_lib()
    rc = lib.layer_norm_backward(
        x.data_ptr(), g.data_ptr(), w.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        part.data_ptr(), grid, n, h, _CODES[x.dtype], _CODES[w.dtype], dev,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(
            "layer_norm backward kernel launch failed: "
            f"{lib.layer_norm_error_string(rc).decode()} ({rc})")
    bwd_kernel_launches += 1
    return dx, dw, db


def _on_grid(x):
    """The kernels' shape rule (the JAX one): h % 128 == 0, n >= 8."""
    h = x.shape[-1]
    return h % 128 == 0 and x.numel() // max(h, 1) >= 8


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps):
        global plain_launches
        ctx.eps = eps
        ctx.on_grid = False
        if not _on_grid(x):
            plain_launches += 1
            ctx.save_for_backward(x, w, b)
            return _ln_ref(x, w, b, eps)
        if x.device.type == "cpu":
            plain_launches += 1
            out, mean, rstd = _ln_fwd_ref(x, w, b, eps)
        else:
            out, mean, rstd = _launch(x, w, b, eps)
        # the backward kernel returns db in w's dtype: the kernels take w
        # and b of one dtype, and the CPU takes autograd of `_ln_ref` for
        # mixed ones
        ctx.on_grid = w.dtype == b.dtype
        ctx.save_for_backward(*((x, w, mean, rstd) if ctx.on_grid
                                else (x, w, b)))
        return out

    @staticmethod
    def backward(ctx, g):
        global bwd_plain_launches
        if ctx.on_grid:
            x, w, mean, rstd = ctx.saved_tensors
            if x.device.type != "cpu":
                dx, dw, db = _bwd_launch(x, g, w, mean, rstd)
                return dx, dw, db, None
            bwd_plain_launches += 1
            dx, dw, db = _ln_bwd_kernel_ref(x, g, w, mean, rstd)
            return dx, dw, db, None
        bwd_plain_launches += 1
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
    x, w = _aligned(x), _aligned(w)
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
    if not _on_grid(x):
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
