"""Hash dropout (counterpart of the JAX `F.dropout`, `_hash_keep` +
`dropout` of `paddle_tpu/nn/functional/common.py`).

`hash_dropout(x, p, salt, upscale)` drops the elements of x whose
counter-hash bits (`_hash_bits` of the flat index and the
31-bit `salt`) fall below `attention._rate_thresh(p)`, and divides the
kept ones by 1 - p rounded to x's dtype (`upscale`, Paddle's
"upscale_in_train") or keeps them as they are ("downscale_in_infer"),
with the JAX package's arithmetic: c(f32(x) / f32(c(1 - p))), c() a
cast to x's dtype. It is a `torch.autograd.Function` whose backward is
the same function of the gradient (the vjp of the JAX `dropout`); it
saves the salt, p and the mode, no mask. Forward and backward are the
hand-written CUDA kernel `csrc/hash_dropout.cu` (no Pallas kernel: XLA
fuses the JAX function); `_hash_dropout_ref` is its plain version.
`hash_keep_mask(salt, shape, p, device)` is the keep mask alone, for
F.dropout's `axis` form, by the same source's mask kernel on the card.

A wrapper takes the plain version only for tensors on the CPU; on CUDA
tensors it launches the kernel or raises. `dropout_kernel_launches` /
`dropout_plain_launches` count the forward (`hash_dropout`), the
backward (`hash_dropout_bwd`) and the mask (`hash_dropout_mask`) by
name.
"""
import ctypes
import functools

import numpy as np
import torch

from . import _build
from .attention import _K_COL, _K_ROW, _hash32, _mul32, _rate_thresh

__all__ = ["hash_dropout", "hash_keep_mask", "dropout_kernel_launches",
           "dropout_plain_launches", "reset_counts"]

KERNELS = ("hash_dropout", "hash_dropout_bwd", "hash_dropout_mask")
dropout_kernel_launches = dict.fromkeys(KERNELS, 0)
dropout_plain_launches = dict.fromkeys(KERNELS, 0)


def reset_counts():
    for name in KERNELS:
        dropout_kernel_launches[name] = 0
        dropout_plain_launches[name] = 0


def _hash_bits(seed, shape, device=None):
    """The counter hash's 32 bits for each element of `shape` (int64
    values in [0, 2^32)): h32((i * 0x9E3779B1) ^ (salt * 0x85EBCA77)) of
    the flat index i, salt = seed mod 2^31, all mod 2^32: the mask bits
    of the hash dropout kernel and of the dropout + residual + LayerNorm
    kernel (`csrc/counter_hash.cuh`)."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = _mul32(torch.arange(n, dtype=torch.int64, device=device), _K_ROW)
    salt = (int(seed) % (1 << 31) * _K_COL) & 0xFFFFFFFF
    return _hash32(idx ^ salt).reshape(shape)


def _opmath(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


@functools.lru_cache(maxsize=None)
def _divisor_value(p, dtype):
    """1 - p rounded to `dtype` (the JAX weakly typed scalar takes x's
    dtype), as a Python float."""
    return float(torch.tensor(1.0 - p, dtype=dtype))


def _divisor(p, dtype, device):
    """`_divisor_value` as a 0-d tensor on `device` of the dtype the
    division runs in. A tensor, not a Python number: PyTorch on the card
    multiplies by the reciprocal of a scalar divisor, which is not the
    divide."""
    return torch.full((), _divisor_value(p, dtype), dtype=_opmath(dtype),
                      device=device)


def _apply_keep(x, keep, p, upscale):
    """where(keep, c(f32(x) / f32(c(1 - p))), 0) (upscale) or where(keep,
    x, 0); `keep` broadcasts over x. Autograd of it is the JAX vjp."""
    if upscale:
        x = (x.to(_opmath(x.dtype)) / _divisor(p, x.dtype, x.device)
             ).to(x.dtype)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _hash_keep_ref(salt, shape, p, device=None):
    """Plain version of the mask kernel: bits >= _rate_thresh(p)."""
    return _hash_bits(salt, shape, device) >= _rate_thresh(p)


def _hash_dropout_ref(x, salt, p, upscale=True):
    """Plain version of the kernel: the dropout of x (forward) or of the
    gradient (backward) under `salt`."""
    return _apply_keep(x, _hash_keep_ref(salt, x.shape, p, x.device), p,
                       upscale)


_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("hash_dropout")
        lib.hash_dropout.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_double,
                                     ctypes.c_float, ctypes.c_uint]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.hash_dropout.restype = ctypes.c_int
        lib.hash_dropout_mask.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double,
            ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
        lib.hash_dropout_mask.restype = ctypes.c_int
        lib.hash_dropout_error_string.argtypes = [ctypes.c_int]
        lib.hash_dropout_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_if(rc, name, lib):
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.hash_dropout_error_string(rc).decode()} "
                           f"({rc})")


def _launch(name, x, salt, p, upscale):
    """The kernel on contiguous x (or a gradient): one launch, none for
    an empty tensor."""
    if x.dtype not in _CODES:
        raise TypeError(f"hash dropout kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("hash dropout: the operand must be contiguous")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    lib = _kernel_lib()
    _raise_if(lib.hash_dropout(
        x.data_ptr(), out.data_ptr(), x.numel(), float(p),
        _divisor_value(p, x.dtype), int(salt), int(upscale),
        _CODES[x.dtype], x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream), name, lib)
    dropout_kernel_launches[name] += 1
    return out


def _run(name, x, salt, p, upscale):
    if x.device.type == "cpu":
        dropout_plain_launches[name] += 1
        return _hash_dropout_ref(x, salt, p, upscale)
    return _launch(name, x, salt, p, upscale)


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, salt, p, upscale):
        ctx.salt, ctx.p, ctx.upscale = salt, p, upscale
        return _run("hash_dropout", x, salt, p, upscale)

    @staticmethod
    def backward(ctx, g):
        return (_run("hash_dropout_bwd", g.contiguous(), ctx.salt, ctx.p,
                     ctx.upscale), None, None, None)


def hash_dropout(x, p, salt, upscale=True):
    """The dropout of x at rate p under the 31-bit `salt` (see the
    module's docstring), differentiable in x. x is made contiguous before
    the kernel reads it; the output is contiguous, of x's shape and
    dtype."""
    return _HashDropout.apply(x.contiguous(), int(salt), float(p),
                              bool(upscale))


def hash_keep_mask(salt, shape, p, device=None):
    """F.dropout's keep mask (bool, `shape`) at rate p under `salt`: the
    mask kernel on the card, its plain version on the CPU."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cpu":
        dropout_plain_launches["hash_dropout_mask"] += 1
        return _hash_keep_ref(salt, shape, p, device)
    keep = torch.empty(tuple(shape), dtype=torch.bool, device=device)
    n = int(np.prod(shape, dtype=np.int64))
    if n == 0:
        return keep
    lib = _kernel_lib()
    _raise_if(lib.hash_dropout_mask(
        keep.data_ptr(), n, float(p), int(salt), device.index or 0,
        torch.cuda.current_stream(device).cuda_stream), "hash_dropout_mask",
        lib)
    dropout_kernel_launches["hash_dropout_mask"] += 1
    return keep
