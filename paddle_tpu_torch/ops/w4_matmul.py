"""Weight-only int4 matmul for decode, W4A16 (counterpart of
`paddle_tpu/ops/w4_matmul.py`).

Storage: per-output-channel symmetric int4 (q in [-7, 7], scale =
amax/7, `quantization.quantize_weight(bits=4)`), two values packed per
byte along the IN dim with a +8 offset (nibble value 1..15; even rows in
the low nibble). `quantize_w4` gives the JAX packer's bytes and scales on
the same f32 input.

`w4_matmul(x, packed, scale, K)` computes x [..., K] @ W [K, N] with f32
accumulation, out in x's dtype. Its kernel is the hand-written CUDA
`csrc/w4_matmul.cu`: the nibbles unpack in shared memory, so the
dequantized weight never exists in device memory; it takes any S, K
(odd included) and N, with no padding in device memory (the JAX
wrapper's pow2 blocks and its odd-K detour are TPU tiling). Its plain
version `_w4_ref` is the JAX `_w4_ref`: the f32 product with the
dequantized f32 weight. A wrapper takes the plain version only for
tensors on the CPU; on CUDA tensors it launches the kernel or raises.
`kernel_launches` / `plain_launches` count the calls of each.
"""
import ctypes

import torch

from . import _build
from ..quantization import quantize_weight

__all__ = ["quantize_w4", "w4_matmul", "kernel_launches", "plain_launches",
           "reset_counts"]

kernel_launches = 0
plain_launches = 0


def reset_counts():
    global kernel_launches, plain_launches
    kernel_launches = 0
    plain_launches = 0


def quantize_w4(w):
    """w [in, out] float -> (packed [ceil(in/2), out] int8 nibbles, scale
    [out] f32). An odd `in` pads one row of nibble 8 (value 0)."""
    K, N = w.shape
    q, scale = quantize_weight(w, axis=0, bits=4)
    q = (q.to(torch.int32) + 8).to(torch.uint8)             # 1..15
    if K % 2:
        q = torch.cat([q, torch.full((1, N), 8, dtype=torch.uint8,
                                     device=q.device)])
    lo, hi = q[0::2], q[1::2]                # even rows -> low nibble
    return (lo | (hi << 4)).view(torch.int8), scale.reshape(-1)


def _unpack_w4(packed, K):
    """packed [K2, N] int8 -> the integer weight [K, N] in [-7, 7]."""
    p = packed.to(torch.int32) & 0xFF        # int8 -> raw byte
    lo = (p & 0xF) - 8
    hi = ((p >> 4) & 0xF) - 8
    K2, N = p.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * K2, N)[:K]


def _w4_ref(x, packed, scale, K):
    """Plain version: x [S, K] in f32 times the dequantized f32 weight,
    cast to x's dtype."""
    w = _unpack_w4(packed, K).float() * scale
    return (x.float() @ w).to(x.dtype)


_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("w4_matmul")
        lib.w4_matmul_forward.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.w4_matmul_forward.restype = ctypes.c_int
        lib.w4_matmul_error_string.argtypes = [ctypes.c_int]
        lib.w4_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(x, packed, scale, K):
    """Check the operands and launch the CUDA kernel on the current
    stream. x [S, K] -> [S, N]."""
    global kernel_launches
    S = x.shape[0]
    N = packed.shape[1]
    for t in (x, packed, scale):
        if t.device != x.device:
            raise ValueError(f"w4_matmul: operands on {t.device} and "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError("w4_matmul: operands must be contiguous")
    if x.dtype not in _CODES or packed.dtype not in (torch.int8,
                                                     torch.uint8) \
            or scale.dtype != torch.float32:
        raise TypeError(f"w4_matmul kernel takes float32/bfloat16 x, int8 "
                        f"packed nibbles and float32 scales, got {x.dtype}, "
                        f"{packed.dtype}, {scale.dtype}")
    if packed.shape != ((K + 1) // 2, N) or scale.shape != (N,):
        raise ValueError(f"w4_matmul: packed {tuple(packed.shape)} and "
                         f"scale {tuple(scale.shape)} do not hold a "
                         f"[{K}, N] weight")
    out = torch.empty((S, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _kernel_lib()
    rc = lib.w4_matmul_forward(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        S, K, N, _CODES[x.dtype], x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(
            "w4_matmul kernel launch failed: "
            f"{lib.w4_matmul_error_string(rc).decode()} ({rc})")
    kernel_launches += 1
    return out


def w4_matmul(x, packed, scale, K):
    """x [..., K] @ the int4-packed weight -> [..., N] in x's dtype."""
    global plain_launches
    lead = x.shape[:-1]
    if x.shape[-1] != K:
        raise ValueError(f"w4_matmul: x has {x.shape[-1]} columns, the "
                         f"weight {K} rows")
    xf = x.reshape(-1, K)
    N = packed.shape[1]
    if x.device.type == "cpu":
        plain_launches += 1
        return _w4_ref(xf, packed, scale, K).reshape(*lead, N)
    return _launch(xf, packed, scale, K).reshape(*lead, N)
