"""Int8 activations x int8 weights (A8W8) linear: the counterpart of the
JAX package's int8 path, which has no Pallas kernel — XLA fuses the
activation quantize and runs an int8 dot with an int32 result in the
serving decoder's `_mm_heads` / `_mm` (`paddle_tpu/serving/decoder.py`,
dynamic per-row scales) and in `QuantizedLinearA8W8.forward`
(`paddle_tpu/quantization.py`, a static scale from calibration).

- `quantize_rows(x, sx=None)`: x [T, K] -> (int8 xq [T, K], f32 sx). With
  no `sx` each row's f32 absmax gives sx = max(amax / 127, 1e-8) [T]; a
  given sx (a 0-dim f32 tensor) quantizes every row with it. Then xq =
  clip(round(x32 / sx), -127, 127): a true division, round half to even
  (as `jnp.round`).
- `a8w8_matmul(xq, sx, wt, sw, b, order, dtype)`: the exact int32 product
  of xq and the K-contiguous weight wt [N, K] (the [K, N] int8 weight
  transposed), then the f32 epilogue in one of two orders — `DECODER`:
  (acc * sx) * sw + b (decoder.py's `_mm` / `_mm_heads`); `PTQ`: acc *
  (sw * sx) + b (`QuantizedLinearA8W8`) — with b added in f32 from its
  stored dtype, and the result cast to `dtype` last.
- `a8w8_linear(x, wt, sw, b, order, sx=None)`: both, for x [..., K], in
  x's dtype.

Their kernels are the hand-written CUDA `csrc/a8w8_matmul.cu`: a row
quantize (a warp a row) and an int8 tensor-core GEMM (mma.sync
m16n8k32 s8, a decode body for T <= 16 that cuts K over 8 warps, a
128 x 128 tile body with a cp.async ring beyond), at the plain versions'
rounding points, so they equal them bit for bit; the int32 sum is exact,
so a row's bits do not depend on T. The plain versions `_quantize_rows_ref`
and `_a8w8_ref` compute the product exactly in float64 (|acc| <= K * 127^2
< 2^53). A wrapper takes the plain version only for tensors on the CPU; on
CUDA tensors it launches the kernel or raises. `quantize_launches` /
`gemm_launches` count the kernels' launches, `plain_launches` the plain
calls, `kernel_launches` both kernels' launches together, and
`branch_launches` the GEMM's launches by body ("a8w8_gemm[decode]",
"a8w8_gemm[tile]").
"""
import ctypes

import torch

from . import _build
from ..device import div_const

__all__ = ["quantize_rows", "a8w8_matmul", "a8w8_linear", "DECODER", "PTQ",
           "quantize_launches", "gemm_launches", "kernel_launches",
           "plain_launches",
           "branch_launches", "reset_counts", "MAX_K"]

DECODER = 0     # (acc * sx) * sw + b
PTQ = 1         # acc * (sw * sx) + b
# the int32 accumulator cannot overflow: K * 127^2 < 2^31
MAX_K = (2 ** 31 - 1) // (127 * 127)

quantize_launches = 0
gemm_launches = 0
kernel_launches = 0         # both kernels' launches
plain_launches = 0
branch_launches = {}        # "a8w8_gemm[decode]": launches, ...
_KEYS = ("a8w8_gemm[decode]", "a8w8_gemm[tile]")   # the C side's routes


def reset_counts():
    global quantize_launches, gemm_launches, kernel_launches, plain_launches
    quantize_launches = 0
    gemm_launches = 0
    kernel_launches = 0
    plain_launches = 0
    branch_launches.clear()


def _quantize_rows_ref(x, sx=None):
    """Plain version: x [T, K] -> (int8 [T, K], sx [T] or the given sx)."""
    x32 = x.float()
    if sx is None:
        sx = torch.clamp_min(div_const(x32.abs().amax(dim=-1), 127.0),
                             1e-8)
        q = torch.round(x32 / sx[:, None])
    else:
        q = torch.round(x32 / sx)
    return torch.clamp(q, -127, 127).to(torch.int8), sx


def _a8w8_ref(xq, sx, wt, sw, b, order, dtype):
    """Plain version: the exact int32 product (float64 holds it exactly)
    rounded to f32, then the epilogue op by op (no fused multiply-add)."""
    acc = (xq.double() @ wt.double().t()).float()
    s = sx[:, None] if sx.dim() == 1 else sx
    y = acc * s * sw if order == DECODER else acc * (sw * s)
    if b is not None:
        y = y + b.float()
    return y.to(dtype)


_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("a8w8_matmul")
        lib.a8w8_quantize_rows.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.a8w8_quantize_rows.restype = ctypes.c_int
        lib.a8w8_gemm.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        lib.a8w8_gemm.restype = ctypes.c_int
        lib.a8w8_error_string.argtypes = [ctypes.c_int]
        lib.a8w8_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise(what, lib, rc):
    raise RuntimeError(f"{what} kernel launch failed: "
                       f"{lib.a8w8_error_string(rc).decode()} ({rc})")


def _check_static(sx, dev):
    if sx.dtype != torch.float32 or sx.numel() != 1 or \
            sx.get_device() != dev:
        raise ValueError(f"a8w8: a static scale is one float32 on the "
                         f"operands' card, got {sx.dtype} "
                         f"{tuple(sx.shape)} on {sx.device}")


def _launch_quantize(x, sx):
    global quantize_launches, kernel_launches
    T, K = x.shape
    dev = x.get_device()
    code = _CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"a8w8 quantize kernel takes float32/bfloat16/"
                        f"float16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("a8w8 quantize: x must be contiguous")
    if sx is not None:
        _check_static(sx, dev)
    xq = torch.empty((T, K), dtype=torch.int8, device=x.device)
    out_sx = sx if sx is not None else torch.empty(T, dtype=torch.float32,
                                                   device=x.device)
    if xq.numel() == 0:
        return xq, out_sx
    lib = _lib or _kernel_lib()
    rc = lib.a8w8_quantize_rows(
        x.data_ptr(), xq.data_ptr(),
        None if sx is not None else out_sx.data_ptr(),
        sx.data_ptr() if sx is not None else None, T, K, code, dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _raise("a8w8_quantize_rows", lib, rc)
    quantize_launches += 1
    kernel_launches += 1
    return xq, out_sx


def _launch_gemm(xq, sx, wt, sw, b, order, dtype):
    global gemm_launches, kernel_launches
    M, K = xq.shape
    N = wt.shape[0]
    dev = xq.get_device()
    ops = (sx, wt, sw) + (() if b is None else (b,))
    if any(t.get_device() != dev for t in ops):
        raise ValueError(f"a8w8_gemm: operands on {xq.device}, "
                         f"{[str(t.device) for t in ops]}")
    if not all(t.is_contiguous() for t in (xq,) + ops):
        raise ValueError("a8w8_gemm: operands must be contiguous")
    code = _CODES.get(dtype)
    bcode = -1 if b is None else _CODES.get(b.dtype)
    if code is None or bcode is None or xq.dtype != torch.int8 \
            or wt.dtype != torch.int8 or sw.dtype != torch.float32 \
            or sx.dtype != torch.float32:
        raise TypeError(f"a8w8_gemm kernel takes int8 xq and wt, float32 "
                        f"scales, a float32/bfloat16/float16 bias and "
                        f"output, got {xq.dtype}, {wt.dtype}, {sx.dtype}, "
                        f"{sw.dtype}, {None if b is None else b.dtype}, "
                        f"{dtype}")
    if wt.dim() != 2 or wt.shape[1] != K or sw.shape != (N,) or \
            (b is not None and b.shape != (N,)):
        raise ValueError(f"a8w8_gemm: xq {tuple(xq.shape)}, wt "
                         f"{tuple(wt.shape)}, sw {tuple(sw.shape)}, b "
                         f"{None if b is None else tuple(b.shape)}")
    if sx.dim() == 1 and sx.shape == (M,):
        stride = 1
    elif sx.numel() == 1 and sx.dim() == 0:
        stride = 0
    else:
        raise ValueError(f"a8w8_gemm: sx {tuple(sx.shape)} is neither a "
                         f"scale a row ({M}) nor one static scale")
    if K > MAX_K:
        raise ValueError(f"a8w8_gemm: K {K} > {MAX_K} could overflow the "
                         "int32 sum")
    out = torch.empty((M, N), dtype=dtype, device=xq.device)
    if out.numel() == 0:
        return out
    if K == 0:
        raise ValueError("a8w8_gemm: K is 0")
    lib = _lib or _kernel_lib()
    route = ctypes.c_int(-1)
    rc = lib.a8w8_gemm(
        xq.data_ptr(), sx.data_ptr(), stride, wt.data_ptr(), sw.data_ptr(),
        None if b is None else b.data_ptr(), bcode, out.data_ptr(), M, N, K,
        code, order, dev, torch._C._cuda_getCurrentRawStream(dev),
        ctypes.byref(route))
    if rc:
        _raise("a8w8_gemm", lib, rc)
    gemm_launches += 1
    kernel_launches += 1
    key = _KEYS[route.value]
    branch_launches[key] = branch_launches.get(key, 0) + 1
    return out


def quantize_rows(x, sx=None):
    """x [T, K] -> (int8 xq [T, K], f32 sx [T], or the static `sx`)."""
    global plain_launches
    if x.device.type == "cpu":
        plain_launches += 1
        return _quantize_rows_ref(x, sx)
    return _launch_quantize(x, sx)


def a8w8_matmul(xq, sx, wt, sw, b=None, order=DECODER, dtype=torch.float32):
    """The int8 product xq [M, K] . wt [N, K]^T through the epilogue of
    `order` -> [M, N] in `dtype`."""
    global plain_launches
    if order not in (DECODER, PTQ):
        raise ValueError(f"a8w8_matmul: order {order!r} is neither DECODER "
                         "(0) nor PTQ (1)")
    if xq.device.type == "cpu":
        plain_launches += 1
        return _a8w8_ref(xq, sx, wt, sw, b, order, dtype)
    return _launch_gemm(xq, sx, wt, sw, b, order, dtype)


def a8w8_linear(x, wt, sw, b=None, order=DECODER, sx=None):
    """x [..., K] -> [..., N] in x's dtype: the rows quantized (dynamic
    scales, or the static `sx`), then the int8 product and its epilogue."""
    K = x.shape[-1]
    if wt.shape[-1] != K:
        raise ValueError(f"a8w8_linear: x has {K} columns, the weight "
                         f"{wt.shape[-1]}")
    xf = x.reshape(-1, K).contiguous()
    xq, scale = quantize_rows(xf, sx)
    out = a8w8_matmul(xq, scale, wt, sw, b, order, x.dtype)
    return out.reshape(*x.shape[:-1], wt.shape[0])
