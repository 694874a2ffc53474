"""Per-token LoRA delta of multi-LoRA serving (counterpart of `_lora_delta`
in `paddle_tpu/serving/decoder.py`, which has no Pallas body: XLA fuses its
gather and two einsums on the TPU).

`lora_delta_(qkv, y, A, B, aids)` adds, in place, each token's low-rank qkv
delta over the shared base weights: qkv[t] += cast((y[t] @ A[aids[t]]) @
B[aids[t]], qkv.dtype), with y [T, h] the post-ln1 activations and qkv
[T, 3*H*D] in the compute dtype (f32 or bf16), A [n_a, h, R] and B [n_a, R,
3*H*D] one layer's f32 bank (id 0 the exact zero bank) and aids [T] int32.
Its kernel is the hand-written CUDA `csrc/lora_delta.cu`: a shrink launch
(token x h slice) and an expand + add launch (token x column tile), the
bank read in place by adapter id, f32 sums in an order that depends only on
(h, R), id-0 rows left untouched. Its plain version `_lora_delta_ref` is the
JAX `_lora_delta`: the gathered bank and two f32 einsums. A wrapper takes the
plain version only for tensors on the CPU; on CUDA tensors it launches the
kernel or raises. `kernel_launches` / `plain_launches` count the calls of
each (a kernel call is two device launches).
"""
import ctypes

import torch

from . import _build

__all__ = ["lora_delta_", "kernel_launches", "plain_launches",
           "reset_counts", "MAX_RANK"]

kernel_launches = 0
plain_launches = 0
MAX_RANK = 256              # the kernel's block width bounds R
# h slices of the shrink launch a token: at decode (T 16) its 16 x 8
# blocks reach most of the card's 132 SMs; the sum over slices runs in
# slice order, so a token's bits do not depend on T
SPLIT = 8


def reset_counts():
    global kernel_launches, plain_launches
    kernel_launches = 0
    plain_launches = 0


def _lora_delta_ref(y, A, B, aids):
    """Plain version (the JAX `_lora_delta`): the f32 delta [T, N] from the
    per-token gathered bank."""
    idx = aids.long()
    z = torch.einsum("th,thr->tr", y.float(), A[idx])
    return torch.einsum("tr,trd->td", z, B[idx])


_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("lora_delta")
        lib.lora_delta_forward.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.lora_delta_forward.restype = ctypes.c_int
        lib.lora_delta_error_string.argtypes = [ctypes.c_int]
        lib.lora_delta_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(qkv, y, A, B, aids):
    """Check the operands and launch both kernels on the current stream."""
    global kernel_launches
    T, N = qkv.shape
    n_a, h, R = A.shape
    dev = qkv.get_device()
    if any(t.get_device() != dev for t in (y, A, B, aids)):
        raise ValueError(f"lora_delta: operands on {qkv.device}, {y.device}, "
                         f"{A.device}, {B.device} and {aids.device}")
    if not all(t.is_contiguous() for t in (qkv, y, A, B, aids)):
        raise ValueError("lora_delta: operands must be contiguous")
    code = _CODES.get(qkv.dtype)
    if code is None or y.dtype != qkv.dtype or A.dtype != torch.float32 \
            or B.dtype != torch.float32 or aids.dtype != torch.int32:
        raise TypeError(f"lora_delta kernel takes float32/bfloat16 qkv and y "
                        f"of one dtype, float32 A and B and int32 ids, got "
                        f"{qkv.dtype}, {y.dtype}, {A.dtype}, {B.dtype}, "
                        f"{aids.dtype}")
    if y.shape != (T, h) or B.shape != (n_a, R, N) or aids.shape != (T,):
        raise ValueError(f"lora_delta: qkv {tuple(qkv.shape)}, y "
                         f"{tuple(y.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, ids {tuple(aids.shape)}")
    if not 1 <= R <= MAX_RANK:
        raise ValueError(f"lora_delta: rank {R} outside 1..{MAX_RANK}")
    if T == 0:
        return qkv
    z = torch.empty((T, SPLIT, R), dtype=torch.float32, device=qkv.device)
    lib = _lib or _kernel_lib()
    rc = lib.lora_delta_forward(
        qkv.data_ptr(), y.data_ptr(), A.data_ptr(), B.data_ptr(),
        aids.data_ptr(), z.data_ptr(), T, h, R, N, n_a, SPLIT, code, dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        raise RuntimeError("lora_delta kernel launch failed: "
                           f"{lib.lora_delta_error_string(rc).decode()} "
                           f"({rc})")
    kernel_launches += 1
    return qkv


def lora_delta_(qkv, y, A, B, aids):
    """qkv [T, N] += each token's adapter delta, in place; returns qkv."""
    global plain_launches
    if qkv.device.type == "cpu":
        plain_launches += 1
        return qkv.add_(_lora_delta_ref(y, A, B, aids).to(qkv.dtype))
    return _launch(qkv, y, A, B, aids)
