"""Fused softmax cross-entropy (counterpart of the cross-entropy part of
`paddle_tpu/ops/fused_ops.py`).

`fused_softmax_cross_entropy(logits, labels)` gives the per-row loss
`lse - logits[label]` (f32) of logits [N, V]; it is a
`torch.autograd.Function` whose backward is `dx = (exp(x - lse) -
onehot) * g` in the logits' dtype. Forward and backward are the
hand-written CUDA kernels `csrc/softmax_cross_entropy.cu` (the JAX
`_xent_fwd_kernel` / `_xent_bwd_kernel`); `_xent_fwd_ref` /
`_xent_bwd_ref` are their plain versions, which walk the vocab in the
same 128-multiple blocks with a running max, sum and picked logit.

`can_fuse_xent` is the JAX shape rule without its backend test: rows a
multiple of 256 and a vocab with a 128-multiple block divisor. A wrapper
takes the plain version only for tensors on the CPU; on CUDA tensors it
launches the kernel or raises. `kernel_launches` / `plain_launches`
count each, per kernel.
"""
import ctypes

import torch

from . import _build

__all__ = ["can_fuse_xent", "fused_softmax_cross_entropy",
           "kernel_launches", "plain_launches", "reset_counts"]

KERNELS = ("xent_fwd", "xent_bwd")
kernel_launches = dict.fromkeys(KERNELS, 0)
plain_launches = dict.fromkeys(KERNELS, 0)


def reset_counts():
    for name in KERNELS:
        kernel_launches[name] = 0
        plain_launches[name] = 0


def _pick_block_v(v):
    """Largest vocab block (a multiple of 128) dividing v."""
    for cand in (1024, 768, 512, 384, 256, 128):
        if v % cand == 0:
            return cand
    raise ValueError(f"vocab {v} has no 128-multiple block divisor")


def can_fuse_xent(n, v):
    """True when the JAX package's streaming cross-entropy kernel would
    engage on these shapes (its backend test aside)."""
    if n <= 0 or n % 256 != 0:
        return False
    try:
        _pick_block_v(v)
        return True
    except ValueError:
        return False


def _xent_fwd_ref(logits, labels):
    """Plain forward: (loss, lse), f32 [N], from a walk over vocab
    blocks with a running max, sum and picked logit."""
    n, v = logits.shape
    bv = _pick_block_v(v)
    lab = labels.long()[:, None]
    m = torch.full((n, 1), -1e30, dtype=torch.float32, device=logits.device)
    s = torch.zeros((n, 1), dtype=torch.float32, device=logits.device)
    picked = torch.zeros((n, 1), dtype=torch.float32, device=logits.device)
    for j in range(0, v, bv):
        x = logits[:, j:j + bv].float()
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        s = s * torch.exp(m - m_new) + torch.exp(x - m_new).sum(
            -1, keepdim=True)
        m = m_new
        cols = j + torch.arange(bv, device=logits.device)
        picked = picked + torch.where(cols == lab, x, 0.0).sum(
            -1, keepdim=True)
    lse = m + torch.log(s.clamp_min(1e-30))
    return (lse - picked)[:, 0], lse[:, 0]


def _xent_bwd_ref(logits, labels, lse, g):
    """Plain backward: (exp(x - lse) - onehot) * g in the logits' dtype."""
    p = torch.exp(logits.float() - lse[:, None])
    cols = torch.arange(logits.shape[1], device=logits.device)
    onehot = (cols == labels.long()[:, None]).float()
    return ((p - onehot) * g[:, None]).to(logits.dtype)


_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("softmax_cross_entropy")
        lib.xent_forward.argtypes = ([ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.xent_backward.argtypes = ([ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p])
        lib.xent_forward.restype = ctypes.c_int
        lib.xent_backward.restype = ctypes.c_int
        lib.xent_error_string.argtypes = [ctypes.c_int]
        lib.xent_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(logits, labels, *rows):
    if logits.dim() != 2:
        raise ValueError(f"cross-entropy kernel takes logits [N, V], got "
                         f"{tuple(logits.shape)}")
    n = logits.shape[0]
    for t in (logits, labels) + rows:
        if t.device != logits.device:
            raise ValueError(f"cross-entropy: operands on {t.device} and "
                             f"{logits.device}")
        if not t.is_contiguous():
            raise ValueError("cross-entropy: operands must be contiguous")
        if t is not logits and t.shape != (n,):
            raise ValueError("cross-entropy: labels, lse and g must be [N]")
    if logits.dtype not in _CODES:
        raise TypeError(f"cross-entropy kernel takes float32 or bfloat16 "
                        f"logits, got {logits.dtype}")
    if labels.dtype != torch.int32 or any(r.dtype != torch.float32
                                          for r in rows):
        raise TypeError("cross-entropy: labels must be int32, lse and g "
                        "float32")


def _launched(rc, name, lib):
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.xent_error_string(rc).decode()} ({rc})")
    kernel_launches[name] += 1


def _stream(t):
    return (t.device.index or 0, torch.cuda.current_stream(t.device).cuda_stream)


def _fwd(logits, labels):
    if logits.device.type == "cpu":
        plain_launches["xent_fwd"] += 1
        return _xent_fwd_ref(logits, labels)
    _check(logits, labels)
    n, v = logits.shape
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    lib = _kernel_lib()
    _launched(lib.xent_forward(logits.data_ptr(), labels.data_ptr(),
                               loss.data_ptr(), lse.data_ptr(), n, v,
                               _CODES[logits.dtype], *_stream(logits)),
              "xent_fwd", lib)
    return loss, lse


def _bwd(logits, labels, lse, g):
    if logits.device.type == "cpu":
        plain_launches["xent_bwd"] += 1
        return _xent_bwd_ref(logits, labels, lse, g)
    _check(logits, labels, lse, g)
    n, v = logits.shape
    dx = torch.empty_like(logits)
    lib = _kernel_lib()
    _launched(lib.xent_backward(logits.data_ptr(), labels.data_ptr(),
                                lse.data_ptr(), g.data_ptr(), dx.data_ptr(),
                                n, v, _CODES[logits.dtype],
                                *_stream(logits)),
              "xent_bwd", lib)
    return dx


class _FusedSoftmaxCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = _fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        ctx.mark_non_differentiable(lse)
        return loss, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        logits, labels, lse = ctx.saved_tensors
        return _bwd(logits, labels, lse, g.float().contiguous()), None


def fused_softmax_cross_entropy(logits, labels):
    """(loss, lse), both f32 [N], of logits [N, V] against int labels
    [N]; the loss is differentiable in the logits."""
    return _FusedSoftmaxCrossEntropy.apply(
        logits.contiguous(), labels.to(torch.int32).contiguous())
