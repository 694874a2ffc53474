"""Flash attention (counterpart of `paddle_tpu/ops/attention.py`).

Layout is the JAX package's: q [B, Lq, Hq, D], k/v [B, Lk, Hkv, D] with
Hq % Hkv == 0 (GQA: query head h reads key/value head h // (Hq // Hkv)).

Two implementations of the same math:
  * the plain PyTorch version (`_fwd_ref`, `_bwd_ref`): the TPU kernels'
    walk over key tiles in f32 — an online softmax with the -1e30 mask,
    masked probabilities forced to 0 and the 1e-30 denominator floor;
    the backward recomputes P from the saved log-sum-exp;
  * the hand-written CUDA kernels `csrc/flash_attention.cu` (forward,
    dQ, dK/dV).
`flash_attention` is a `torch.autograd.Function`: its forward saves the
f32 log-sum-exp, its backward computes delta = sum(dO*O) in f32 as a
torch op and then runs dQ and dK/dV. A wrapper takes the plain version
only for tensors on the CPU; on CUDA tensors it launches the kernel or
raises. `kernel_launches` / `plain_launches` count each, per kernel.

`mha_reference` is the JAX package's plain reference (probabilities cast
to q's dtype before P.V); `nn.functional.scaled_dot_product_attention`
takes it where the flash kernel does not (head_dim outside 64/128/256).
"""
import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_available", "mha_reference",
           "kernel_launches", "plain_launches", "reset_counts"]

_NEG = -1e30
_DENOM_EPS = 1e-30
_BLOCK = 128          # key tile of the plain version's walk

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
kernel_launches = dict.fromkeys(KERNELS, 0)
plain_launches = dict.fromkeys(KERNELS, 0)


def reset_counts():
    for name in KERNELS:
        kernel_launches[name] = 0
        plain_launches[name] = 0


def flash_attention_available(query, attn_mask=None, dropout_p=0.0):
    """The JAX package's shape rule (`flash_attention_available`): the
    kernel tiles head_dim 64, 128 or 256."""
    return query.shape[3] in (64, 128, 256)


def mha_reference(q, k, v, causal=False, scale=None):
    """Plain attention with an f32 softmax, [B, L, H, D] in and out; GQA
    by repeating K/V heads; probabilities cast to q's dtype before P.V
    (the JAX `mha_reference`, masks and dropout aside)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    rep = q.shape[2] // k.shape[2]
    if rep != 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = (qh @ kh.transpose(-1, -2)).float() * scale
    if causal:
        Lq, Lk = logits.shape[-2:]
        keep = torch.ones((Lq, Lk), dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(keep, logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return (probs @ vh).transpose(1, 2)


# ---------------------------------------------------------------- plain

def _heads(q, k, v):
    """f32 [B, H, L, D] views, K/V repeated to the query heads."""
    rep = q.shape[2] // k.shape[2]
    qh = q.float().transpose(1, 2)
    kh = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vh = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    return qh, kh, vh


def _tile_mask(Lq, k0, k1, causal, device):
    """[Lq, k1 - k0] keep-mask of one key tile (None: keep all)."""
    if not causal:
        return None
    qpos = torch.arange(Lq, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    return qpos >= kpos


def _fwd_ref(q, k, v, causal, scale):
    """Plain forward: (out in q's dtype [B, Lq, Hq, D], lse f32
    [B, Hq, Lq])."""
    qh, kh, vh = _heads(q, k, v)
    qh = qh * scale
    B, H, Lq, D = qh.shape
    Lk = kh.shape[2]
    m = torch.full((B, H, Lq, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Lk, _BLOCK):
        k1 = min(k0 + _BLOCK, Lk)
        s = qh @ kh[:, :, k0:k1].transpose(-1, -2)
        keep = _tile_mask(Lq, k0, k1, causal, q.device)
        if keep is not None:
            s = torch.where(keep, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        if keep is not None:
            p = torch.where(keep, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vh[:, :, k0:k1]
        m = m_new
    lsafe = l.clamp_min(_DENOM_EPS)
    out = (acc / lsafe).transpose(1, 2).to(q.dtype)
    return out, (m + torch.log(lsafe))[..., 0]


def _bwd_ref(q, k, v, dout, lse, delta, causal, scale):
    """Plain backward from the saved lse and delta ([B, Hq, Lq] f32):
    (dq, dk, dv) in the dtypes of q, k, v."""
    qh, kh, vh = _heads(q, k, v)
    doh = dout.float().transpose(1, 2)
    B, H, Lq, D = qh.shape
    Lk = kh.shape[2]
    lse_, delta_ = lse[..., None], delta[..., None]
    dq = torch.zeros_like(qh)
    dkh = torch.zeros_like(kh)
    dvh = torch.zeros_like(vh)
    for k0 in range(0, Lk, _BLOCK):
        k1 = min(k0 + _BLOCK, Lk)
        kt, vt = kh[:, :, k0:k1], vh[:, :, k0:k1]
        s = (qh @ kt.transpose(-1, -2)) * scale
        keep = _tile_mask(Lq, k0, k1, causal, q.device)
        if keep is not None:
            s = torch.where(keep, s, _NEG)
        p = torch.exp(s - lse_)
        dp = doh @ vt.transpose(-1, -2)
        ds = p * (dp - delta_) * scale
        dq += ds @ kt
        dkh[:, :, k0:k1] = ds.transpose(-1, -2) @ qh
        dvh[:, :, k0:k1] = p.transpose(-1, -2) @ doh
    Hkv = k.shape[2]
    G = H // Hkv
    dk = dkh.reshape(B, Hkv, G, Lk, D).sum(2).transpose(1, 2)
    dv = dvh.reshape(B, Hkv, G, Lk, D).sum(2).transpose(1, 2)
    return (dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


# ---------------------------------------------------------------- kernel

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
        lib.flash_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
        lib.flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
        lib.flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + tail
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v, *rest):
    """Device, dtype, shape and contiguity of the kernels' operands."""
    B, Lq, Hq, D = q.shape
    _, Lk, Hkv, _ = k.shape
    for t in (q, k, v) + rest:
        if t.device != q.device:
            raise ValueError(f"flash_attention: operands on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError("flash_attention: operands must be contiguous")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape
            or Hq % Hkv):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         "(B, L, H, D) with Hq % Hkv == 0")
    if D not in (64, 128, 256):
        raise ValueError(f"flash_attention kernel takes head_dim 64, 128 "
                         f"or 256, got {D}")
    return (B, Lq, Lk, Hq, Hkv, D)


def _raise_on(rc, name, lib):
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.flash_error_string(rc).decode()} ({rc})")
    kernel_launches[name] += 1


def _tail(dims, causal, scale, q):
    return (*dims, int(bool(causal)), float(scale), _CODES[q.dtype],
            q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream)


def _fwd(q, k, v, causal, scale):
    """(out, lse): the kernel on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        plain_launches["flash_fwd"] += 1
        return _fwd_ref(q, k, v, causal, scale)
    dims = _check(q, k, v)
    B, Lq, _, Hq, _, _ = dims
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr(),
                       *_tail(dims, causal, scale, q))
    _raise_on(rc, "flash_fwd", lib)
    return out, lse


def _bwd(q, k, v, out, lse, dout, causal, scale):
    """(dq, dk, dv) from the saved out and lse."""
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if q.device.type == "cpu":
        plain_launches["flash_bwd_dq"] += 1
        plain_launches["flash_bwd_dkv"] += 1
        return _bwd_ref(q, k, v, dout, lse, delta, causal, scale)
    dims = _check(q, k, v, dout, lse, delta)
    B, Lq, _, Hq, _, _ = dims
    if dout.dtype != q.dtype or dout.shape != q.shape:
        raise ValueError("flash_attention: dO must match q's shape and dtype")
    if lse.shape != (B, Hq, Lq) or delta.shape != lse.shape or \
            lse.dtype != torch.float32:
        raise ValueError("flash_attention: lse and delta must be f32 "
                         f"[B, Hq, Lq] = {(B, Hq, Lq)}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernel_lib()
    tail = _tail(dims, causal, scale, q)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    _raise_on(lib.flash_bwd_dq(*ins, dq.data_ptr(), *tail),
              "flash_bwd_dq", lib)
    _raise_on(lib.flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *tail),
              "flash_bwd_dkv", lib)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal,
                          ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(query, key, value, causal=False, scale=None,
                    attn_mask=None, dropout_p=0.0):
    """Fused attention, [B, L, H, D] in and out, with GQA (key/value with
    fewer heads). Masks and attention dropout are later branches of the
    kernels and raise here."""
    if attn_mask is not None or float(dropout_p or 0.0) > 0.0:
        raise NotImplementedError(
            "flash_attention: attention masks and dropout are not ported "
            "yet (ROADMAP queue 2)")
    if query.shape[2] % key.shape[2]:
        raise ValueError(f"query heads ({query.shape[2]}) must be a "
                         f"multiple of key/value heads ({key.shape[2]})")
    sc = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    return _FlashAttention.apply(query.contiguous(), key.contiguous(),
                                 value.contiguous(), bool(causal), float(sc))
