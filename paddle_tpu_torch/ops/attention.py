"""Flash attention (counterpart of `paddle_tpu/ops/attention.py`).

Layout is the JAX package's: q [B, Lq, Hq, D], k/v [B, Lk, Hkv, D] with
Hq % Hkv == 0 (GQA: query head h reads key/value head h // (Hq // Hkv)).

Features, as the TPU kernels have them: causal masking, GQA, an additive
bias per key (`kvb` [Bm, Lk], padding masks) or a full additive bias
(`fb` [Bm, Hm, Lq, Lk]), and dropout on the attention probabilities from
a counter hash of (seed, batch, kv-head, folded row, column), which the
backward regenerates (nothing is stored). A bias is not a mask: only
causal and ragged positions force p = 0.

Two implementations of the same math:
  * the plain PyTorch version (`_fwd_ref`, `_bwd_ref`): the TPU kernels'
    walk over key tiles — an online softmax with the -1e30 mask, masked
    probabilities forced to 0 and the 1e-30 denominator floor; the
    backward recomputes P from the saved log-sum-exp. In f32 it is the
    TPU kernels' arithmetic; for bf16 q/k/v the forward follows the
    tensor-core kernel's rounding points (s = (q.k)*scale on the stored
    values, p rounded to bf16 before P.V, 64-key tiles);
  * the hand-written CUDA kernels `csrc/flash_attention.cu` (forward,
    dQ, dK/dV), templated on the bias kind and on dropout; the bf16
    forward runs on the tensor cores, the f32 forward and both backward
    kernels on the CUDA cores (SIMT).
`flash_attention` is a `torch.autograd.Function`: its forward saves the
f32 log-sum-exp, its backward computes delta = sum(dO*O) in f32 as a
torch op and then runs dQ and dK/dV with the same bias and seed. A
wrapper takes the plain version only for tensors on the CPU; on CUDA
tensors it launches the kernel or raises. `kernel_launches` /
`plain_launches` count each, per kernel; `branch_launches` counts the
kernel launches per body and template branch
("flash_fwd[tc,kvb+dropout]", "flash_bwd_dq[simt,kvb+dropout]").

`mha_reference` is the JAX package's plain reference (probabilities cast
to q's dtype before P.V, mask and hash dropout included);
`nn.functional.scaled_dot_product_attention` takes it where the flash
kernel does not (head_dim outside 64/128/256).

The dropout hash is the JAX package's, bit for bit: lowbias32 (`_hash32`)
on uint32 counters, keep iff hash >= min(int(rate * 2^32), 2^32 - 1).
torch has no uint32 multiply on every backend, so the counters live in
int64 and every product is reduced mod 2^32 (`_mul32`).
"""
import ctypes
import math

import numpy as np
import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_available", "mha_reference",
           "kernel_launches", "plain_launches", "branch_launches",
           "reset_counts"]

_NEG = -1e30
_DENOM_EPS = 1e-30
_BLOCK = 128          # key tile of the plain version's f32 walk
_TC_BLOCK = 64        # key tile of the bf16 tensor-core kernel and its walk

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
kernel_launches = dict.fromkeys(KERNELS, 0)
plain_launches = dict.fromkeys(KERNELS, 0)
# kernel launches by template branch: "flash_fwd[kvb+dropout]", ...
branch_launches = {}


def reset_counts():
    for name in KERNELS:
        kernel_launches[name] = 0
        plain_launches[name] = 0
    branch_launches.clear()


def flash_attention_available(query, attn_mask=None, dropout_p=0.0):
    """The JAX package's shape rule (`flash_attention_available`): the
    kernel tiles head_dim 64, 128 or 256."""
    return query.shape[3] in (64, 128, 256)


# ---------------------------------------------------------------- hash

_M32 = 0xFFFFFFFF
_K_ROW = 0x9E3779B1
_K_COL = 0x85EBCA77
_K_B = 0xC2B2AE3D
_K_H = 0x27D4EB2F


def _mul32(x, c):
    """(x * c) mod 2^32 for an int64 tensor x in [0, 2^32) and a constant
    c < 2^32, without overflowing int64: c is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x):
    """The lowbias32 finalizer of the JAX `_hash32` on uint32 values held
    in an int64 tensor."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _rate_thresh(rate):
    """The uint32 keep threshold of a drop rate (the JAX `_rate_thresh`)."""
    return min(int(float(rate) * 4294967296.0), 4294967295)


def _seed_u32(seed):
    """The JAX kernels receive the seed as an f32 and cast it to int32 and
    then uint32; exact for the seeds `_next_seed` draws (< 2^24)."""
    return int(np.float32(seed)) & _M32


def _drop_salt(seed_u32, b, h):
    """Per (batch, kv-head) salt, b and h ints or int64 tensors."""
    return _hash32(seed_u32 ^ _mul32(torch.as_tensor(b, dtype=torch.int64),
                                     _K_B)
                   ^ _mul32(torch.as_tensor(h, dtype=torch.int64), _K_H))


def _keep_tile(salt, rows, cols, rate):
    """Boolean keep-mask [len(rows), len(cols)] from absolute positions
    (rows are folded rows: (h % G) * Lq + row)."""
    r = _mul32(rows.to(torch.int64)[:, None], _K_ROW)
    c = _mul32(cols.to(torch.int64)[None, :], _K_COL)
    return _hash32(r ^ c ^ salt) >= _rate_thresh(rate)


def _keep_mask(seed, B, Hq, Hkv, Lq, k0, k1, rate, device):
    """[B, Hq, Lq, k1 - k0] keep-mask of key columns [k0, k1): the kernel
    coordinates (b, h_kv, folded row (h % G) * Lq + row, column), with
    the row folded over the real Lq as `mha_reference` folds it."""
    G = Hq // Hkv
    i64 = dict(dtype=torch.int64, device=device)
    b = torch.arange(B, **i64)[:, None, None, None]
    h = torch.arange(Hq, **i64)[None, :, None, None]
    rows = torch.arange(Lq, **i64)[None, None, :, None]
    cols = torch.arange(k0, k1, **i64)[None, None, None, :]
    salt = _hash32(_seed_u32(seed) ^ _mul32(b, _K_B) ^ _mul32(h // G, _K_H))
    frow = (h % G) * Lq + rows
    return _hash32(_mul32(frow, _K_ROW) ^ _mul32(cols, _K_COL) ^ salt) \
        >= _rate_thresh(rate)


def _keep_scale(rate):
    """f32 1 / (1 - rate): the factor a kept probability is scaled by."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def _next_seed(generator=None):
    """Per-call dropout seed in [0, 2^24) from a CPU generator (the
    counterpart of the JAX `_next_seed`); None draws from torch's default
    CPU generator."""
    return int(torch.randint(0, 1 << 24, (), generator=generator))


# ---------------------------------------------------------------- masks

def _normalize_mask(attn_mask, B, Hq, Lq, Lk, dtype_neg=_NEG):
    """Split a mask broadcastable to [B, Hq, Lq, Lk] into (kvb [Bm, Lk],
    None) or (None, fb [Bm, Hm, Lq, Lk]) f32 additive biases, Bm in
    {1, B}, Hm in {1, Hq} (the JAX `_normalize_mask`; bool masks: True
    keeps, False becomes -1e30; a mask of fewer than 4 dims is read from
    the right, so a 2-D [B, L] mask is [1, 1, B, L])."""
    m = attn_mask
    if m.dtype == torch.bool:
        m = torch.where(m, 0.0, dtype_neg).float()
    else:
        m = m.float()
    while m.dim() < 4:
        m = m[None]
    Bm, Hm, Lqm, Lkm = m.shape
    if Bm not in (1, B) or Hm not in (1, Hq) or Lqm not in (1, Lq) or \
            Lkm not in (1, Lk):
        raise ValueError(f"attn_mask of shape {tuple(attn_mask.shape)} does "
                         f"not broadcast to [B, H, Lq, Lk] = "
                         f"{[B, Hq, Lq, Lk]}")
    if Lkm == 1:
        m = m.expand(Bm, Hm, Lqm, Lk)
    if Hm == 1 and Lqm == 1:
        return m.reshape(Bm, Lk).contiguous(), None
    if Lqm == 1:
        m = m.expand(Bm, Hm, Lq, Lk)
    return None, m.contiguous()


def mha_reference(q, k, v, causal=False, scale=None, attn_mask=None,
                  dropout_rate=0.0, dropout_seed=0):
    """Plain attention with an f32 softmax, [B, L, H, D] in and out; GQA
    by repeating K/V heads; an additive attn_mask broadcastable to
    [B, H, Lq, Lk] (bool: True keeps); hash dropout with the kernels'
    pattern (same seed, same mask); probabilities cast to q's dtype
    before P.V (the JAX `mha_reference`)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = (qh @ kh.transpose(-1, -2)).float() * scale
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, _NEG)
        else:
            logits = logits + attn_mask.float()
    if causal:
        Lq, Lk = logits.shape[-2:]
        keep = torch.ones((Lq, Lk), dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(keep, logits, _NEG)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate:
        B, H, Lq, Lk = probs.shape
        keep = _keep_mask(dropout_seed, B, H, hkv, Lq, 0, Lk, dropout_rate,
                          q.device)
        probs = probs * keep.float() / (1.0 - dropout_rate)
    return (probs.to(q.dtype) @ vh).transpose(1, 2)


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


class _Extras:
    """The optional operands of one attention call: kvb [Bm, Lk] or fb
    [Bm, Hm, Lq, Lk] (f32 additive biases) and the dropout rate and
    seed."""

    def __init__(self, kvb=None, fb=None, rate=0.0, seed=0):
        self.kvb, self.fb = kvb, fb
        self.rate, self.seed = float(rate or 0.0), int(seed)

    @property
    def branch(self):
        """The kernels' template branch: "none", "kvb" or "fb", then
        "+dropout"."""
        bias = ("kvb" if self.kvb is not None else
                "fb" if self.fb is not None else "none")
        return bias + ("+dropout" if self.rate else "")

    def bias(self, k0, k1):
        """The additive bias of key columns [k0, k1), broadcastable to
        [B, H, Lq, k1 - k0] (None: no bias)."""
        out = None
        if self.kvb is not None:
            out = self.kvb[:, None, None, k0:k1]
        if self.fb is not None:
            f = self.fb[..., k0:k1]
            out = f if out is None else out + f
        return out

    def drop(self, q, k, k0, k1):
        """The f32 dropout factor of key columns [k0, k1): keep / (1 -
        rate), [B, Hq, Lq, k1 - k0] (None: no dropout)."""
        if not self.rate:
            return None
        keep = _keep_mask(self.seed, q.shape[0], q.shape[2], k.shape[2],
                          q.shape[1], k0, k1, self.rate, q.device)
        return keep.float() * _keep_scale(self.rate)


_NONE = _Extras()


def _fwd_ref(q, k, v, causal, scale, ex=_NONE, f32_out=False):
    """Plain forward: (out [B, Lq, Hq, D] in q's dtype, or f32 with
    `f32_out`; lse f32 [B, Hq, Lq]). The denominator sums the undropped
    p; P.V takes the dropped p.

    f32 q/k/v: the TPU kernel's arithmetic, s = (q*scale).k in f32, over
    key tiles of `_BLOCK`. bf16 q/k/v: the tensor-core kernel's rounding
    points, over its key tiles of `_TC_BLOCK` (the rounded p depends on
    the running max, so the walk must cut the keys where the kernel
    does): (1) s = (q.k)*scale, the product of the stored bf16 values
    (exact in f32) scaled after the dot, as the backward recomputes it
    and as `mha_reference` scales; (2) p_use (p, or p * keep / (1 -
    rate)) rounded to bf16 before P.V, whose sum stays in f32; l sums
    the unrounded, undropped f32 p. Bias, mask, the forced zeros and the
    1e-30 floor are the same on both routes."""
    tc = q.dtype == torch.bfloat16
    tile = _TC_BLOCK if tc else _BLOCK
    qh, kh, vh = _heads(q, k, v)
    if not tc:
        qh = qh * scale
    B, H, Lq, D = qh.shape
    Lk = kh.shape[2]
    m = torch.full((B, H, Lq, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Lk, tile):
        k1 = min(k0 + tile, Lk)
        s = qh @ kh[:, :, k0:k1].transpose(-1, -2)
        if tc:
            s = s * scale
        bias = ex.bias(k0, k1)
        if bias is not None:
            s = s + bias
        keep = _tile_mask(Lq, k0, k1, causal, q.device)
        if keep is not None:
            s = torch.where(keep, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        if keep is not None:
            p = torch.where(keep, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        drop = ex.drop(q, k, k0, k1)
        if drop is not None:
            p = p * drop
        if tc:
            p = p.to(torch.bfloat16).float()
        acc = acc * corr + p @ vh[:, :, k0:k1]
        m = m_new
    lsafe = l.clamp_min(_DENOM_EPS)
    out = (acc / lsafe).transpose(1, 2)
    lse = (m + torch.log(lsafe))[..., 0]
    return (out if f32_out else out.to(q.dtype)), lse


def _bwd_ref(q, k, v, dout, lse, delta, causal, scale, ex=_NONE):
    """Plain backward from the saved lse and delta ([B, Hq, Lq] f32):
    (dq, dk, dv) in the dtypes of q, k, v. dS takes the undropped p and
    the dropped dP; dV the dropped p."""
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
        bias = ex.bias(k0, k1)
        if bias is not None:
            s = s + bias
        keep = _tile_mask(Lq, k0, k1, causal, q.device)
        if keep is not None:
            s = torch.where(keep, s, _NEG)
        p = torch.exp(s - lse_)
        dp = doh @ vt.transpose(-1, -2)
        p_drop = p
        drop = ex.drop(q, k, k0, k1)
        if drop is not None:
            p_drop = p * drop
            dp = dp * drop
        ds = p * (dp - delta_) * scale
        dq += ds @ kt
        dkh[:, :, k0:k1] = ds.transpose(-1, -2) @ qh
        dvh[:, :, k0:k1] = p_drop.transpose(-1, -2) @ doh
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
        # B Lq Lk Hq Hkv D causal kvb_b fb_b fb_h, scale, seed thresh,
        # keep_scale, dtype device, stream
        tail = ([ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_uint32,
                                       ctypes.c_uint32, ctypes.c_float,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p])
        lib.flash_fwd.argtypes = ([ctypes.c_void_p] * 7
                                  + [ctypes.POINTER(ctypes.c_int)] + tail)
        lib.flash_bwd_dq.argtypes = [ctypes.c_void_p] * 9 + tail
        lib.flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 10 + tail
        lib.flash_dropout_keep.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 5
            + [ctypes.c_uint32] * 2 + [ctypes.c_int, ctypes.c_void_p])
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv,
                   lib.flash_dropout_keep):
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


def _check_extras(ex, dims, device):
    """The biases' shapes, dtype, device and contiguity; the rate's
    range."""
    B, Lq, Lk, Hq, _, _ = dims
    for t, ok in ((ex.kvb, lambda s: len(s) == 2 and s[0] in (1, B)
                   and s[1] == Lk),
                  (ex.fb, lambda s: len(s) == 4 and s[0] in (1, B)
                   and s[1] in (1, Hq) and s[2:] == (Lq, Lk))):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != device or \
                not t.is_contiguous() or not ok(tuple(t.shape)):
            raise ValueError(
                f"flash_attention: bias {tuple(t.shape)} {t.dtype} on "
                f"{t.device} must be contiguous f32 on {device}, kvb "
                f"[1|B, Lk] or fb [1|B, 1|Hq, Lq, Lk] for {dims}")
    if ex.kvb is not None and ex.fb is not None:
        raise ValueError("flash_attention: one bias, kvb or fb, not both")
    if not 0.0 <= ex.rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {ex.rate}")


def _raise_on(rc, name, lib, ex, route=0):
    """Raise on a failed launch; else count it, by kernel and by body and
    template branch ("flash_fwd[tc,kvb+dropout]": `route` 1 is the
    tensor-core forward, 0 a SIMT body)."""
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.flash_error_string(rc).decode()} ({rc})")
    kernel_launches[name] += 1
    key = f"{name}[{'tc' if route else 'simt'},{ex.branch}]"
    branch_launches[key] = branch_launches.get(key, 0) + 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _head(ex):
    return (_ptr(ex.kvb), _ptr(ex.fb))


def _tail(dims, causal, scale, q, ex=_NONE):
    kvb_b = int(ex.kvb is not None and ex.kvb.shape[0] > 1)
    fb_b = int(ex.fb is not None and ex.fb.shape[0] > 1)
    fb_h = int(ex.fb is not None and ex.fb.shape[1] > 1)
    thresh = _rate_thresh(ex.rate) if ex.rate else 0
    keep_scale = _keep_scale(ex.rate) if ex.rate else 1.0
    return (*dims, int(bool(causal)), kvb_b, fb_b, fb_h, float(scale),
            _seed_u32(ex.seed) if ex.rate else 0, thresh, keep_scale,
            _CODES[q.dtype], q.device.index or 0,
            torch.cuda.current_stream(q.device).cuda_stream)


def _fwd(q, k, v, causal, scale, ex=_NONE):
    """(out, lse): the kernel on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        plain_launches["flash_fwd"] += 1
        return _fwd_ref(q, k, v, causal, scale, ex)
    dims = _check(q, k, v)
    _check_extras(ex, dims, q.device)
    B, Lq, _, Hq, _, _ = dims
    if q.dtype == torch.bfloat16:
        # the tensor-core body copies 16-byte rows: a view at a storage
        # offset off that alignment is copied to a fresh buffer first
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    route = ctypes.c_int(-1)
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), *_head(ex),
                       out.data_ptr(), lse.data_ptr(), ctypes.byref(route),
                       *_tail(dims, causal, scale, q, ex))
    _raise_on(rc, "flash_fwd", lib, ex, route.value)
    return out, lse


def _bwd(q, k, v, out, lse, dout, causal, scale, ex=_NONE):
    """(dq, dk, dv) from the saved out and lse."""
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if q.device.type == "cpu":
        plain_launches["flash_bwd_dq"] += 1
        plain_launches["flash_bwd_dkv"] += 1
        return _bwd_ref(q, k, v, dout, lse, delta, causal, scale, ex)
    dims = _check(q, k, v, dout, lse, delta)
    _check_extras(ex, dims, q.device)
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
    tail = _tail(dims, causal, scale, q, ex)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), *_head(ex))
    _raise_on(lib.flash_bwd_dq(*ins, dq.data_ptr(), *tail),
              "flash_bwd_dq", lib, ex)
    _raise_on(lib.flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *tail),
              "flash_bwd_dkv", lib, ex)
    return dq, dk, dv


def dropout_keep_on_card(seed, B, Hq, Hkv, Lq, Lk, rate, device):
    """The keep-mask [B, Hq, Lq, Lk] (uint8) as the kernels' own device
    hash function computes it, for holding it against `_keep_mask`. A
    check, not a step of the attention: it is not counted."""
    keep = torch.empty((B, Hq, Lq, Lk), dtype=torch.uint8, device=device)
    lib = _kernel_lib()
    rc = lib.flash_dropout_keep(keep.data_ptr(), B, Hq, Hkv, Lq, Lk,
                                _seed_u32(seed), _rate_thresh(rate),
                                device.index or 0,
                                torch.cuda.current_stream(device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_dropout_keep launch failed: "
                           f"{lib.flash_error_string(rc).decode()} ({rc})")
    return keep


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kvb, fb, causal, scale, rate, seed):
        ex = _Extras(kvb, fb, rate, seed)
        out, lse = _fwd(q, k, v, causal, scale, ex)
        ctx.save_for_backward(q, k, v, out, lse, kvb, fb)
        ctx.causal, ctx.scale, ctx.rate, ctx.seed = causal, scale, rate, seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kvb, fb = ctx.saved_tensors
        ex = _Extras(kvb, fb, ctx.rate, ctx.seed)
        dq, dk, dv = _bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal,
                          ctx.scale, ex)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(query, key, value, causal=False, scale=None,
                    attn_mask=None, dropout_rate=0.0, dropout_seed=None):
    """Fused attention, [B, L, H, D] in and out, with GQA (key/value with
    fewer heads), an additive or boolean `attn_mask` broadcastable to
    [B, Hq, Lq, Lk], and dropout on the attention probabilities at
    `dropout_rate`. `dropout_seed=None` draws one in [0, 2^24) from
    torch's default CPU generator."""
    B, Lq, Hq, _ = query.shape
    Lk, Hkv = key.shape[1], key.shape[2]
    if Hq % Hkv:
        raise ValueError(f"query heads ({Hq}) must be a multiple of "
                         f"key/value heads ({Hkv})")
    rate = float(dropout_rate or 0.0)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    seed = 0
    if rate:
        seed = (dropout_seed if dropout_seed is not None
                else _next_seed())
    kvb = fb = None
    if attn_mask is not None:
        kvb, fb = _normalize_mask(attn_mask.to(query.device), B, Hq, Lq, Lk)
    sc = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    return _FlashAttention.apply(query.contiguous(), key.contiguous(),
                                 value.contiguous(), kvb, fb, bool(causal),
                                 float(sc), rate, int(seed))
