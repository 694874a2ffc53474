"""Fused ops (counterpart of `paddle_tpu/ops/fused_ops.py`): softmax
cross-entropy, the AdamW update, and dropout + residual + LayerNorm.

`fused_softmax_cross_entropy(logits, labels)` gives the per-row loss
`lse - logits[label]` (f32) of logits [N, V]; it is a
`torch.autograd.Function` whose backward is `dx = (exp(x - lse) -
onehot) * g` in the logits' dtype. Forward and backward are the
hand-written CUDA kernels `csrc/softmax_cross_entropy.cu` (the JAX
`_xent_fwd_kernel` / `_xent_bwd_kernel`); `_xent_fwd_ref` /
`_xent_bwd_ref` are their plain versions, which walk the vocab in the
same 128-multiple blocks with a running max, sum and picked logit.

`can_fuse_xent` is the JAX shape rule without its backend test: rows a
multiple of 256 and a vocab with a 128-multiple block divisor.

`adamw_update_` is one AdamW update of one tensor, in place, by the CUDA
kernel `csrc/adamw.cu` (the JAX `_adamw_kernel`), optionally through an
f32 master copy and with a device clip scale; `_adamw_kernel_ref` is its
plain version. `fused_adamw` is the JAX op's signature on top of it: it
returns new tensors. `fused_dropout_residual_layer_norm` is
LN(dropout(x) + residual) and the pre-LN sum, by the dropout + residual
mode of the norms' row walk in `csrc/layer_norm.cu` (the JAX
`_dropout_res_ln_kernel`), with `_dropout_res_ln_kernel_ref` as its plain
version.

A wrapper takes the plain version only for tensors on the CPU; on CUDA
tensors it launches the kernel or raises. `kernel_launches` /
`plain_launches` count each cross-entropy kernel and its plain version
(by name); `adamw_kernel_launches` / `adamw_plain_launches` and
`drln_kernel_launches` / `drln_plain_launches` count the AdamW and the
dropout + residual + LayerNorm kernels apart.
"""
import ctypes

import numpy as np
import torch

from . import _build
from .dropout import _apply_keep, _hash_bits
from .layer_norm import _aligned, _kernel_lib as _norm_lib

__all__ = ["can_fuse_xent", "fused_softmax_cross_entropy", "adamw_update_",
           "adamw_update_multi", "adamw_capacity", "fused_adamw", "fused_dropout_residual_layer_norm",
           "kernel_launches", "plain_launches", "adamw_kernel_launches",
           "adamw_plain_launches", "drln_kernel_launches",
           "drln_plain_launches", "reset_counts"]

KERNELS = ("xent_fwd", "xent_bwd")
kernel_launches = dict.fromkeys(KERNELS, 0)
plain_launches = dict.fromkeys(KERNELS, 0)
adamw_kernel_launches = adamw_plain_launches = 0
drln_kernel_launches = drln_plain_launches = 0


def reset_counts():
    global adamw_kernel_launches, adamw_plain_launches
    global drln_kernel_launches, drln_plain_launches
    for name in KERNELS:
        kernel_launches[name] = 0
        plain_launches[name] = 0
    adamw_kernel_launches = adamw_plain_launches = 0
    drln_kernel_launches = drln_plain_launches = 0


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


# ---------------------------------------------------------------- AdamW

def _adamw_kernel_ref(p, g, m, v, lr, beta1, beta2, eps, weight_decay, bc1,
                      bc2, scale=None):
    """Plain version of the AdamW kernel: (p', m', v') in f32 from p
    (the parameter, or its f32 master), g, m and v of any float dtype.
    With a clip `scale` (an f32 0-d tensor) the gradient is first scaled
    in f32 and rounded to its own dtype, as the global-norm clip does.
    The same operations, one at a time, as the kernel."""
    pv, gv = p.float(), g.float()
    if scale is not None:
        gv = (gv * scale).to(g.dtype).float()
    m_new = beta1 * m.float() + (1 - beta1) * gv
    v_new = beta2 * v.float() + (1 - beta2) * gv * gv
    p_new = pv - lr * ((m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                       + weight_decay * pv)
    return p_new, m_new, v_new


_adamw_lib = None


def _adamw_kernel_lib():
    global _adamw_lib
    if _adamw_lib is None:
        lib = _build.load("adamw")
        lib.adamw_update_multi.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_float] * 9 + [ctypes.c_int] * 5
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        lib.adamw_update_multi.restype = ctypes.c_int
        lib.adamw_capacity.argtypes = []
        lib.adamw_capacity.restype = ctypes.c_int
        lib.adamw_error_string.argtypes = [ctypes.c_int]
        lib.adamw_error_string.restype = ctypes.c_char_p
        _adamw_lib = lib
    return _adamw_lib


def adamw_capacity():
    """The most tensors one launch of the multi-tensor kernel takes (the
    kernel-parameter space of the toolkit it was built with)."""
    return _adamw_kernel_lib().adamw_capacity()


def _adamw_group_key(p, g, m, master):
    """The kernel's template arguments: (p, g, slot dtypes, master)."""
    return p.dtype, g.dtype, m.dtype, master is not None


def _adamw_check(p, g, m, v, master):
    for t in (g, m, v, master):
        if t is not None and t.device != p.device:
            raise ValueError(f"adamw: operands on {t.device} and {p.device}")
    for t in (p, g, m, v, master):
        if t is not None and not t.is_contiguous():
            raise ValueError("adamw: operands must be contiguous")
    n = p.numel()
    if g.numel() != n or m.numel() != n or v.numel() != n or (
            master is not None and master.numel() != n):
        raise ValueError("adamw: p, g, m, v (and master) must have one size")
    if p.dtype not in _CODES or g.dtype not in _CODES or \
            m.dtype not in _CODES or v.dtype != m.dtype:
        raise TypeError(f"adamw kernel takes float32/bfloat16 p, g and "
                        f"slots (m and v of one dtype), got {p.dtype}, "
                        f"{g.dtype}, {m.dtype}/{v.dtype}")
    if master is not None and master.dtype != torch.float32:
        raise TypeError("adamw: the master copy must be float32")


def _adamw_launch_multi(group, scale, hyper):
    """One update of every (p, g, m, v, master) of `group`, all of one
    `_adamw_group_key`, by the multi-tensor kernel: one launch for up to
    `adamw_capacity()` tensors. Returns the launches made."""
    global adamw_kernel_launches
    p0, g0, m0, _, ma0 = group[0]
    key = _adamw_group_key(p0, g0, m0, ma0)
    for p, g, m, v, master in group:
        _adamw_check(p, g, m, v, master)
        if p.device != p0.device or \
                _adamw_group_key(p, g, m, master) != key:
            raise ValueError("adamw: a group's tensors must share their "
                             "device, dtypes and master copy")
    if scale is not None and (scale.device != p0.device or
                              scale.dtype != torch.float32 or
                              scale.numel() != 1):
        raise TypeError("adamw: the clip scale must be one float32 value "
                        "on the tensors' device")
    live = [e for e in group if e[0].numel()]
    if not live:
        return 0
    ptrs = (ctypes.c_void_p * (5 * len(live)))(*[
        None if t is None else t.data_ptr() for e in live for t in e])
    numels = (ctypes.c_longlong * len(live))(*[e[0].numel() for e in live])
    lib = _adamw_kernel_lib()
    lr, b1, b2, eps, wd, bc1, bc2 = hyper
    launches = ctypes.c_int(0)
    rc = lib.adamw_update_multi(
        ptrs, numels, len(live), None if scale is None else scale.data_ptr(),
        lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, bc1, bc2,
        _CODES[p0.dtype], _CODES[g0.dtype], _CODES[m0.dtype],
        int(ma0 is not None), *_stream(p0), ctypes.byref(launches))
    adamw_kernel_launches += launches.value
    if rc:
        raise RuntimeError("adamw kernel launch failed: "
                           f"{lib.adamw_error_string(rc).decode()} ({rc})")
    return launches.value


def _adamw_launch(p, g, m, v, master, scale, hyper):
    """One tensor's update: the multi-tensor kernel over a list of one."""
    return _adamw_launch_multi([(p, g, m, v, master)], scale, hyper)


def _adamw_plain(p, g, m, v, master, scale, hyper):
    """The plain version of one tensor's update, written in place."""
    global adamw_plain_launches
    adamw_plain_launches += 1
    p_new, m_new, v_new = _adamw_kernel_ref(
        p if master is None else master, g, m, v, *hyper, scale=scale)
    if master is not None:
        master.copy_(p_new)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)


def _hyper(lr, beta1, beta2, eps, weight_decay, bc1, bc2):
    return (float(lr), float(beta1), float(beta2), float(eps),
            float(weight_decay), float(bc1), float(bc2))


@torch.no_grad()
def adamw_update_(p, g, m, v, lr, beta1, beta2, eps, weight_decay, bc1, bc2,
                  master=None, scale=None):
    """One AdamW update in place: p, m and v (and the f32 `master`, whose
    update p then takes, rounded) are overwritten. `bc1`/`bc2` are the
    bias corrections 1 - beta^step, `scale` an optional f32 0-d clip
    factor on the card (read there, never fetched)."""
    hyper = _hyper(lr, beta1, beta2, eps, weight_decay, bc1, bc2)
    if p.device.type == "cpu":
        _adamw_plain(p, g, m, v, master, scale, hyper)
        return
    _adamw_launch(p, g, m, v, master, scale, hyper)


@torch.no_grad()
def adamw_update_multi(params, grads, ms, vs, lr, beta1, beta2, eps,
                       weight_decay, bc1, bc2, masters=None, scale=None):
    """`adamw_update_` of every tensor of the lists, in place, which must
    share their device, dtypes (p, g, the slots) and whether they have
    an f32 master (`masters`: a list beside `params`, or None). On the
    card one launch of the multi-tensor kernel for up to
    `adamw_capacity()` tensors; on the CPU the plain version tensor by
    tensor. Every element gets the bits `adamw_update_` gives it."""
    masters = [None] * len(params) if masters is None else list(masters)
    group = list(zip(params, grads, ms, vs, masters))
    if not (len(group) == len(params) == len(grads) == len(ms) == len(vs)
            == len(masters)):
        raise ValueError("adamw_update_multi: lists of unequal length")
    if not group:
        return
    hyper = _hyper(lr, beta1, beta2, eps, weight_decay, bc1, bc2)
    if params[0].device.type == "cpu":
        for p, g, m, v, master in group:
            _adamw_plain(p, g, m, v, master, scale, hyper)
        return
    _adamw_launch_multi(group, scale, hyper)


def fused_adamw(p, g, m, v, step, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.01):
    """One fused AdamW update; returns new (p, m, v), each in its own
    dtype (the JAX op). `step` is the 1-based step of the bias
    corrections, formed in Python double as the JAX op forms them."""
    p2, m2, v2 = (t.detach().clone().contiguous() for t in (p, m, v))
    adamw_update_(p2, g.detach().contiguous(), m2, v2, lr, beta1, beta2,
                  eps, weight_decay, 1.0 - beta1 ** step,
                  1.0 - beta2 ** step)
    return p2, m2, v2


# ------------------------------------- dropout + residual + LayerNorm

def _keep_thresh(p):
    """The JAX kernel's keep threshold: keep iff bits <= int((1 - p) *
    (2^32 - 1))."""
    return int((1.0 - p) * (2 ** 32 - 1))


def _bits_or_hash(bits, seed, shape, device):
    if bits is not None:
        return bits.to(torch.int64) & 0xFFFFFFFF
    return _hash_bits(seed, shape, device)


def _dropout_res_ln_kernel_ref(x, residual, weight, bias, p, eps, seed=0,
                               bits=None):
    """Plain version of the kernel: (out, h) in x's dtype, h = the masked
    x / f32(1 - p) plus the residual and the LayerNorm over it, all in
    f32 (mean, then mean((h - mean)^2)). `bits` (uint32 or int [n, h])
    are the mask's bits; without them the kernel's hash of `seed`."""
    xv = x.float()
    if p > 0:
        keep = _bits_or_hash(bits, seed, x.shape, x.device) <= \
            _keep_thresh(p)
        # a divisor tensor, as the kernel divides (a Python number would
        # be a multiply by its reciprocal on the card)
        div = torch.full((), np.float32(1.0 - p), device=x.device)
        xv = torch.where(keep, xv / div, 0.0)
    hv = xv + residual.float()
    mean = hv.mean(-1, keepdim=True)
    var = (hv - mean).square().mean(-1, keepdim=True)
    out = (hv - mean) * torch.rsqrt(var + eps) * weight.float() \
        + bias.float()
    return out.to(x.dtype), hv.to(x.dtype)


def _dropout_res_ln_ref(x, residual, weight, bias, p, eps, seed=0,
                        bits=None):
    """The JAX `_dropout_res_ln_ref`'s arithmetic (widths off the 128
    grid): dropout and the sum in x's dtype (a kept x is c(f32(x) /
    f32(c(1 - p))), c() a cast to x's dtype, as F.dropout), the LayerNorm
    in f32. Its mask is the kernel's (host bits or the hash): the JAX ref
    draws a threefry bernoulli that the port does not reproduce."""
    if p > 0:
        keep = _bits_or_hash(bits, seed, x.shape, x.device) <= \
            _keep_thresh(p)
        x = _apply_keep(x, keep, p, True)
    hv = x + residual
    h32 = hv.float()
    mean = h32.mean(-1, keepdim=True)
    var = (h32 - mean).square().mean(-1, keepdim=True)
    out = (h32 - mean) * torch.rsqrt(var + eps) * weight.float() \
        + bias.float()
    return out.to(x.dtype), hv


def _drln_launch(x, residual, weight, bias, p, eps, seed, bits):
    global drln_kernel_launches
    n, h = x.shape
    for t in (x, residual, weight, bias) + ((bits,) if bits is not None
                                            else ()):
        if t.device != x.device:
            raise ValueError(f"dropout_residual_layer_norm: operands on "
                             f"{t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("dropout_residual_layer_norm: operands must "
                             "be contiguous")
    if x.dtype not in _CODES or residual.dtype != x.dtype or \
            weight.dtype not in _CODES or bias.dtype != weight.dtype:
        raise TypeError(f"dropout_residual_layer_norm kernel takes "
                        f"float32/bfloat16 x and residual of one dtype and "
                        f"w/b of one such dtype, got {x.dtype}, "
                        f"{residual.dtype}, {weight.dtype}/{bias.dtype}")
    if residual.shape != x.shape or weight.shape != (h,) or \
            bias.shape != (h,):
        raise ValueError("dropout_residual_layer_norm: residual [n, h] and "
                         "w/b [h] must match x")
    if bits is not None and (bits.dtype not in (torch.int32, torch.uint32)
                             or bits.shape != x.shape):
        raise TypeError("dropout_residual_layer_norm: host bits must be "
                        "32-bit integers shaped like x")
    if h > 8192:
        raise ValueError(f"dropout_residual_layer_norm kernel takes width "
                         f"<= 8192, got {h}")
    x, residual, weight, bias = (_aligned(t) for t in
                                 (x, residual, weight, bias))
    bits = None if bits is None else _aligned(bits)
    out, hv = torch.empty_like(x), torch.empty_like(x)
    lib = _norm_lib()
    rc = lib.dropout_res_ln_forward(
        x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), None if bits is None else bits.data_ptr(),
        out.data_ptr(), hv.data_ptr(), n, h, float(eps), float(p),
        int(seed) % (1 << 31), _CODES[x.dtype], _CODES[weight.dtype],
        *_stream(x))
    if rc:
        raise RuntimeError(
            "dropout_residual_layer_norm kernel launch failed: "
            f"{lib.layer_norm_error_string(rc).decode()} ({rc})")
    drln_kernel_launches += 1
    return out, hv


class _FusedDropoutResidualLayerNorm(torch.autograd.Function):
    """No backward: the JAX op has none through its kernel either
    (`jax.grad` of it abandons the Pallas call and differentiates the
    threefry-masked reference instead)."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, p, eps, seed, bits):
        global drln_plain_launches
        if x.shape[1] % 128:
            drln_plain_launches += 1
            return _dropout_res_ln_ref(x, residual, weight, bias, p, eps,
                                       seed, bits)
        if x.device.type == "cpu":
            drln_plain_launches += 1
            return _dropout_res_ln_kernel_ref(x, residual, weight, bias, p,
                                              eps, seed, bits)
        return _drln_launch(x, residual, weight, bias, p, eps, seed, bits)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "fused_dropout_residual_layer_norm has no backward: the JAX op "
            "has no gradient through its kernel")


def fused_dropout_residual_layer_norm(x, residual, weight=None, bias=None,
                                      p=0.1, eps=1e-5, seed=0,
                                      training=True, *, _host_bits=None):
    """(LN(dropout(x) + residual), dropout(x) + residual) over the last
    axis of 2-D x and residual [n, h], both in x's dtype (the JAX op).
    Weight and bias default to ones and zeros; `p` counts only in
    training. The mask keeps an element iff its 32 bits are <= int((1 -
    p) * (2^32 - 1)); the bits are the counter hash of the flat index
    and `seed` (see `csrc/layer_norm.cu`). `_host_bits`
    (uint32/int32 [n, h]) replaces them: the JAX interpret-mode
    contract, for parity tests."""
    if x.dim() != 2:
        raise ValueError(f"fused_dropout_residual_layer_norm takes 2-D "
                         f"(rows, hidden) input, got {tuple(x.shape)}")
    h = x.shape[1]
    w = weight if weight is not None else torch.ones(h, dtype=x.dtype,
                                                     device=x.device)
    b = bias if bias is not None else torch.zeros(h, dtype=x.dtype,
                                                  device=x.device)
    rate = float(p) if training else 0.0
    bits = None if _host_bits is None or rate == 0 else \
        _host_bits.contiguous()
    return _FusedDropoutResidualLayerNorm.apply(
        x.contiguous(), residual.contiguous(), w.contiguous(),
        b.contiguous(), rate, float(eps), int(seed), bits)
