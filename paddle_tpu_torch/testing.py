"""Reference routes that the port's CPU tests and chip_smoke.py hold
its kernels against, kept in one place so the two cannot drift apart.
Nothing on the port's main path imports this module.

- `bs_tc_walk`: the block-sparse tensor-core body's rounding points
  (`csrc/block_sparse_attention.cu`, `bsa_fwd_tc_kernel`) in plain torch;
  with `p_split=False`, the control that rounds p to bf16 alone.
- `PerTensorAdamW`: the port's `AdamW` with its update made one
  `adamw_update_` a parameter (one launch each on the card), the route
  the multi-tensor update replaced.
- `check_ln_bwd`: LayerNorm's backward (`ops/layer_norm.py`) against its
  plain version; `ln_bwd_control`, the plain version with dw summed from
  f32 xhat (c(xhat) skipped), which the check rejects in bf16.
"""
import math

import torch

from .ops import block_sparse_attention as bsa
from .ops import fused_ops as X
from .ops import layer_norm as LN
from .optimizer import AdamW

__all__ = ["bs_tc_walk", "PerTensorAdamW", "check_ln_bwd", "ln_bwd_control",
           "LN_BWD_FLIP", "LN_BWD_SUM_TOL"]

# LayerNorm's backward against its plain version on the same x, g, w,
# mean and rstd. Every output is the plain version's f32 value (dx, or a
# column sum of dw's or db's terms) after one rounding, so a bf16 output
# whose f32 sum went in another order may land one step away, but seldom:
# only where the f32 value sits within the sums' rounding noise of a
# rounding boundary. So: every element within one step of its dtype of
# the plain f32 value (plus 1e-5 for dx, an output near zero being a sum
# that cancels, and LN_BWD_SUM_TOL of the sum of its terms' magnitudes for
# dw and db, f32 sums of up to a few thousand terms in another order), and
# in bf16 at most LN_BWD_FLIP of the elements (or 2) with bits other than
# the plain version's. A rounding point moved (a term rounded where the
# vjp of `_ln_ref` does not, or not rounded where it does) moves about a
# quarter of them.
LN_BWD_FLIP = 0.02
LN_BWD_SUM_TOL = 2.0 ** -16


def bs_tc_walk(q, k, v, block_cols, block_counts, block_size, scale,
                p_split=True):
    """The tensor-core body's rounding points in plain torch, f32 result
    (the caller casts): s = (q.k) * scale on the given values, one f32
    online-softmax step per key tile of min(bs, 64) keys, l summing the
    unrounded p, P.V = p_hi.V + p_lo.V (p_hi = bf16(p), p_lo = bf16(p -
    p_hi)), acc / max(l, 1e-30). `p_split=False` rounds p to bf16 alone
    before P.V (the flash forward's recipe): a control that the kernel's
    tolerance rejects."""
    B, H, L, D = q.shape
    bs = block_size
    kt = min(bs, bsa.TC_KEYS)
    nq = nk = L // bs
    cols, counts = bsa._row_layout(block_cols, block_counts, B, H, nk)
    cols = cols.expand(B, H, nq, cols.shape[-1])
    counts = counts.expand(B, H, nq)
    qb = q.float().reshape(B, H, nq, bs, D)
    kb = k.float().reshape(B, H, nk, bs // kt, kt, D)
    vb = v.float().reshape(B, H, nk, bs // kt, kt, D)
    dev = q.device
    m = torch.full((B, H, nq, bs, 1), bsa._NEG, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, H, nq, bs, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, nq, bs, D), dtype=torch.float32, device=dev)
    for j in range(cols.shape[-1]):
        idx = cols[..., j][..., None, None, None].expand(
            B, H, nq, bs // kt, kt, D)
        valid = (j < counts)[..., None, None]
        kg = torch.gather(kb, 2, idx)               # [B,H,nq,bs/kt,kt,D]
        vg = torch.gather(vb, 2, idx)
        for t in range(bs // kt):
            kj, vj = kg[:, :, :, t], vg[:, :, :, t]
            s = (qb @ kj.transpose(-1, -2)) * scale
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            hi = p.to(torch.bfloat16).float()
            pv = hi @ vj
            if p_split:
                pv = pv + (p - hi).to(torch.bfloat16).float() @ vj
            l = torch.where(valid, l * alpha + p.sum(-1, keepdim=True), l)
            acc = torch.where(valid, acc * alpha + pv, acc)
            m = torch.where(valid, m_new, m)
    out = acc / l.clamp_min(bsa._DENOM_EPS)
    return out.reshape(B, H, L, D)


def _step(x, dtype):
    """One step of `dtype` (bf16 or f32) at |x|, as f32."""
    mag = x.abs().float().clamp_min(2.0 ** -126)
    bits = 7 if dtype == torch.bfloat16 else 23
    return torch.exp2(torch.floor(torch.log2(mag)) - bits)


def ln_bwd_control(x, g, w, mean, rstd):
    """The backward's plain version with dw's terms taken from f32 xhat,
    c(g * xhat) in place of c(g * c(xhat)): a control, not a result."""
    dx, _, db = LN._ln_bwd_kernel_ref(x, g, w, mean, rstd)
    dt, h = x.dtype, x.shape[-1]
    xhat = ((x.float() - mean.reshape(*x.shape[:-1], 1))
            * rstd.reshape(*x.shape[:-1], 1))
    dw = (g.float() * xhat).to(dt).float().reshape(-1, h).sum(0)
    return dx, dw.to(dt).to(w.dtype), db


def check_ln_bwd(name, got, x, g, w, mean, rstd):
    """Holds got = (dx, dw, db) against the plain version on the same
    inputs (see LN_BWD_FLIP); raises AssertionError if it is off.
    Returns the largest absolute difference from the plain outputs and
    the share of bf16 elements whose bits differ from them."""
    plain = LN._ln_bwd_kernel_ref(x, g, w, mean, rstd)
    f32 = LN._ln_bwd_f32(x, g, w, mean, rstd)
    h, dt = x.shape[-1], x.dtype
    xhat = ((x.float() - mean.reshape(*x.shape[:-1], 1))
            * rstd.reshape(*x.shape[:-1], 1))
    mags = (None, (g * xhat.to(dt)).float().abs().reshape(-1, h).sum(0),
            g.float().abs().reshape(-1, h).sum(0))
    err, flips = 0.0, 0.0
    for what, o, p, v32, mag in zip(("dx", "dw", "db"), got, plain, f32,
                                    mags):
        rounding = (torch.bfloat16 if torch.bfloat16 in (dt, o.dtype)
                    else torch.float32)
        if o.dtype != p.dtype or o.shape != p.shape:
            raise AssertionError(f"{name} {what}: {o.dtype} "
                                 f"{tuple(o.shape)}, plain {p.dtype} "
                                 f"{tuple(p.shape)}")
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name} {what}: non-finite output")
        allow = _step(v32, rounding) + (1e-5 if mag is None
                                        else LN_BWD_SUM_TOL * mag)
        if rounding == torch.float32 and mag is None:
            allow = 1e-5 + 1e-5 * v32.abs()
        off = (o.float() - v32).abs()
        if not bool((off <= allow).all()):
            raise AssertionError(
                f"{name} {what}: {int((off > allow).sum())} elements beyond "
                f"one step of {rounding} of the plain f32 value")
        if rounding == torch.bfloat16:
            n_diff = int((o.float() != p.float()).sum())
            share = n_diff / o.numel()
            if n_diff > max(math.floor(LN_BWD_FLIP * o.numel()), 2):
                raise AssertionError(
                    f"{name} {what}: {share:.4f} of the elements differ from "
                    f"the plain version's bits (at most {LN_BWD_FLIP})")
            flips = max(flips, share)
        err = max(err, float((o.float() - p.float()).abs().max()))
    return err, flips


class PerTensorAdamW(AdamW):
    """`AdamW` whose update makes one `adamw_update_` a parameter, in
    the list's order, from the same clip scale and bias corrections as
    the multi-tensor route."""

    def _update(self, params, grads, lr, scale):
        bc1, bc2 = self._bias_corrections(self._step_count)
        for p, g in zip(params, grads):
            slots = self._slots(p)
            X.adamw_update_(p, g, slots["moment1"], slots["moment2"], lr,
                            self._beta1, self._beta2, self._epsilon,
                            self._wd, bc1, bc2, master=slots.get("master"),
                            scale=scale)
