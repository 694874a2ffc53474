"""Reference routes that the port's CPU tests and chip_smoke.py hold
its kernels against, kept in one place so the two cannot drift apart.
Nothing on the port's main path imports this module.

- `bs_tc_walk`: the block-sparse tensor-core body's rounding points
  (`csrc/block_sparse_attention.cu`, `bsa_fwd_tc_kernel`) in plain torch;
  with `p_split=False`, the control that rounds p to bf16 alone.
- `PerTensorAdamW`: the port's `AdamW` with its update made one
  `adamw_update_` a parameter (one launch each on the card), the route
  the multi-tensor update replaced.
"""
import torch

from .ops import block_sparse_attention as bsa
from .ops import fused_ops as X
from .optimizer import AdamW

__all__ = ["bs_tc_walk", "PerTensorAdamW"]


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


class PerTensorAdamW(AdamW):
    """`AdamW` with `apply_gradients` making one `adamw_update_` a
    parameter, in the list's order, from the same clip scale and bias
    corrections as the multi-tensor route."""

    @torch.no_grad()
    def apply_gradients(self, params, grads, lr=None):
        lr = self.get_lr() if lr is None else float(lr)
        self._step_count += 1
        params, grads = list(params), list(grads)
        scale = (self._grad_clip.scale(grads)
                 if self._grad_clip is not None and grads else None)
        bc1, bc2 = self._bias_corrections(self._step_count)
        for p, g in zip(params, grads):
            slots = self._slots(p)
            X.adamw_update_(p, g, slots["moment1"], slots["moment2"], lr,
                            self._beta1, self._beta2, self._epsilon,
                            self._wd, bc1, bc2, master=slots.get("master"),
                            scale=scale)
