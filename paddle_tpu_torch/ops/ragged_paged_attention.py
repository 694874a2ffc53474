"""Ragged paged attention: one causal attention primitive for mixed
chunked-prefill + decode batches over the paged KV pool (counterpart of
`paddle_tpu/ops/ragged_paged_attention.py`, f32/bf16 pools).

Query j of row i sits at absolute position ``start[i] + j`` and attends
causally (kpos <= qpos) over the row's own pages, so a token's output
does not depend on the window width, the batch composition, or whether
it was computed as a decode tick, inside a prefill chunk or inside the
packed token stream — the schedule independence the serving engine's
byte-identical stream guarantees ride on.

Shapes:
  q               : (n, W, H, D) dense windows, or (T, H, D) packed
  k_pages/v_pages : (P, page_size, H, D) one layer's page pool
  page_table      : (n, max_pages) int32 page ids per row
  start           : (n,) already-cached length per row (dense)
  row_ids, pos    : (T,) each packed token's table row and position

Two implementations of the same math:
  * `_ragged_ref`, the plain PyTorch version: the JAX reference's
    per-page online softmax (`_page_update`), with its -1e30 mask and
    1e-30 denominator floor, in f32;
  * the hand-written CUDA kernel `csrc/ragged_paged_attention.cu`.
A wrapper takes the plain version only for tensors on the CPU. On CUDA
tensors it launches the kernel or raises — there is no fallback.
`kernel_launches` / `plain_launches` count the calls of each.
"""
import ctypes
import math

import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_packed",
           "kernel_launches", "plain_launches", "reset_counts"]

_DENOM_EPS = 1e-30
_MASK = -1e30

# launches of the CUDA kernel and calls of the plain version
kernel_launches = 0
plain_launches = 0


def reset_counts():
    global kernel_launches, plain_launches
    kernel_launches = 0
    plain_launches = 0


def _page_update(m, s, acc, logits, v, kpos, qpos):
    """ONE page's online-softmax update (the JAX `_page_update`).
    m/s/acc: running max [..., W, 1], denominator [..., W, 1], value
    accumulator [..., W, D]; logits [..., W, ps] this page's scores;
    v [..., ps, D]; kpos [ps] the page's key positions; qpos [..., W]."""
    mask = kpos[..., None, :] <= qpos[..., :, None]       # [..., W, ps]
    logits = torch.where(mask, logits, _MASK)
    m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
    p = torch.exp(logits - m_new)
    corr = torch.exp(m - m_new)
    s_new = s * corr + p.sum(-1, keepdim=True)
    acc_new = acc * corr + p @ v
    return m_new, s_new, acc_new


def _ragged_ref(q, k_pages, v_pages, page_table, start, scale):
    """Plain version: the kernel's page walk as a loop over the table's
    pages, each through `_page_update`. q [n, W, H, D] -> [n, W, H, D]."""
    n, W, H, D = q.shape
    P, ps = k_pages.shape[:2]
    MP = page_table.shape[1]
    dev = q.device
    safe = page_table.long().clamp(0, P - 1)
    qf = (q.float() * scale).transpose(1, 2)                 # [n, H, W, D]
    qpos = (start.long()[:, None]
            + torch.arange(W, device=dev))[:, None, :]       # [n, 1, W]
    m = torch.full((n, H, W, 1), _MASK, dtype=torch.float32, device=dev)
    s = torch.zeros((n, H, W, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((n, H, W, D), dtype=torch.float32, device=dev)
    for j in range(MP):
        kj = k_pages[safe[:, j]].float().transpose(1, 2)     # [n, H, ps, D]
        vj = v_pages[safe[:, j]].float().transpose(1, 2)
        logits = qf @ kj.transpose(-1, -2)                   # [n, H, W, ps]
        kpos = j * ps + torch.arange(ps, device=dev)
        m, s, acc = _page_update(m, s, acc, logits, vj, kpos, qpos)
    out = acc / s.clamp_min(_DENOM_EPS)
    return out.transpose(1, 2).to(q.dtype)


_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("ragged_paged_attention")
        lib.rpa_forward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.rpa_forward.restype = ctypes.c_int
        lib.rpa_error_string.argtypes = [ctypes.c_int]
        lib.rpa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(q, k_pages, v_pages, page_table, row_of, start, scale):
    """Check the operands and launch the CUDA kernel on the current
    stream. q [N, W, H, D]; row_of [N] int32 or None (row n)."""
    global kernel_launches
    N, W, H, D = q.shape
    P, ps = k_pages.shape[:2]
    R, MP = page_table.shape
    ints = (page_table, start) + (() if row_of is None else (row_of,))
    for t in (q, k_pages, v_pages) + ints:
        if t.device != q.device:
            raise ValueError(
                f"ragged_paged_attention: operands on {t.device} and "
                f"{q.device}")
        if not t.is_contiguous():
            raise ValueError("ragged_paged_attention: operands must be "
                             "contiguous")
    if q.dtype not in _CODES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(
            f"ragged_paged_attention kernel takes float32 or bfloat16 q "
            f"and pools of q's dtype, got q {q.dtype}, pools "
            f"{k_pages.dtype}/{v_pages.dtype}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("ragged_paged_attention: page table, start/pos "
                        "and row ids must be int32")
    if tuple(k_pages.shape) != (P, ps, H, D) or \
            v_pages.shape != k_pages.shape:
        raise ValueError(
            f"pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not "
            f"match q heads {H} x head_dim {D}")
    if start.shape != (N,) or (row_of is not None and row_of.shape != (N,)):
        raise ValueError("start/pos and row ids must be [N] vectors")
    if D not in (32, 64, 128, 256) or not 1 <= ps <= 32:
        raise ValueError(f"kernel takes head_dim in 32/64/128/256 and "
                         f"page_size <= 32, got {D}, {ps}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _kernel_lib()
    rc = lib.rpa_forward(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(),
        None if row_of is None else row_of.data_ptr(),
        start.data_ptr(), out.data_ptr(), N, W, H, D, ps, MP, P, R,
        float(scale), _CODES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(
            "ragged_paged_attention kernel launch failed: "
            f"{lib.rpa_error_string(rc).decode()} ({rc})")
    kernel_launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, page_table, start,
                           scale=None):
    """Causal attention of ragged new-token windows over paged KV.
    q (n, W, H, D): row i's new tokens at positions start[i]..start[i]+
    W-1 (padded queries past a row's true length produce row-local
    garbage the caller discards). Decode rows are W=1. Returns
    (n, W, H, D) in q's dtype."""
    global plain_launches
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        plain_launches += 1
        return _ragged_ref(q, k_pages, v_pages, page_table, start, scale)
    return _launch(q, k_pages, v_pages, page_table, None, start, scale)


def ragged_paged_attention_packed(q, k_pages, v_pages, page_table,
                                  row_ids, pos, scale=None):
    """PACKED-layout causal attention: q [T, H, D] is a flat stream of
    new tokens; token t belongs to table row `row_ids[t]` (clamped into
    the table) and sits at absolute position `pos[t]`. Per-token math is
    the dense form's exactly, so a token's output is bit-identical to
    the dense form computing the same position in any window. Unlike
    the JAX wrapper, nothing pads the stream to a 2-wide window (that
    padding works around XLA-CPU rounding and changes no output).
    Returns [T, H, D]."""
    global plain_launches
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        plain_launches += 1
        rows = row_ids.long().clamp(0, page_table.shape[0] - 1)
        return _ragged_ref(q[:, None], k_pages, v_pages, page_table[rows],
                           pos, scale)[:, 0]
    return _launch(q[:, None], k_pages, v_pages, page_table, row_ids, pos,
                   scale)[:, 0]
