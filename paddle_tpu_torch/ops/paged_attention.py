"""Paged KV cache + single-query paged decode attention (counterpart of
`paddle_tpu/ops/paged_attention.py`).

KV lives in fixed-size pages; each sequence owns a list of page ids
(its page table), handed out by the host from a free list. Decode-time
attention walks only that sequence's pages.

Shapes:
  k_pages/v_pages : (num_pages, page_size, H, D)  f32 or bf16
  page_table      : (B, max_pages) int32 page ids (-1 = unused)
  seq_lens        : (B,)           int32 current lengths
  q               : (B, 1, H, D)   one decode step

Three implementations of the same function:
  * `_paged_attention_ref`, the JAX reference: gather every table slot's
    page (-1 reads page 0), f32 logits scaled after the dot, positions
    >= seq_len set to -1e30, softmax, P.V;
  * `_paged_ref`, the plain version of the kernel: the JAX kernel's walk
    over pages j = 0..max_pages-1 in order, q*scale before the dot, one
    f32 online-softmax step a page, masked positions -1e30 (not
    skipped), acc / max(s, 1e-30);
  * the hand-written CUDA kernel `csrc/paged_attention.cu`.
With seq_len 0 every logit is -1e30, so all three return the uniform
mean of V over every gathered slot, as the JAX paths do.

`paged_attention`'s `use_kernel` chooses between the JAX package's two
TPU implementations (jnp and Pallas). The port has one on the card: a
CUDA tensor always launches the kernel, and a build or launch failure
raises (there is no fallback, unlike the JAX `kernel_fallback`). On CPU
tensors the flag picks `_paged_ref` (True) or `_paged_attention_ref`
(False). `kernel_launches` / `plain_launches` count the kernel's
launches and the CPU calls.
"""
import ctypes
import math

import numpy as np
import torch

from . import _build
from ..device import get_device

__all__ = ["PagedKVCache", "paged_attention", "kernel_launches",
           "plain_launches", "reset_counts"]

_MASK = -1e30
_DENOM_EPS = 1e-30

kernel_launches = 0
plain_launches = 0


def reset_counts():
    global kernel_launches, plain_launches
    kernel_launches = 0
    plain_launches = 0


class PagedKVCache:
    """Fixed-pool paged KV storage with host-side page allocation. The
    pools live on `device` (None: the card); pages are handed out from the
    end of the free list, and a freed sequence's pages go back in reverse,
    so the order of page ids is the JAX cache's."""

    def __init__(self, num_pages, page_size, num_heads, head_dim,
                 dtype=torch.bfloat16, *, device=None):
        dev = get_device(device)
        if not isinstance(dtype, torch.dtype):
            dtype = getattr(torch, str(dtype))
        self.page_size = page_size
        shape = (num_pages, page_size, num_heads, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=dev)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=dev)
        self._free = list(range(num_pages - 1, -1, -1))
        self.page_tables = {}   # seq id -> list of page ids
        self.seq_lens = {}

    @property
    def device(self):
        return self.k_pages.device

    def new_seq(self, seq_id):
        self.page_tables[seq_id] = []
        self.seq_lens[seq_id] = 0

    def _ensure_capacity(self, seq_id, new_len):
        need = (new_len + self.page_size - 1) // self.page_size
        table = self.page_tables[seq_id]
        while len(table) < need:
            if not self._free:
                raise RuntimeError("PagedKVCache out of pages")
            table.append(self._free.pop())

    def append(self, seq_id, k, v):
        """Append one step's K/V (1, H, D) for a sequence, in place."""
        pos = self.seq_lens[seq_id]
        self._ensure_capacity(seq_id, pos + 1)
        page = self.page_tables[seq_id][pos // self.page_size]
        slot = pos % self.page_size
        for pool, x in ((self.k_pages, k), (self.v_pages, v)):
            pool[page, slot] = torch.as_tensor(x).to(
                pool.device, pool.dtype).reshape(pool.shape[2:])
        self.seq_lens[seq_id] = pos + 1

    def free_seq(self, seq_id):
        self._free.extend(reversed(self.page_tables.pop(seq_id, [])))
        self.seq_lens.pop(seq_id, None)

    def batch_view(self, seq_ids):
        """Dense (page_table, seq_lens) int32 tensors on the cache's device
        for a batch of sequences; unused table slots are -1."""
        max_pages = max((len(self.page_tables[s]) for s in seq_ids),
                        default=1)
        max_pages = max(max_pages, 1)
        table = np.full((len(seq_ids), max_pages), -1, np.int32)
        lens = np.zeros((len(seq_ids),), np.int32)
        for i, s in enumerate(seq_ids):
            ids = self.page_tables[s]
            table[i, :len(ids)] = ids
            lens[i] = self.seq_lens[s]
        return (torch.from_numpy(table).to(self.device),
                torch.from_numpy(lens).to(self.device))


def _paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens, scale):
    """The JAX reference: gather, scale the product, mask, softmax."""
    b, _, h, d = q.shape
    P, ps = k_pages.shape[:2]
    max_pages = page_table.shape[1]
    # -1 reads page 0; JAX's gather clamps ids past the pool as well
    safe = page_table.long().clamp(0, P - 1)
    k = k_pages[safe].reshape(b, max_pages * ps, h, d)
    v = v_pages[safe].reshape(b, max_pages * ps, h, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(max_pages * ps, device=q.device)
    valid = pos[None, :] < seq_lens.long()[:, None]             # (B, K)
    s = torch.where(valid[:, None, None, :], s, _MASK)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _paged_ref(q, k_pages, v_pages, page_table, seq_lens, scale):
    """Plain version of the kernel: pages j = 0..max_pages-1 in order
    (ids clamped into [0, P-1]), one f32 online-softmax step a page over
    q*scale . k, positions >= seq_len masked to -1e30."""
    b, _, h, d = q.shape
    P, ps = k_pages.shape[:2]
    dev = q.device
    safe = page_table.long().clamp(0, P - 1)
    qf = q[:, 0].float() * scale                              # [B, H, D]
    lens = seq_lens.long()[:, None, None]
    m = torch.full((b, h, 1), _MASK, dtype=torch.float32, device=dev)
    s = torch.zeros((b, h, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, d), dtype=torch.float32, device=dev)
    for j in range(page_table.shape[1]):
        kj = k_pages[safe[:, j]].float()                      # [B, ps, H, D]
        vj = v_pages[safe[:, j]].float()
        logits = torch.einsum("bhd,bthd->bht", qf, kj)        # [B, H, ps]
        pos = j * ps + torch.arange(ps, device=dev)
        logits = torch.where(pos < lens, logits, _MASK)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        m = m_new
        s = s * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bht,bthd->bhd", p, vj)
    out = acc / s.clamp_min(_DENOM_EPS)
    return out[:, None].to(q.dtype)


_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        lib.paged_forward.argtypes = ([ctypes.c_void_p] * 6
                                      + [ctypes.c_int] * 6
                                      + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p])
        lib.paged_forward.restype = ctypes.c_int
        lib.paged_error_string.argtypes = [ctypes.c_int]
        lib.paged_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(q, k_pages, v_pages, page_table, seq_lens, scale):
    """Check the operands and launch the CUDA kernel on the current
    stream. Anything the kernel does not take raises."""
    global kernel_launches
    B, one, H, D = q.shape
    P, ps = k_pages.shape[:2]
    MP = page_table.shape[1]
    for t in (q, k_pages, v_pages, page_table, seq_lens):
        if t.device != q.device:
            raise ValueError(f"paged_attention: operands on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention: operands must be contiguous")
    if q.dtype not in _CODES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16 "
                        f"q and pages of one dtype, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if one != 1 or tuple(k_pages.shape) != (P, ps, H, D) or \
            v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} must be "
                         f"(B, 1, H, D) over pages (P, ps, H, D), got "
                         f"{tuple(k_pages.shape)}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32 or \
            tuple(page_table.shape) != (B, MP) or \
            tuple(seq_lens.shape) != (B,):
        raise TypeError("paged_attention: page_table (B, max_pages) and "
                        "seq_lens (B,) must be int32")
    if not 1 <= D <= 256:
        raise ValueError(f"paged_attention kernel takes head_dim <= 256, "
                         f"got {D}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _kernel_lib()
    rc = lib.paged_forward(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), B, H, D,
        ps, MP, P, float(scale), _CODES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError("paged_attention kernel launch failed: "
                           f"{lib.paged_error_string(rc).decode()} ({rc})")
    kernel_launches += 1
    return out


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, scale=None,
                    use_kernel=False, interpret=None):
    """Decode attention over a paged KV cache. q: (B, 1, H, D) -> (B, 1,
    H, D) in q's dtype. On the card, the CUDA kernel whatever
    `use_kernel` says (module docstring); `interpret` is the JAX
    signature's and changes nothing here."""
    global plain_launches
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    page_table = torch.as_tensor(page_table, dtype=torch.int32,
                                 device=q.device)
    seq_lens = torch.as_tensor(seq_lens, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        plain_launches += 1
        fn = _paged_ref if use_kernel else _paged_attention_ref
        return fn(q, k_pages, v_pages, page_table, seq_lens, scale)
    return _launch(q.contiguous(), k_pages, v_pages,
                   page_table.contiguous(), seq_lens.contiguous(), scale)
