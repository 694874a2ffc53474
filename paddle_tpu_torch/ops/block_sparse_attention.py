"""Block-sparse (blocked-CSR) attention (counterpart of
`paddle_tpu/ops/block_sparse_attention.py`).

softmax(Q K^T * scale) V restricted, per q-block row, to a padded list
of kv blocks. Layout matches the reference op: q/k/v are [B, H, L, D].

  block_cols   : [G, nq, max_nnz] int32, kv-block ids per q-block row
                 (right-padded; pad value arbitrary in [0, nk))
  block_counts : [G, nq]          int32, valid entries per row
  G = B*H for per-(batch, head) patterns; any other G reads pattern 0
  (G = 1: one shared pattern), as the JAX kernel's index rule does.

Two implementations of the forward:
  * `_bs_fwd_ref`, the plain PyTorch version: the JAX kernel's walk of
    each row's column list in order — q*scale before the dot, one f32
    online-softmax step per visited block, padded slots skipped (the
    JAX kernel's padded slot leaves m, l and acc unchanged bit for bit:
    alpha = exp(0) = 1, p = 0), acc / max(l, 1e-30), so a count-0 row
    emits zeros;
  * the hand-written CUDA kernel `csrc/block_sparse_attention.cu`, with
    two bodies: bf16 at block sizes 16-128 and head_dim 64 or 128 runs
    on the tensor cores, everything else (f32, bs 8, other head dims)
    on the SIMT body, which follows `_bs_fwd_ref`'s arithmetic.
    `paddle_tpu_torch.testing.bs_tc_walk` writes the tensor-core body's
    rounding points out in plain torch ((q.k) * scale, 64-key tiles, P.V
    = p_hi.V + p_lo.V with p_hi = bf16(p), p_lo = bf16(p - p_hi)); they
    sit within f32 noise of `_bs_fwd_ref`, which stays the plain version
    the kernel is held to.
A wrapper takes the plain version only for tensors on the CPU; on CUDA
tensors it launches the kernel or raises — there is no fallback.
`kernel_launches` / `plain_launches` count the calls of each, and
`route_launches` the kernel's launches by body, block size and head_dim
("tc,bs128,d128", "simt,bs8,d64"). Column ids are clamped into [0, nk)
by both, so a bad id reads a block of the sequence, never memory outside
it.

The backward is autograd of `_dense_recompute`, the dense masked
attention with the same sparsity: the JAX custom VJP, O(L^2) in memory
as in the reference. `_dense_recompute` (and the JAX reference) scale the
product instead of q, so it and the forward differ by f32 rounding.

The CSR helpers follow the reference's `F.sparse_attention` layout
(offset [B, H, L+1], columns [B, H, nnz]): `csr_element_mask` builds the
element mask for the dense path, `csr_to_block_layout` (numpy only)
detects a block-aligned pattern and returns the kernel's arrays.
"""
import ctypes
import math

import numpy as np
import torch

from . import _build

__all__ = ["block_sparse_attention", "block_mask_from_csr",
           "csr_element_mask", "csr_to_block_layout",
           "dense_mask_sparse_attention", "kernel_launches",
           "plain_launches", "route_launches", "reset_counts",
           "BLOCK_SIZES", "TC_BLOCK_SIZES", "TC_HEAD_DIMS"]

_NEG = -1e30
_DENOM_EPS = 1e-30
BLOCK_SIZES = (128, 64, 32, 16, 8)    # csr_to_block_layout's search order
# the bf16 launches the tensor-core body takes
TC_BLOCK_SIZES = (128, 64, 32, 16)
TC_HEAD_DIMS = (64, 128)
TC_KEYS = 64                           # keys a tile of that body

kernel_launches = 0
plain_launches = 0
route_launches = {}


def reset_counts():
    global kernel_launches, plain_launches
    kernel_launches = 0
    plain_launches = 0
    route_launches.clear()


def block_mask_from_csr(block_cols, block_counts, nk):
    """[G, nq, nk] bool block mask from the padded blocked-CSR arrays (an
    id outside [0, nk) marks nothing, as JAX's one_hot does)."""
    max_nnz = block_cols.shape[-1]
    dev = block_cols.device
    valid = (torch.arange(max_nnz, device=dev)[None, None, :]
             < block_counts[:, :, None])                       # [G,nq,nnz]
    onehot = (block_cols.long()[..., None]
              == torch.arange(nk, device=dev))                 # [G,nq,nnz,nk]
    return (onehot & valid[..., None]).any(dim=2)


def _dense_recompute(q, k, v, block_cols, block_counts, block_size, scale):
    """Dense-masked attention with the SAME sparsity (the golden path and
    the backward's recompute): the JAX `_dense_recompute`."""
    B, H, L, _ = q.shape
    nk = L // block_size
    bm = block_mask_from_csr(block_cols, block_counts, nk)    # [G,nq,nk]
    em = bm.repeat_interleave(block_size, 1).repeat_interleave(block_size, 2)
    em = (em.reshape(B, H, L, L) if bm.shape[0] == B * H
          else em[:, None])                                   # broadcast H
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = torch.where(em, s, _NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(-1, keepdim=True).clamp_min(_DENOM_EPS)
    # fully-masked rows: all-equal logits would give uniform weights
    p = torch.where(em, p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _row_layout(block_cols, block_counts, B, H, nk):
    """The pattern of every (b, h): cols [B or 1, H or 1, nq, max_nnz]
    clamped into [0, nk), counts alike (the kernel's g rule)."""
    cols = block_cols.long().clamp(0, nk - 1)
    counts = block_counts.long()
    if block_cols.shape[0] == B * H:
        return (cols.reshape(B, H, *cols.shape[1:]),
                counts.reshape(B, H, counts.shape[-1]))
    return cols[0][None, None], counts[0][None, None]


def _bs_fwd_ref(q, k, v, block_cols, block_counts, block_size, scale):
    """Plain forward: every q-block row walks its column list in order,
    one f32 online-softmax step per valid block (the kernel's
    arithmetic), padded slots skipped. q/k/v [B, H, L, D] -> q's dtype."""
    B, H, L, D = q.shape
    bs = block_size
    nq = nk = L // bs
    cols, counts = _row_layout(block_cols, block_counts, B, H, nk)
    cols = cols.expand(B, H, nq, cols.shape[-1])
    counts = counts.expand(B, H, nq)
    qs = (q.float() * scale).reshape(B, H, nq, bs, D)
    kb = k.float().reshape(B, H, nk, bs, D)
    vb = v.float().reshape(B, H, nk, bs, D)
    dev = q.device
    m = torch.full((B, H, nq, bs, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, nq, bs, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, nq, bs, D), dtype=torch.float32, device=dev)
    for j in range(cols.shape[-1]):
        idx = cols[..., j][..., None, None].expand(B, H, nq, bs, D)
        kj = torch.gather(kb, 2, idx)                          # [B,H,nq,bs,D]
        vj = torch.gather(vb, 2, idx)
        s = qs @ kj.transpose(-1, -2)                          # [B,H,nq,bs,bs]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        valid = (j < counts)[..., None, None]
        l = torch.where(valid, l * alpha + p.sum(-1, keepdim=True), l)
        acc = torch.where(valid, acc * alpha + p @ vj, acc)
        m = torch.where(valid, m_new, m)
    out = acc / l.clamp_min(_DENOM_EPS)
    return out.reshape(B, H, L, D).to(q.dtype)


_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("block_sparse_attention")
        lib.bsa_forward.argtypes = ([ctypes.c_void_p] * 6
                                    + [ctypes.c_int] * 7
                                    + [ctypes.c_float, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)])
        lib.bsa_forward.restype = ctypes.c_int
        lib.bsa_error_string.argtypes = [ctypes.c_int]
        lib.bsa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(q, k, v, block_cols, block_counts, block_size, scale):
    """Check the operands and launch the CUDA kernel on the current
    stream. Anything the kernel does not take raises."""
    global kernel_launches
    B, H, L, D = q.shape
    G, nq, max_nnz = block_cols.shape
    for t in (q, k, v, block_cols, block_counts):
        if t.device != q.device:
            raise ValueError(f"block_sparse_attention: operands on "
                             f"{t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("block_sparse_attention: operands must be "
                             "contiguous")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"block_sparse_attention kernel takes float32 or "
                        f"bfloat16 q/k/v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("block_sparse_attention: q, k and v must share "
                         "one [B, H, L, D] shape")
    if block_cols.dtype != torch.int32 or block_counts.dtype != torch.int32:
        raise TypeError("block_sparse_attention: block_cols and "
                        "block_counts must be int32")
    if tuple(block_counts.shape) != (G, nq):
        raise ValueError(f"block_counts {tuple(block_counts.shape)} does "
                         f"not match block_cols {tuple(block_cols.shape)}")
    if block_size not in BLOCK_SIZES or not 1 <= D <= 256:
        raise ValueError(f"block_sparse_attention kernel takes block sizes "
                         f"{BLOCK_SIZES} and head_dim <= 256, got "
                         f"{block_size}, {D}")
    if q.dtype == torch.bfloat16:
        # the tensor-core body copies 16-byte runs: a view off that
        # alignment is copied first
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _kernel_lib()
    route = ctypes.c_int(-1)
    rc = lib.bsa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), block_cols.data_ptr(),
        block_counts.data_ptr(), out.data_ptr(), B, H, L, D, block_size,
        max_nnz, int(G == B * H), float(scale), _CODES[q.dtype],
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
        ctypes.byref(route))
    if rc:
        raise RuntimeError("block_sparse_attention kernel launch failed: "
                           f"{lib.bsa_error_string(rc).decode()} ({rc})")
    kernel_launches += 1
    key = f"{'tc' if route.value == 1 else 'simt'},bs{block_size},d{D}"
    route_launches[key] = route_launches.get(key, 0) + 1
    return out


def _bs_fwd(q, k, v, block_cols, block_counts, block_size, scale):
    global plain_launches
    if q.device.type == "cpu":
        plain_launches += 1
        return _bs_fwd_ref(q, k, v, block_cols, block_counts, block_size,
                           scale)
    return _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                   block_cols, block_counts, block_size, scale)


class _BlockSparseAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or `_bs_fwd_ref` (CPU). Backward:
    autograd of `_dense_recompute` on the saved q, k, v (the JAX VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, block_cols, block_counts, block_size, scale):
        ctx.save_for_backward(q, k, v, block_cols, block_counts)
        ctx.block_size, ctx.scale = block_size, scale
        return _bs_fwd(q, k, v, block_cols, block_counts, block_size,
                       scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, block_cols, block_counts = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _dense_recompute(*qkv, block_cols, block_counts,
                                   ctx.block_size, ctx.scale)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None, None, None, None)


def block_sparse_attention(q, k, v, block_cols, block_counts, block_size,
                           scale=None, interpret=None):
    """softmax(QK^T / sqrt(d)) V restricted to the given kv blocks per
    q-block row. q/k/v: [B, H, L, D]; see the module docstring for the
    blocked-CSR layout. Differentiable (dense-masked recompute backward).
    `interpret` is the JAX signature's (Pallas interpret mode) and
    changes nothing here: CPU tensors take the plain version."""
    B, H, L, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    block_size = int(block_size)
    cols = torch.as_tensor(block_cols, dtype=torch.int32, device=q.device)
    counts = torch.as_tensor(block_counts, dtype=torch.int32,
                             device=q.device)
    if cols.dim() != 3 or L % block_size or cols.shape[1] != L // block_size:
        raise ValueError(f"block_cols {tuple(cols.shape)} does not tile "
                         f"L={L} in blocks of {block_size}")
    return _BlockSparseAttention.apply(q, k, v, cols.contiguous(),
                                       counts.contiguous(), block_size,
                                       float(scale))


def dense_mask_sparse_attention(q, k, v, mask, key_padding_mask=None,
                                attn_mask=None, scale=None):
    """The reference semantics on any pattern: element-level mask
    [B, H, L, L] (True = attend), optional key_padding_mask [B, L] and
    attn_mask [L, L] with 0 = masked (the reference sparse_attention
    arguments). Plain torch, as the JAX version is plain jnp."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if key_padding_mask is not None:
        mask = mask & (key_padding_mask[:, None, None, :] != 0)
    if attn_mask is not None:
        mask = mask & (attn_mask[None, None, :, :] != 0)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask, s, _NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    p = torch.where(mask, p / l.clamp_min(_DENOM_EPS), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def csr_element_mask(offset, columns, seq_len):
    """[B, H, L, L] bool mask from an element-level CSR pattern (offset
    [B, H, L+1], columns [B, H, nnz], tensors on one device). Entry n of
    (b, h) lies in the row r with offset[r] <= n < offset[r+1]; entries
    outside every row, or with a column outside [0, L), are dropped."""
    B, H, _ = offset.shape
    nnz = columns.shape[-1]
    L = int(seq_len)
    dev = offset.device
    idx = torch.arange(nnz, device=dev).expand(B, H, nnz).contiguous()
    rows = torch.searchsorted(offset.long().contiguous(), idx,
                              right=True) - 1                  # [B, H, nnz]
    cols = columns.long()
    keep = (rows >= 0) & (rows < L) & (cols >= 0) & (cols < L)
    bi = torch.arange(B, device=dev)[:, None, None].expand(B, H, nnz)
    hi = torch.arange(H, device=dev)[None, :, None].expand(B, H, nnz)
    mask = torch.zeros((B, H, L, L), dtype=torch.bool, device=dev)
    mask[bi[keep], hi[keep], rows[keep], cols[keep]] = True
    return mask


def _dense_pattern(off, cols, L):
    """[G, L, L] bool of the element CSR (off [G, L+1], cols [G, nnz]),
    numpy: row r of pattern g holds cols[g, off[g, r]:off[g, r+1]] (the
    JAX loop over rows, vectorised). Offsets must rise from >= 0 to at
    most nnz; anything else raises."""
    G, nnz = cols.shape
    steps = np.diff(off, axis=-1)
    if (off[:, 0] < 0).any() or (off[:, -1] > nnz).any() or (steps < 0).any():
        raise ValueError("sparse_csr_offset must be non-decreasing, from "
                         ">= 0 to at most the columns' length")
    dense = np.zeros((G, L, L), bool)
    for g in range(G):
        rows = np.repeat(np.arange(L), steps[g])
        dense[g, rows, cols[g, off[g, 0]:off[g, -1]]] = True
    return dense


def csr_to_block_layout(offset, columns, seq_len, block_sizes=BLOCK_SIZES):
    """Detect whether a CONCRETE element-level CSR pattern (offset
    [B, H, L+1], columns [B, H, nnz]) is exactly block-aligned for some
    block size, trying `block_sizes` in order; if so return (block_size,
    block_cols [B*H, nq, max_nnz] int32, block_counts [B*H, nq] int32)
    with each row's block ids ascending and zeros after them, else None.
    numpy only; equal to the JAX function's arrays."""
    offset = np.asarray(offset)
    columns = np.asarray(columns)
    B, H, Lp1 = offset.shape
    L = int(seq_len)
    G = B * H
    dense = _dense_pattern(offset.reshape(G, Lp1), columns.reshape(G, -1), L)
    for bs in block_sizes:
        if L % bs:
            continue
        nb = L // bs
        blocks = dense.reshape(G, nb, bs, nb, bs)
        anyb = blocks.any(axis=(2, 4))
        allb = blocks.all(axis=(2, 4))
        if not (anyb == allb).all():
            continue   # partially-filled block: not aligned at this size
        counts = anyb.sum(axis=-1).astype(np.int32)            # [G, nb]
        max_nnz = max(1, int(counts.max()))
        # the set blocks first, ascending (a stable sort of ~anyb)
        order = np.argsort(~anyb, axis=-1, kind="stable")[..., :max_nnz]
        colsb = np.where(np.arange(max_nnz) < counts[..., None], order, 0)
        return bs, colsb.astype(np.int32), counts
    return None
