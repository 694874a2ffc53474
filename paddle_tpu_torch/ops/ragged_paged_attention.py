"""Ragged paged attention: one causal attention primitive for mixed
chunked-prefill + decode batches over the paged KV pool (counterpart of
`paddle_tpu/ops/ragged_paged_attention.py`).

Query j of row i sits at absolute position ``start[i] + j`` and attends
causally (kpos <= qpos) over the row's own pages, so a token's output
does not depend on the window width, the batch composition, or whether
it was computed as a decode tick, inside a prefill chunk or inside the
packed token stream — the schedule independence the serving engine's
byte-identical stream guarantees ride on.

Shapes:
  q               : (n, W, H, D) dense windows, or (T, H, D) packed
  k_pages/v_pages : one layer's page pool, in one of three layouts:
                    f32/bf16 (P, page_size, H, D) in q's dtype;
                    int8 as the tuple (pages int8 (P, page_size, H, D),
                    per-token scales f32 (P, page_size));
                    int4 as the tuple (nibble-packed uint8
                    (P, page_size, PB), per-group scales f32
                    (P, page_size, G)) — the serving decoder's
                    kv_quant="int8" / "int4" pools
  page_table      : (n, max_pages) int32 page ids per row
  start           : (n,) already-cached length per row (dense)
  row_ids, pos    : (T,) each packed token's table row and position

Two implementations of the same math:
  * `_ragged_ref`, the plain PyTorch version: the JAX reference's
    per-page online softmax (`_page_update`), with its -1e30 mask and
    1e-30 denominator floor, in f32, walked in chunks of `CHUNK_PAGES`
    pages at fixed page indices, each chunk from a fresh (m, s, acc);
    the chunks' partials merge in chunk order (`_merge_chunks`: M = max
    m_c, s = sum s_c exp(m_c - M), acc likewise, acc / max(s, 1e-30)).
    An int8 page's key scale multiplies the finished logits and its
    value scale the values before the PV dot; an int4 page dequantizes
    through `_dequant_page_int4` before both dots. One page dequantizes
    at a time; the f32 pool never exists;
  * the hand-written CUDA kernel `csrc/ragged_paged_attention.cu` (body
    `csrc/decode_attention.cuh`), one template per pool layout around the
    same chunked walk and merge: at decode sizes each chunk of a query
    (tile) and head is a block of its own and a second kernel merges;
    the queries of one row at consecutive positions share each page load.
A wrapper takes the plain version only for tensors on the CPU. On CUDA
tensors it launches the kernel or raises — there is no fallback.
`CHUNK_PAGES` is read from the kernels' header, so the plain versions cut
the walk where the kernels do.
`kernel_launches` / `plain_launches` count the calls of each;
`device_launches` counts the kernel's device launches (two for a split
call, one otherwise).
"""
import ctypes
import math
import re

import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_packed",
           "kernel_launches", "plain_launches", "device_launches",
           "reset_counts", "CHUNK_PAGES"]

_DENOM_EPS = 1e-30
_MASK = -1e30


def _header_int(name):
    """A `constexpr int` of csrc/decode_attention.cuh, the one definition
    the kernels and the plain versions share."""
    text = (_build.CSRC / "decode_attention.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# Pages a chunk: a query's walk is cut at page indices c * CHUNK_PAGES, the
# chunks walked apart and merged in order (kernel and plain version alike).
CHUNK_PAGES = _header_int("kChunkPages")
# The kernel's launch plan, which changes no bit of the output: a launch
# of at most SPLIT_MAX_ROWS (query, head) pairs over a table of more than
# one chunk walks each chunk of a query tile in a block of its own and
# merges them in a second kernel; a wider one walks a tile's chunks in one
# block and merges them in shared memory. Set at the crossover of the two
# plans' device times at the serving engine's packed ticks, which
# chip_smoke.py's `[kernel_time] check=launch plans` lines measure: on an
# H100 the split wins at the 16-token decode tick (256 pairs), the two are
# close at one or two 128-token prefill chunks (T 143, 270: 2288 and 4320
# pairs) and the unsplit wins from four (PERF.md section 6).
SPLIT_MAX_ROWS = 4096

# wrapper calls that launched the CUDA kernel, calls of the plain version,
# and the kernel's device launches
kernel_launches = 0
plain_launches = 0
device_launches = 0


def reset_counts():
    global kernel_launches, plain_launches, device_launches
    kernel_launches = 0
    plain_launches = 0
    device_launches = 0


def _page_update(m, s, acc, logits, v, kpos, qpos, k_scale=None,
                 v_scale=None):
    """ONE page's online-softmax update (the JAX `_page_update`).
    m/s/acc: running max [..., W, 1], denominator [..., W, 1], value
    accumulator [..., W, D]; logits [..., W, ps] this page's scores;
    v [..., ps, D]; kpos [ps] the page's key positions; qpos [..., W].
    k_scale/v_scale (int8 pools): the page's per-token scales,
    broadcastable to [..., ps]; the key scale multiplies the finished
    logits (q.(k*s) == (q.k)*s) and V dequantizes before the PV dot."""
    if k_scale is not None:
        logits = logits * k_scale[..., None, :]
    if v_scale is not None:
        v = v * v_scale[..., :, None]
    mask = kpos[..., None, :] <= qpos[..., :, None]       # [..., W, ps]
    logits = torch.where(mask, logits, _MASK)
    m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
    p = torch.exp(logits - m_new)
    corr = torch.exp(m - m_new)
    s_new = s * corr + p.sum(-1, keepdim=True)
    acc_new = acc * corr + (p[..., None] * v[..., None, :, :]).sum(-2)
    return m_new, s_new, acc_new


def _dequant_page_int4(packed, gscale, heads):
    """ONE int4 page's dequant (the JAX `_dequant_page_int4`): packed
    [..., ps, PB] uint8 nibble pairs (element 2i in the low nibble),
    gscale [..., ps, G] f32 per-group scales, heads = (H, D). Element e
    of the flattened H*D axis is nibble e of the payload times the scale
    of group e // (2*PB // G). Returns f32 [..., ps, H, D]. Exact in f32
    (an integer times a scale), so it rounds as the kernel does."""
    H, D = int(heads[0]), int(heads[1])
    PB = packed.shape[-1]
    G = gscale.shape[-1]
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    q = torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (2 * PB,)).float()
    group = (2 * PB) // G
    g = q.reshape(packed.shape[:-1] + (G, group)) * gscale[..., None]
    flat = g.reshape(packed.shape[:-1] + (G * group,))[..., :H * D]
    return flat.reshape(packed.shape[:-1] + (H, D))


def _merge_chunks(parts):
    """Merge chunk partials [(m, s, acc), ...] in chunk order: M = max m_c,
    w_c = exp(m_c - M), s = sum s_c w_c, acc = sum acc_c w_c (each product
    rounded, then added in order), out = acc / max(s, 1e-30). A chunk past
    a query's causal range (m_c = -1e30 beside a real M) adds exact
    zeros."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    s = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for m, sc, ac in parts:
        w = torch.exp(m - M)
        s = s + sc * w
        acc = acc + ac * w
    return acc / s.clamp_min(_DENOM_EPS)


def _ragged_ref(q, k_pages, v_pages, page_table, start, scale,
                k_scale=None, v_scale=None, int4=False):
    """Plain version: the kernel's walk as a loop over the table's pages in
    chunks of CHUNK_PAGES, each page through `_page_update`, each chunk
    from a fresh state, the chunks merged by `_merge_chunks`. q [n, W, H,
    D] -> [n, W, H, D]. int8 pools pass their [P, ps] per-token scales as
    k_scale/v_scale; int4 pools (`int4=True`) their packed [P, ps, PB]
    pages and [P, ps, G] group scales. The gather stays quantized and one
    page dequantizes per step, as in the JAX reference (which also pins an
    XLA `optimization_barrier` there; eager PyTorch needs none). The dots
    are products summed with `sum` over the head dim and over the page's
    keys, not batched matmuls: a CPU matmul picks its blocking, and so its
    summation order, by shape, while a reduction's order depends only on
    its own length — so this version, like the kernel, gives a query the
    same bits in any window width, batch or packed stream."""
    n, W, H, D = q.shape
    P, ps = k_pages.shape[:2]
    MP = page_table.shape[1]
    dev = q.device
    int8 = k_scale is not None and not int4
    safe = page_table.long().clamp(0, P - 1)
    qf = (q.float() * scale).transpose(1, 2)                 # [n, H, W, D]
    qpos = (start.long()[:, None]
            + torch.arange(W, device=dev))[:, None, :]       # [n, 1, W]
    parts = []
    for c0 in range(0, MP, CHUNK_PAGES):
        m = torch.full((n, H, W, 1), _MASK, dtype=torch.float32, device=dev)
        s = torch.zeros((n, H, W, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((n, H, W, D), dtype=torch.float32, device=dev)
        for j in range(c0, min(c0 + CHUNK_PAGES, MP)):
            pid = safe[:, j]
            if int4:
                kj = _dequant_page_int4(k_pages[pid], k_scale[pid], (H, D))
                vj = _dequant_page_int4(v_pages[pid], v_scale[pid], (H, D))
            else:
                kj = k_pages[pid].float()
                vj = v_pages[pid].float()
            kj = kj.transpose(1, 2)                          # [n, H, ps, D]
            vj = vj.transpose(1, 2)
            logits = (qf[..., None, :] * kj[..., None, :, :]).sum(-1)
            kpos = j * ps + torch.arange(ps, device=dev)
            # int8: [n, ps] -> [n, 1, ps], broadcast over the head axis
            m, s, acc = _page_update(
                m, s, acc, logits, vj, kpos, qpos,
                k_scale=k_scale[pid][:, None] if int8 else None,
                v_scale=v_scale[pid][:, None] if int8 else None)
        parts.append((m, s, acc))
    return _merge_chunks(parts).transpose(1, 2).to(q.dtype)


def _split_pool(k_pages, v_pages):
    """(k pages, v pages, k scales, v scales, int4) of a plain pool or of
    an int8/int4 (pages, scales) tuple pool. A uint8 payload is int4."""
    if isinstance(k_pages, tuple) != isinstance(v_pages, tuple):
        raise TypeError("ragged_paged_attention: K and V pools must share "
                        "one layout")
    if isinstance(k_pages, tuple):
        (kp, ks), (vp, vs) = k_pages, v_pages
        return kp, vp, ks, vs, kp.dtype == torch.uint8
    return k_pages, v_pages, None, None, False


_CODES = {torch.float32: 0, torch.bfloat16: 1}
# pool layouts of the kernel's template (csrc: enum Layout)
_PLAIN, _INT8, _INT4 = 0, 1, 2
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("ragged_paged_attention")
        lib.rpa_forward.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
            + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.rpa_forward.restype = ctypes.c_int
        lib.rpa_scratch_floats.argtypes = [ctypes.c_int] * 9
        lib.rpa_scratch_floats.restype = ctypes.c_long
        lib.rpa_error_string.argtypes = [ctypes.c_int]
        lib.rpa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_plans = {}


def _plan(query, rows, geo, tail, split=None):
    """(split, scratch f32 a (query, head)) of a launch of `rows` (query,
    head) pairs over a table geo[3] pages wide. split None: the
    SPLIT_MAX_ROWS rule, or the split launch where the unsplit block does
    not fit shared memory; True / False forces the plan.
    `query(*geo, split, *tail)` is the source's C plan query (-1: the
    block does not fit), cached by its arguments."""
    def floats(s):
        key = (query.__name__, *geo, int(s), *tail)
        if key not in _plans:
            _plans[key] = query(*geo, int(s), *tail)
        return _plans[key]
    if split is None:
        split = (geo[3] > CHUNK_PAGES and rows <= SPLIT_MAX_ROWS) or \
            floats(False) < 0
    per = floats(split)
    if per < 0:
        raise ValueError(f"{query.__name__}: the {'un' * (not split)}split "
                         f"launch does not fit shared memory for {geo}")
    return bool(split), per


def _layout(q, kp, vp, ks, vs, int4):
    """Check the pool against q [..., H, D] and name its layout; returns
    (layout, PB, G). Anything but the three layouts raises."""
    H, D = q.shape[-2:]
    P, ps = kp.shape[:2]
    if vp.shape != kp.shape or vp.dtype != kp.dtype:
        raise ValueError(f"K and V pools differ: {tuple(kp.shape)} "
                         f"{kp.dtype} vs {tuple(vp.shape)} {vp.dtype}")
    if ks is None:
        if kp.dtype != q.dtype:
            raise TypeError(f"ragged_paged_attention kernel takes a plain "
                            f"pool of q's dtype {q.dtype}, got {kp.dtype}")
        if tuple(kp.shape) != (P, ps, H, D):
            raise ValueError(f"pool {tuple(kp.shape)} does not match q "
                             f"heads {H} x head_dim {D}")
        return _PLAIN, 0, 0
    if ks.dtype != torch.float32 or vs.dtype != torch.float32 or \
            vs.shape != ks.shape:
        raise TypeError(f"quantized pools carry f32 scales of one shape, "
                        f"got {ks.dtype}/{vs.dtype}")
    if int4:
        if kp.dim() != 3 or ks.dim() != 3 or ks.shape[:2] != (P, ps) or \
                ks.shape[2] < 1 or (2 * kp.shape[2]) % ks.shape[2] or \
                2 * kp.shape[2] < H * D:
            raise ValueError(
                f"int4 pool: pages {tuple(kp.shape)} and group scales "
                f"{tuple(ks.shape)} do not hold H*D = {H * D} elements in "
                "whole groups")
        return _INT4, kp.shape[2], ks.shape[2]
    if kp.dtype != torch.int8:
        raise TypeError(f"a quantized pool holds int8 or uint8 (int4) "
                        f"pages, got {kp.dtype}")
    if tuple(kp.shape) != (P, ps, H, D) or tuple(ks.shape) != (P, ps):
        raise ValueError(f"int8 pool: pages {tuple(kp.shape)}, scales "
                         f"{tuple(ks.shape)} do not match q heads {H} x "
                         f"head_dim {D}")
    return _INT8, 0, 0


def _launch(q, k_pages, v_pages, page_table, row_of, start, scale,
            split=None):
    """Check the operands and launch the CUDA kernel on the current
    stream. q [N, W, H, D] (or [N, H, D], W = 1); the pools plain or
    (pages, scales) tuples; row_of [N] int32 or None (row n); split: the
    launch plan (`_plan`; None: SPLIT_MAX_ROWS decides). A split launch's
    chunk partials, N * W * H * ceil(MP / CHUNK_PAGES) * (D + 4) f32,
    take scratch from here: at most SPLIT_MAX_ROWS x 8 chunks x 132 x 4
    bytes = 17 MB for gpt_1p3b's tables (MP 64, D 128; 1.1 MB at a
    16-token decode tick); an unsplit launch keeps them in shared memory
    (17 KB a block at MP 64, D 128) and takes none. At decode the kernel
    runs for about as long as this function takes, so the checks read
    plain attributes and the stream handle comes without a Stream
    object."""
    global kernel_launches, device_launches
    kp, vp, ks, vs, int4 = _split_pool(k_pages, v_pages)
    if q.dim() == 3:                        # the packed stream: W = 1
        (N, H, D), W = q.shape, 1
    else:
        N, W, H, D = q.shape
    P, ps = kp.shape[:2]
    R, MP = page_table.shape
    ints = (page_table, start) + (() if row_of is None else (row_of,))
    scales = () if ks is None else (ks, vs)
    dev = q.get_device()
    for t in (q, kp, vp) + scales + ints:
        if t.get_device() != dev:
            raise ValueError(
                f"ragged_paged_attention: operands on {t.device} and "
                f"{q.device}")
        if not t.is_contiguous():
            raise ValueError("ragged_paged_attention: operands must be "
                             "contiguous")
    if q.dtype not in _CODES:
        raise TypeError(f"ragged_paged_attention kernel takes float32 or "
                        f"bfloat16 q, got {q.dtype}")
    layout, PB, G = _layout(q, kp, vp, ks, vs, int4)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("ragged_paged_attention: page table, start/pos "
                        "and row ids must be int32")
    if start.shape != (N,) or (row_of is not None and row_of.shape != (N,)):
        raise ValueError("start/pos and row ids must be [N] vectors")
    if D not in (32, 64, 128, 256) or not 1 <= ps <= 32:
        raise ValueError(f"kernel takes head_dim in 32/64/128/256 and "
                         f"page_size <= 32, got {D}, {ps}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _kernel_lib()
    dtype = _CODES[q.dtype]
    split, per = _plan(lib.rpa_scratch_floats, N * W * H,
                       (H, D, ps, MP, PB, G), (dtype, layout), split)
    scratch = torch.empty((N * W * H * per,), dtype=torch.float32,
                          device=q.device) if per else None
    rc = lib.rpa_forward(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), page_table.data_ptr(),
        None if row_of is None else row_of.data_ptr(),
        start.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), N, W, H, D, ps, MP,
        P, R, PB, G, float(scale), int(split), dtype, layout, dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        raise RuntimeError(
            "ragged_paged_attention kernel launch failed: "
            f"{lib.rpa_error_string(rc).decode()} ({rc})")
    kernel_launches += 1
    device_launches += 2 if split else 1
    return out


def _plain(q, k_pages, v_pages, table, start, scale):
    global plain_launches
    plain_launches += 1
    kp, vp, ks, vs, int4 = _split_pool(k_pages, v_pages)
    return _ragged_ref(q, kp, vp, table, start, scale, k_scale=ks,
                       v_scale=vs, int4=int4)


def ragged_paged_attention(q, k_pages, v_pages, page_table, start,
                           scale=None):
    """Causal attention of ragged new-token windows over paged KV.
    q (n, W, H, D): row i's new tokens at positions start[i]..start[i]+
    W-1 (padded queries past a row's true length produce row-local
    garbage the caller discards). Decode rows are W=1. The pools are
    plain, or int8/int4 (pages, scales) tuples (module docstring).
    Returns (n, W, H, D) in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _plain(q, k_pages, v_pages, page_table, start, scale)
    return _launch(q, k_pages, v_pages, page_table, None, start, scale)


def ragged_paged_attention_packed(q, k_pages, v_pages, page_table,
                                  row_ids, pos, scale=None):
    """PACKED-layout causal attention: q [T, H, D] is a flat stream of
    new tokens; token t belongs to table row `row_ids[t]` (clamped into
    the table) and sits at absolute position `pos[t]`. Per-token math is
    the dense form's exactly, so a token's output is bit-identical to
    the dense form computing the same position in any window. Unlike
    the JAX wrapper, nothing pads the stream to a 2-wide window (that
    padding works around XLA-CPU rounding and changes no output). The
    pools take the dense form's layouts. Returns [T, H, D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        rows = row_ids.long().clamp(0, page_table.shape[0] - 1)
        return _plain(q[:, None], k_pages, v_pages, page_table[rows], pos,
                      scale)[:, 0]
    return _launch(q, k_pages, v_pages, page_table, row_ids, pos, scale)
