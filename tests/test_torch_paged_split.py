"""The split page walk of the port's decode attention (ragged paged
attention over f32/bf16, int8 and int4 pools, and legacy paged decode
attention): each query's walk is cut at fixed page indices into chunks of
`CHUNK_PAGES` pages, each chunk walked from a fresh online-softmax state,
and the chunks' (m, s, acc) merged in chunk order. The plain versions walk
and merge exactly as the CUDA kernels do; here they are held, on rows that
cross three or more chunks, against the JAX package's reference and its
Pallas kernel in interpret mode (both walk every page in one sequence), on
the same numpy inputs.

Tolerances:
- f32 within atol 1e-5: both sides accumulate in f32; only the order of the
  sums (the merge's rescaling among them) differs.
- bf16 outputs within one bf16 ulp of the larger magnitude plus 1e-5: both
  sides compute in f32 from the same bf16 inputs and round once at the
  end, so an f32 difference far below a bf16 ulp can still flip that
  rounding; near zero the f32 difference is absolute.
- The merge formula against a float64 softmax over the whole row: atol 1e-5
  (f32 rounding of the chunk sums and the rescale, outputs of magnitude
  ~1).
- Inside the port, bits: a query's output is the same alone (W = 1),
  inside a W = 16 window, inside a shuffled packed stream, and as part of
  a same-row run of stream items or scattered among other rows.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import ragged_paged_attention as jrpa
from paddle_tpu.serving import decoder as jdec
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import ragged_paged_attention as rpa

H, D, PS = 2, 16, 4
C = rpa.CHUNK_PAGES                  # pages a chunk
SPAN = C * PS                        # keys a chunk
MP = 5 * C                           # table width: five chunks
P = MP + 9                           # pool pages (one scratch)
# query positions on chunk edges: the first and the last key of chunks 0,
# 1, 3 and 4 (rows cross up to five chunks)
EDGES = [0, SPAN - 1, SPAN, 3 * SPAN - 1, 3 * SPAN, 4 * SPAN + 5,
         MP * PS - 1]
LAYOUTS = ["float32", "bfloat16", "int8", "int4"]


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 1e-5
        assert (np.abs(got - want) <= tol).all(), \
            float(np.max(np.abs(got - want) - tol))
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _table(rng, n):
    t = np.stack([rng.permutation(P - 1)[:MP] for _ in range(n)]
                 ).astype(np.int32)
    t[0, -1] = P - 1                 # scratch tail
    t[-1, -2:] = -1                  # -1 entries clamp to page 0
    return t


def _pools(layout, seed):
    """(JAX pools, port pools, q dtype name) holding the same values: f32
    or bf16 pages, or int8/int4 (pages, scales) quantized by the JAX
    decoder's quantizers."""
    rng = np.random.RandomState(seed)
    raw = [rng.randn(P, PS, H, D).astype(np.float32) for _ in range(2)]
    if layout in ("float32", "bfloat16"):
        jd = jnp.float32 if layout == "float32" else jnp.bfloat16
        td = torch.float32 if layout == "float32" else torch.bfloat16
        return ([jnp.asarray(r, jd) for r in raw],
                [torch.from_numpy(r).to(td) for r in raw], layout)
    quantize = jdec._quantize_kv if layout == "int8" \
        else jdec._quantize_kv_int4
    jp = [quantize(jnp.asarray(r)) for r in raw]
    tp = [tuple(torch.from_numpy(np.array(x)) for x in pool) for pool in jp]
    return jp, tp, "float32"


def _q(rng, shape, dtype):
    q = rng.randn(*shape).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(q, jd), torch.from_numpy(q).to(td)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("W", [1, 3, 8])
def test_long_rows_dense_match_jax(layout, W):
    """Dense windows starting one key before each chunk edge (so a
    window straddles it), plain version against the JAX reference and the
    Pallas kernel in interpret mode."""
    (jk, jv), (tk, tv), dtype = _pools(layout, seed=W)
    rng = np.random.RandomState(10 + W)
    n = len(EDGES)
    table = _table(rng, n)
    start = np.clip(np.asarray(EDGES) - 1, 0, MP * PS - W).astype(np.int32)
    jq, tq = _q(rng, (n, W, H, D), dtype)
    got = rpa.ragged_paged_attention(tq, tk, tv, torch.from_numpy(table),
                                     torch.from_numpy(start))
    args = (jq, jk, jv, jnp.asarray(table), jnp.asarray(start))
    for use_kernel in (False, True):
        want = jrpa.ragged_paged_attention(*args, use_kernel=use_kernel,
                                           interpret=True)
        _close(got.float().numpy(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_long_rows_packed_match_jax(layout):
    """A packed stream whose positions sit on chunk edges, rows cycling
    through the table, against the JAX packed reference and kernel."""
    (jk, jv), (tk, tv), dtype = _pools(layout, seed=21)
    rng = np.random.RandomState(22)
    n = 3
    table = _table(rng, n)
    pos = np.asarray(EDGES * 2, np.int32)
    rows = (np.arange(len(pos)) % n).astype(np.int32)
    jq, tq = _q(rng, (len(pos), H, D), dtype)
    got = rpa.ragged_paged_attention_packed(
        tq, tk, tv, torch.from_numpy(table), torch.from_numpy(rows),
        torch.from_numpy(pos))
    args = (jq, jk, jv, jnp.asarray(table), jnp.asarray(rows),
            jnp.asarray(pos))
    for use_kernel in (False, True):
        want = jrpa.ragged_paged_attention_packed(
            *args, use_kernel=use_kernel, interpret=True)
        _close(got.float().numpy(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_long_rows_bit_identical_across_windows_and_packing(layout):
    """Inside the port, long rows: each query alone (W = 1), inside a W = 16
    window and inside a shuffled packed stream give the same bits."""
    _, (tk, tv), dtype = _pools(layout, seed=31)
    rng = np.random.RandomState(32)
    n, W = 3, 16
    table = torch.from_numpy(_table(rng, n))
    start = torch.tensor([SPAN - 3, 3 * SPAN - 8, MP * PS - W],
                         dtype=torch.int32)
    _, q = _q(rng, (n, W, H, D), dtype)
    got = rpa.ragged_paged_attention(q, tk, tv, table, start)
    alone = torch.cat([rpa.ragged_paged_attention(
        q[:, j:j + 1].contiguous(), tk, tv, table, start + j)
        for j in range(W)], dim=1)
    rows = torch.arange(n).repeat_interleave(W).int()
    pos = (start[:, None] + torch.arange(W)).reshape(-1).int()
    perm = torch.from_numpy(rng.permutation(n * W))
    packed = rpa.ragged_paged_attention_packed(
        q.reshape(n * W, H, D)[perm], tk, tv, table, rows[perm], pos[perm])
    unperm = torch.empty_like(packed)
    unperm[perm] = packed
    assert torch.equal(alone, got)
    assert torch.equal(unperm.reshape(n, W, H, D), got)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_same_row_run_equals_scattered_items(layout):
    """A run of consecutive stream items of one row at consecutive
    positions (how the decoder packs a prefill chunk, and what the kernel
    tiles so that they share page loads) gives the bits those items get
    shuffled in among other rows' items."""
    _, (tk, tv), dtype = _pools(layout, seed=41)
    rng = np.random.RandomState(42)
    table = torch.from_numpy(_table(rng, 4))
    run = 2 * SPAN - 5 + torch.arange(12, dtype=torch.int32)   # row 1
    others = torch.tensor([7, SPAN, 3 * SPAN + 1, MP * PS - 1],
                          dtype=torch.int32)                   # rows 0,2,3
    pos = torch.cat([others[:1], run, others[1:]])
    rows = torch.tensor([0] + [1] * 12 + [2, 3, 0], dtype=torch.int32)
    _, q = _q(rng, (len(pos), H, D), dtype)
    got = rpa.ragged_paged_attention_packed(q, tk, tv, table, rows, pos)
    perm = torch.from_numpy(rng.permutation(len(pos)))
    shuffled = rpa.ragged_paged_attention_packed(q[perm], tk, tv, table,
                                                 rows[perm], pos[perm])
    unperm = torch.empty_like(shuffled)
    unperm[perm] = shuffled
    assert torch.equal(unperm, got)


def _paged(dtype, lens, seed):
    """JAX and port paged caches (one row per length, a table of MP
    pages), q; both packages read the same values."""
    rng = np.random.RandomState(seed)
    B = len(lens)
    kp, vp = (rng.randn(P, PS, H, D).astype(np.float32) for _ in range(2))
    table = _table(rng, B)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    lens = np.asarray(lens, np.int32)
    return ([jnp.asarray(x, jd) for x in (q, kp, vp)]
            + [jnp.asarray(table), jnp.asarray(lens)],
            [torch.from_numpy(x).to(td) for x in (q, kp, vp)]
            + [torch.from_numpy(table), torch.from_numpy(lens)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_long_rows_and_empty_wide_table_match_jax(dtype):
    """Sequence lengths across 1-5 chunks, on chunk edges, and a seq_len 0
    row over a table five chunks wide (the uniform mean of V over every
    slot, as in JAX), plain version against the JAX reference and the
    Pallas kernel in interpret mode."""
    lens = [0, 1, SPAN, SPAN + 1, 3 * SPAN, 3 * SPAN + 1, MP * PS - 2]
    jargs, targs = _paged(dtype, lens, seed=51)
    got = pa.paged_attention(*targs, use_kernel=True).float().numpy()
    for use_kernel in (False, True):
        want = jpa.paged_attention(*jargs, use_kernel=use_kernel,
                                   interpret=True)
        _close(got, want.astype(jnp.float32), dtype)
    # seq_len 0: the uniform mean of V over the row's MP gathered pages
    v = targs[2].float().numpy()
    ids = np.clip(targs[3].numpy()[0], 0, P - 1)
    mean = v[ids].reshape(-1, H, D).mean(0)
    _close(got[0, 0], mean, dtype)


def test_paged_pages_longer_than_a_key_tile():
    """Pages of 48 tokens: the kernel (and its plain version) take one
    online-softmax step a 32-key tile of a page, within f32 tolerance of
    the JAX walk of whole pages."""
    rng = np.random.RandomState(61)
    ps, MPs, Pp, B = 48, 9, 20, 3
    kp, vp = (rng.randn(Pp, ps, H, D).astype(np.float32) for _ in range(2))
    table = np.stack([rng.permutation(Pp)[:MPs] for _ in range(B)]
                     ).astype(np.int32)
    lens = np.asarray([0, 33, MPs * ps - 3], np.int32)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    got = pa.paged_attention(*(torch.from_numpy(x) for x in
                               (q, kp, vp, table, lens)), use_kernel=True)
    for use_kernel in (False, True):
        want = jpa.paged_attention(*(jnp.asarray(x) for x in
                                     (q, kp, vp, table, lens)),
                                   use_kernel=use_kernel, interpret=True)
        _close(got.numpy(), want, "float32")


def test_merge_formula_matches_float64_softmax():
    """Chunk partials of a row split at several chunk sizes, merged by
    `_merge_chunks`, against a direct float64 softmax over the whole row;
    a chunk past the query (m = -1e30) adds nothing."""
    rng = np.random.RandomState(71)
    L, Dv = 200, 8
    logits = (rng.randn(3, L) * 4).astype(np.float32)
    v = rng.randn(L, Dv).astype(np.float32)
    p64 = np.exp(logits.astype(np.float64)
                 - logits.max(-1, keepdims=True))
    want = (p64 / p64.sum(-1, keepdims=True)) @ v.astype(np.float64)
    for chunk in (7, 32, 64, 200):
        parts = []
        for c0 in range(0, L, chunk):
            lg = torch.from_numpy(logits[:, c0:c0 + chunk])
            m = lg.amax(-1, keepdim=True)
            p = torch.exp(lg - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          p @ torch.from_numpy(v[c0:c0 + chunk])))
        masked = (torch.full((3, 1), -1e30), torch.full((3, 1), 5.0),
                  torch.ones(3, Dv))
        got = rpa._merge_chunks(parts + [masked])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        assert torch.equal(got, rpa._merge_chunks(parts))


@pytest.mark.parametrize("name", ["ragged", "paged"])
def test_plain_walk_is_split_at_chunk_edges(name, monkeypatch):
    """The plain versions cut the walk at CHUNK_PAGES: a row within one
    chunk is unchanged bit for bit by a wider chunk, and a row crossing
    chunks differs from the unsplit walk only by f32 rounding (so the
    split is really taken)."""
    rng = np.random.RandomState(81)
    kp, vp = (torch.from_numpy(rng.randn(P, PS, H, D).astype(np.float32))
              for _ in range(2))
    table = torch.from_numpy(_table(rng, 2))
    q = torch.from_numpy(rng.randn(2, 1, H, D).astype(np.float32))
    if name == "ragged":
        pos = torch.tensor([SPAN - 1, 4 * SPAN + 3], dtype=torch.int32)

        def run():
            return rpa._ragged_ref(q, kp, vp, table, pos, 0.25)
    else:
        lens = torch.tensor([SPAN, 4 * SPAN + 4], dtype=torch.int32)

        def run():
            return pa._paged_ref(q, kp, vp, table, lens, 0.25)
    split = run()
    monkeypatch.setattr(rpa, "CHUNK_PAGES", MP)
    monkeypatch.setattr(pa, "CHUNK_PAGES", MP)
    whole = run()
    assert torch.equal(split[0], whole[0])
    np.testing.assert_allclose(split[1].numpy(), whole[1].numpy(),
                               atol=1e-5, rtol=0)
    assert not torch.equal(split[1], whole[1])
