"""The port's block-sparse attention (paddle_tpu_torch.ops.
block_sparse_attention and `nn.functional.sparse_attention`) against the
JAX package: the kernel's plain version against the Pallas kernel in
interpret mode and against `_dense_recompute`, per-head and shared
patterns with uneven counts (padded slots), an empty row, bf16; the
gradients against `jax.grad` through the JAX custom VJP; the CSR helpers
(`csr_to_block_layout` array-equal to JAX's, or None, `csr_element_mask`);
`F.sparse_attention` on the reference docstring's goldens and its routing
(a block-aligned mask-free CSR takes the kernel's wrapper, anything else
the dense path) against the JAX `F.sparse_attention`.

Tolerances: f32 within 2e-5 (the JAX tests' own: the same f32 online
softmax, summed in another order; the kernels scale q before the dot and
`_dense_recompute` the product). bf16 outputs within one bf16 step of
the JAX value (2^-7 relative; both sides compute in f32 from the same
bf16 inputs and round once) plus 2e-5. The reference goldens within
1e-5 relative (the JAX tests' tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import block_sparse_attention as jbsa
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import block_sparse_attention as bsa

TOL = 2e-5


def _random_layout(rng, G, nq, density=0.5, empty_row=None):
    mask = rng.rand(G, nq, nq) < density
    mask[:, :, 0] = True
    if empty_row is not None:
        mask[:, empty_row] = False
    counts = mask.sum(-1).astype(np.int32)
    cols = np.zeros((G, nq, max(1, int(counts.max()))), np.int32)
    for g in range(G):
        for r in range(nq):
            idx = np.nonzero(mask[g, r])[0]
            cols[g, r, :len(idx)] = idx
    return cols, counts


def _qkv(rng, B, H, L, D):
    return [rng.randn(B, H, L, D).astype(np.float32) for _ in range(3)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("G_mode", ["per_head", "shared"])
@pytest.mark.parametrize("bs", [8, 16])
def test_plain_forward_matches_pallas_kernel(G_mode, bs):
    B, H, L, D = 2, 3, 64, 16
    rng = np.random.RandomState(0)
    cols, counts = _random_layout(rng, B * H if G_mode == "per_head" else 1,
                                  L // bs, empty_row=1)
    assert (counts < cols.shape[-1]).any()        # padded slots exist
    q, k, v = _qkv(rng, B, H, L, D)
    want = np.asarray(jbsa.block_sparse_attention(
        *map(jnp.asarray, (q, k, v)), cols, counts, bs, interpret=True))
    golden = np.asarray(jbsa._dense_recompute(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(cols),
        jnp.asarray(counts), bs, 1.0 / np.sqrt(D)))
    bsa.reset_counts()
    got = bsa.block_sparse_attention(*_t(q, k, v), cols, counts, bs)
    assert (bsa.plain_launches, bsa.kernel_launches) == (1, 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), golden, rtol=TOL, atol=TOL)
    dense = bsa._dense_recompute(*_t(q, k, v), *_t(cols, counts), bs,
                                 1.0 / np.sqrt(D))
    np.testing.assert_allclose(dense.numpy(), golden, rtol=TOL, atol=TOL)


def test_empty_row_outputs_zero():
    B, H, L, D, bs = 1, 1, 32, 8, 8
    cols = np.zeros((1, L // bs, 1), np.int32)
    counts = np.ones((1, L // bs), np.int32)
    counts[0, 2] = 0
    q, k, v = _qkv(np.random.RandomState(1), B, H, L, D)
    want = np.asarray(jbsa.block_sparse_attention(
        *map(jnp.asarray, (q, k, v)), cols, counts, bs, interpret=True))
    got = bsa.block_sparse_attention(*_t(q, k, v), cols, counts, bs).numpy()
    assert np.all(got[:, :, 2 * bs:3 * bs] == 0) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    dense = bsa._dense_recompute(*_t(q, k, v), *_t(cols, counts), bs, 0.3)
    assert np.all(dense.numpy()[:, :, 2 * bs:3 * bs] == 0)


@pytest.mark.parametrize("G_mode", ["per_head", "shared"])
def test_grads_match_jax_custom_vjp(G_mode):
    B, H, L, D, bs = 1, 2, 32, 8, 8
    rng = np.random.RandomState(2)
    cols, counts = _random_layout(rng, B * H if G_mode == "per_head" else 1,
                                  L // bs)
    q, k, v = _qkv(rng, B, H, L, D)
    w = rng.randn(B, H, L, D).astype(np.float32)

    def loss(qq, kk, vv):
        out = jbsa.block_sparse_attention(qq, kk, vv, cols, counts, bs,
                                          interpret=True)
        return (out * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = bsa.block_sparse_attention(tq, tk, tv, cols, counts, bs)
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)


def test_bf16_matches_pallas_kernel():
    B, H, L, D, bs = 1, 2, 64, 16, 16
    rng = np.random.RandomState(3)
    cols, counts = _random_layout(rng, B * H, L // bs)
    q, k, v = _qkv(rng, B, H, L, D)
    want = np.asarray(jbsa.block_sparse_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), cols, counts,
        bs, interpret=True).astype(jnp.float32))
    got = bsa.block_sparse_attention(*(t.bfloat16() for t in _t(q, k, v)),
                                     cols, counts, bs)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= 2 ** -7 * np.abs(want) + TOL), err.max()


# ------------------------------------------------------------ CSR helpers

def _csr(dense):
    """Element CSR (offset [B, H, L+1], columns [B, H, nnz]) of a [B, H,
    L, L] bool pattern with the same nnz in every (b, h)."""
    B, H, L, _ = dense.shape
    offset = np.zeros((B, H, L + 1), np.int32)
    offset[..., 1:] = dense.sum(-1).cumsum(-1)
    cols = np.concatenate([np.nonzero(dense[b, h, r])[0]
                           for b in range(B) for h in range(H)
                           for r in range(L)]).astype(np.int32)
    return offset, cols.reshape(B, H, -1)


def _aligned(rng, B, H, L, bs):
    """A block-aligned BigBird-like pattern (global block 0, the diagonal
    and its right neighbour, random blocks on row 1): head h rolls its
    rows by h, so heads differ while every (b, h) keeps one nnz."""
    nb = L // bs
    bm = np.zeros((nb, nb), bool)
    for i in range(nb):
        bm[i, i] = bm[i, 0] = bm[i, (i + 1) % nb] = True
    bm[1] |= rng.rand(nb) < 0.3
    heads = np.stack([np.roll(bm, h, axis=0) for h in range(H)])
    bm = np.tile(heads, (B, 1, 1))                      # g = b*H + h
    return np.kron(bm, np.ones((bs, bs), bool)).reshape(B, H, L, L)


@pytest.mark.parametrize("bs", [8, 16, 32])
def test_csr_to_block_layout_equals_jax(bs):
    rng = np.random.RandomState(4)
    dense = _aligned(rng, 2, 2, 128, bs)
    offset, columns = _csr(dense)
    want = jbsa.csr_to_block_layout(offset, columns, 128)
    got = bsa.csr_to_block_layout(offset, columns, 128)
    assert got[0] == want[0] == bs
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_csr_to_block_layout_unaligned_is_none():
    _, offset, columns = _ref_example()
    offset = offset.copy()
    columns = columns.copy()
    columns[0, 0, 1] = 2            # row 0 now holds columns 0 and 2
    assert jbsa.csr_to_block_layout(offset, columns, 4) is None
    assert bsa.csr_to_block_layout(offset, columns, 4) is None
    # the reference example itself is aligned at no block size >= 8
    _, offset, columns = _ref_example()
    assert bsa.csr_to_block_layout(offset, columns, 4) is None


@pytest.mark.parametrize("bad", ["falling", "past_nnz"])
def test_csr_to_block_layout_refuses_malformed_offsets(bad):
    _, offset, columns = _ref_example()
    offset = offset.copy()
    if bad == "falling":
        offset[0, 0, 2] = 1                  # row 1 would end before it starts
    else:
        offset[0, 0, -1] = 9                 # one entry past the columns
    with pytest.raises(ValueError, match="sparse_csr_offset"):
        bsa.csr_to_block_layout(offset, columns, 4)


def test_csr_element_mask_equals_jax():
    rng = np.random.RandomState(5)
    head = rng.rand(16, 16) < 0.3
    head[:, 0] = True
    dense = np.stack([head, np.roll(head, 3, axis=0)])[None]   # one nnz
    offset, columns = _csr(dense)
    want = np.asarray(jbsa.csr_element_mask(offset, columns, 16))
    got = bsa.csr_element_mask(*_t(offset, columns), 16).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, dense)


# ----------------------------------------------------- F.sparse_attention

def _ref_example():
    q = np.array([[[[0, 1], [2, 3], [0, 1], [2, 3]]]], "float32")
    offset = np.array([[[0, 2, 4, 6, 8]]], "int32")
    columns = np.array([[[0, 1, 0, 1, 2, 3, 2, 3]]], "int32")
    return q, offset, columns


def test_sparse_attention_reference_example():
    q, offset, columns = _ref_example()
    t = torch.from_numpy(q)
    out = F.sparse_attention(t, t, t, torch.from_numpy(offset),
                             torch.from_numpy(columns))
    golden = np.array([[[[1.60885942, 2.60885954],
                         [1.99830270, 2.99830270],
                         [1.60885942, 2.60885954],
                         [1.99830270, 2.99830270]]]], "float32")
    np.testing.assert_allclose(out.numpy(), golden, rtol=1e-5)


def test_sparse_attention_reference_example_masked():
    q, offset, columns = _ref_example()
    kpm = np.array([[1, 1, 1, 0]], "float32")
    am = np.array([[1, 0, 1, 1], [1, 1, 1, 1],
                   [1, 1, 1, 1], [1, 1, 1, 1]], "float32")
    t = torch.from_numpy(q)
    out = F.sparse_attention(t, t, t, offset, columns,
                             key_padding_mask=torch.from_numpy(kpm),
                             attn_mask=torch.from_numpy(am))
    golden = np.array([[[[0.0, 1.0],
                         [1.99830270, 2.99830270],
                         [0.0, 1.0],
                         [0.0, 1.0]]]], "float32")
    np.testing.assert_allclose(out.numpy(), golden, rtol=1e-5, atol=1e-6)


def _jax_sparse(q, offset, columns, **masks):
    j = paddle.to_tensor
    return JF.sparse_attention(j(q), j(q), j(q), j(offset), j(columns),
                               **{k: j(v) for k, v in masks.items()}).numpy()


def test_block_aligned_csr_takes_the_kernel_and_caches_its_layout():
    B, H, L, D = 1, 2, 32, 8
    rng = np.random.RandomState(6)
    offset, columns = _csr(_aligned(rng, B, H, L, 8))
    q = rng.randn(B, H, L, D).astype(np.float32)
    want = _jax_sparse(q, offset, columns)
    F._cached_block_layout.cache_clear()
    bsa.reset_counts()
    tq = torch.from_numpy(q).requires_grad_()
    out = F.sparse_attention(tq, tq, tq, offset, columns)
    assert bsa.plain_launches == 1
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=TOL,
                               atol=TOL)
    out.sum().backward()
    assert torch.isfinite(tq.grad).all()
    F.sparse_attention(tq, tq, tq, offset, columns)
    assert F._cached_block_layout.cache_info().hits == 1
    assert bsa.plain_launches == 2


@pytest.mark.parametrize("case", ["unaligned", "key_padding_mask"])
def test_other_csr_takes_the_dense_path(case):
    B, H, L, D = 1, 2, 32, 8
    rng = np.random.RandomState(7)
    dense = _aligned(rng, B, H, L, 8)
    masks = {}
    if case == "unaligned":
        dense[:, :, 3, 20] = True              # one element off the grid
    else:
        masks["key_padding_mask"] = (rng.rand(B, L) < 0.8).astype("float32")
    offset, columns = _csr(dense)
    q = rng.randn(B, H, L, D).astype(np.float32)
    want = _jax_sparse(q, offset, columns, **masks)
    bsa.reset_counts()
    t = torch.from_numpy(q)
    got = F.sparse_attention(t, t, t, torch.from_numpy(offset),
                             torch.from_numpy(columns),
                             **{k: torch.from_numpy(v)
                                for k, v in masks.items()})
    assert (bsa.plain_launches, bsa.kernel_launches) == (0, 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
