"""The port's legacy paged KV cache and paged decode attention
(paddle_tpu_torch.ops.paged_attention) against the JAX package: the
scenario of `tests/test_pallas_kernels.py::test_paged_attention_matches_
dense` run through both packages' `PagedKVCache` (equal page tables and
batch views, -1 table entries included), the output of the kernel's plain
version (`use_kernel=True` on CPU tensors) and of the jnp reference
(`use_kernel=False`) against the JAX reference and the JAX Pallas kernel
in interpret mode; free-list order on free and reuse; running out of
pages; seq_len 0 (the uniform mean of V over every gathered slot, as in
JAX); bf16 pools.

Tolerances: f32 within 1e-5 (the JAX test's own: the same f32 softmax,
summed in another order; the kernels scale q before the dot and the
references the product). bf16 within one bf16 step (2^-7 relative; both
sides compute in f32 from the same bf16 pages and round once) plus 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as pa

TOL = 1e-5


def _fill(lens, H, D, P, num_pages=16, dtype="float32", seed=0):
    """Both packages' caches with the same appends, seq id i of length
    lens[i]; returns (jax cache, port cache, rng)."""
    rng = np.random.RandomState(seed)
    jc = jpa.PagedKVCache(num_pages, P, H, D, dtype=getattr(jnp, dtype))
    tc = pa.PagedKVCache(num_pages, P, H, D, dtype=getattr(torch, dtype),
                         device="cpu")
    for sid, L in enumerate(lens):
        jc.new_seq(sid)
        tc.new_seq(sid)
        for _ in range(L):
            k = rng.randn(1, H, D).astype(np.float32)
            v = rng.randn(1, H, D).astype(np.float32)
            jc.append(sid, k, v)
            tc.append(sid, k, v)
    return jc, tc, rng


def _same_cache(jc, tc):
    assert jc.page_tables == tc.page_tables and jc.seq_lens == tc.seq_lens
    assert jc._free == tc._free
    for a, b in ((jc.k_pages, tc.k_pages), (jc.v_pages, tc.v_pages)):
        assert np.array_equal(np.asarray(a.astype(jnp.float32)),
                              b.float().numpy())


def _outputs(jc, tc, seq_ids, q):
    """(JAX reference, JAX kernel in interpret mode) and the port's
    (plain kernel version, jnp-style reference) on the same batch."""
    jt, jl = jc.batch_view(seq_ids)
    tt, tl = tc.batch_view(seq_ids)
    assert tt.dtype == tl.dtype == torch.int32
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    jq = jnp.asarray(q, jc.k_pages.dtype)
    want = [np.asarray(jpa.paged_attention(
        jq, jc.k_pages, jc.v_pages, jt, jl, use_kernel=uk,
        interpret=True).astype(jnp.float32)) for uk in (False, True)]
    tq = torch.from_numpy(q).to(tc.k_pages.dtype)
    pa.reset_counts()
    got = [pa.paged_attention(tq, tc.k_pages, tc.v_pages, tt, tl,
                              use_kernel=uk).float().numpy()
           for uk in (True, False)]
    assert (pa.plain_launches, pa.kernel_launches) == (2, 0)
    return want, got


def test_scenario_matches_jax_ref_and_kernel():
    """tests/test_pallas_kernels.py:169-199: two sequences of 6 and 3
    tokens in pages of 4 (the second's table row ends in -1), and the
    dense attention over each sequence's own history."""
    H, D, P = 2, 64, 4
    jc, tc, rng = _fill([6, 3], H, D, P)
    _same_cache(jc, tc)
    q = rng.randn(2, 1, H, D).astype(np.float32)
    want, got = _outputs(jc, tc, [0, 1], q)
    assert (np.asarray(jc.batch_view([0, 1])[0]) == -1).any()
    for w in want:
        for g in got:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    k = tc.k_pages.float().numpy()
    v = tc.v_pages.float().numpy()
    for b, L in enumerate([6, 3]):
        ids = tc.page_tables[b]
        ks = k[ids].reshape(-1, H, D)[:L]
        vs = v[ids].reshape(-1, H, D)[:L]
        s = np.einsum("hd,lhd->hl", q[b, 0], ks) / np.sqrt(D)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        np.testing.assert_allclose(got[0][b, 0],
                                   np.einsum("hl,lhd->hd", p, vs), atol=TOL)


@pytest.mark.parametrize("D", [8, 16, 128])
def test_seq_len_zero_is_uniform_mean_as_in_jax(D):
    """A sequence with no tokens: every logit is -1e30, so JAX's kernel
    and reference return the mean of V over every gathered slot (its
    one-slot table row reads page 0); the port returns the same."""
    H, P = 2, 4
    jc, tc, rng = _fill([5, 0, 9], H, D, P)
    q = rng.randn(3, 1, H, D).astype(np.float32)
    want, got = _outputs(jc, tc, [0, 1, 2], q)
    v = tc.v_pages.float().numpy()
    table = tc.batch_view([0, 1, 2])[0].numpy()
    mean = v[np.maximum(table[1], 0)].reshape(-1, H, D).mean(0)
    for w in want:
        for g in got:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    np.testing.assert_allclose(got[0][1, 0], mean, atol=TOL)


def test_free_and_reuse_order_matches_jax():
    H, D, P = 1, 8, 2
    jc, tc, rng = _fill([5, 3, 4], H, D, P, num_pages=8)
    _same_cache(jc, tc)
    for c in (jc, tc):
        c.free_seq(0)
        c.free_seq(7)             # unknown ids are ignored
        c.new_seq(3)
    for _ in range(4):
        k, v = (rng.randn(1, H, D).astype(np.float32) for _ in range(2))
        jc.append(3, k, v)
        tc.append(3, k, v)
    _same_cache(jc, tc)
    assert tc.page_tables[3] == [0, 1]      # freed pages come back first


def test_out_of_pages_raises_like_jax():
    for c in (jpa.PagedKVCache(2, 2, 1, 4, dtype=jnp.float32),
              pa.PagedKVCache(2, 2, 1, 4, dtype=torch.float32,
                              device="cpu")):
        c.new_seq(0)
        for _ in range(4):
            c.append(0, np.ones((1, 1, 4), np.float32),
                     np.ones((1, 1, 4), np.float32))
        with pytest.raises(RuntimeError, match="out of pages"):
            c.append(0, np.ones((1, 1, 4), np.float32),
                     np.ones((1, 1, 4), np.float32))


def test_bf16_pool_matches_jax():
    H, D, P = 2, 64, 4
    jc, tc, rng = _fill([6, 3, 11], H, D, P, dtype="bfloat16")
    _same_cache(jc, tc)
    q = rng.randn(3, 1, H, D).astype(np.float32)
    want, got = _outputs(jc, tc, [0, 1, 2], q)
    for w in want:
        for g in got:
            assert np.all(np.abs(g - w) <= 2 ** -7 * np.abs(w) + TOL)


def test_cuda_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None uses it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pa.PagedKVCache(4, 2, 1, 8)
