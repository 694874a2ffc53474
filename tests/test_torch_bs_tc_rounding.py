"""The rounding points of the port's bf16 tensor-core block-sparse body
(`bsa_fwd_tc_kernel` in paddle_tpu_torch/ops/csrc/block_sparse_attention.cu),
written out in plain torch by `paddle_tpu_torch.testing.bs_tc_walk`, held on
the CPU against the JAX package.

The body computes s = (q.k) * scale on the stored bf16 values (the scale
on the f32 score), steps the f32 online softmax once per key tile of
min(bs, 64) keys with l summing the unrounded p, and forms P.V as p_hi.V
+ p_lo.V with p_hi = bf16(p) and p_lo = bf16(p - p_hi), both summed in
f32; out = acc / max(l, 1e-30) is rounded once to bf16.

- Against `block_sparse_attention(interpret=True)` of the JAX package on
  the same bf16 inputs (its Pallas kernel: q * scale before the dot, one
  f32 step per block, p in f32, out rounded once): within one bf16 step
  of |out| (2^-7 relative) plus 2e-5, the allowance of
  tests/test_torch_block_sparse_attention.py's bf16 test. Per-head and
  shared layouts, block sizes 16-128, head_dim 64 and 128, a count-0 row
  and padded slots in every layout.
- A control: the same walk with p rounded to bf16 alone before P.V (the
  flash forward's recipe) falls outside that allowance on the same
  inputs. Where out is near 0 its terms cancel, and p's rounding (2^-9
  of p) moves it by many allowances; the split carries ~16 bits of p.
- In f32 (no bf16 rounding of the inputs or of out) the walk agrees with
  the plain version `_bs_fwd_ref` within 1e-5: the two differ only in
  the place of the scale, the key tiling and the order of f32 sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import block_sparse_attention as jbsa
from paddle_tpu_torch.ops import block_sparse_attention as bsa
from paddle_tpu_torch.testing import bs_tc_walk

TOL = 2e-5


def _layout(rng, G, nq):
    """Blocked CSR with uneven counts: row 1 of every pattern empty, and
    a padded slot past each row's count holding an arbitrary id."""
    mask = rng.rand(G, nq, nq) < 0.4
    mask[:, :, 0] = True
    mask[:, min(1, nq - 1)] = False
    counts = mask.sum(-1).astype(np.int32)
    cols = rng.randint(0, nq, (G, nq, int(counts.max()) + 1)).astype(np.int32)
    for g in range(G):
        for r in range(nq):
            idx = np.nonzero(mask[g, r])[0]
            cols[g, r, :len(idx)] = idx
    return cols, counts


def _case(bs, D, layout, seed):
    B, H = 1, 2
    L = max(2 * bs, 128)
    rng = np.random.RandomState(seed)
    cols, counts = _layout(rng, B * H if layout == "per_head" else 1, L // bs)
    q, k, v = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(3))
    return (q, k, v), cols, counts


def _jax_bf16(qkv, cols, counts, bs):
    return np.asarray(jbsa.block_sparse_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in qkv), cols, counts, bs,
        interpret=True).astype(jnp.float32))


def _walk_bf16(qkv, cols, counts, bs, p_split=True):
    q, k, v = (torch.from_numpy(a).bfloat16() for a in qkv)
    out = bs_tc_walk(q, k, v, torch.from_numpy(cols),
                          torch.from_numpy(counts), bs,
                          1.0 / np.sqrt(q.shape[-1]), p_split=p_split)
    return out.to(torch.bfloat16).float().numpy()


def _over(got, want):
    """Elements beyond one bf16 step of |want| plus TOL, and the largest
    error over that allowance."""
    err = np.abs(got - want)
    allow = 2 ** -7 * np.abs(want) + TOL
    return int((err > allow).sum()), float((err / allow).max())


@pytest.mark.parametrize("layout", ["per_head", "shared"])
@pytest.mark.parametrize("bs,D", [(16, 64), (32, 64), (64, 128), (128, 64)])
def test_tc_walk_matches_pallas_kernel(bs, D, layout):
    qkv, cols, counts = _case(bs, D, layout, seed=bs + D)
    assert (counts == 0).any() and (counts < cols.shape[-1]).all()
    want = _jax_bf16(qkv, cols, counts, bs)
    got = _walk_bf16(qkv, cols, counts, bs)
    n_over, worst = _over(got, want)
    assert n_over == 0, (n_over, worst)
    L = qkv[0].shape[2]
    nq = L // bs
    empty = np.repeat(counts.reshape(-1, nq) == 0, bs, axis=-1)  # [G, L]
    assert (got[0][np.broadcast_to(empty, (2, L))] == 0).all()


@pytest.mark.parametrize("bs,D", [(16, 64), (128, 128)])
def test_p_rounded_alone_is_rejected(bs, D):
    """The control: p rounded to bf16 alone before P.V leaves the
    allowance that the split walk keeps on the same inputs."""
    qkv, cols, counts = _case(bs, D, "per_head", seed=7 + bs)
    want = _jax_bf16(qkv, cols, counts, bs)
    n_split, _ = _over(_walk_bf16(qkv, cols, counts, bs), want)
    n_alone, worst = _over(_walk_bf16(qkv, cols, counts, bs, p_split=False),
                           want)
    assert n_split == 0
    assert n_alone > 0 and worst > 2.0, (n_alone, worst)


@pytest.mark.parametrize("layout", ["per_head", "shared"])
@pytest.mark.parametrize("bs", [16, 128])
def test_tc_walk_f32_matches_plain_version(bs, layout):
    qkv, cols, counts = _case(bs, 64, layout, seed=3 * bs)
    q, k, v = (torch.from_numpy(a) for a in qkv)
    args = (torch.from_numpy(cols), torch.from_numpy(counts), bs, 0.125)
    want = bsa._bs_fwd_ref(q, k, v, *args)
    got = bs_tc_walk(q, k, v, *args)
    # in f32 the hi + lo split carries p to ~2^-17: the walks agree to f32
    # noise of the sums
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
