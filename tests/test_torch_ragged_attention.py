"""The port's ragged paged attention (paddle_tpu_torch.ops) against the
JAX package: the plain PyTorch version must agree with the JAX jnp
reference (`use_kernel=False`) and with the JAX Pallas kernel run in
interpret mode, on the same numpy inputs, dense and packed, f32 and
bf16, with tables holding scratch and -1 entries and rows at start 0.

Tolerances: f32 within atol 1e-5 (both sides accumulate in f32; only
the summation order of the dots differs). bf16 outputs are compared in
f32 within one bf16 ulp of the larger magnitude plus the f32 allowance
1e-5: both sides compute in f32 from the same bf16 inputs and round once
at the end, so an f32 difference far below a bf16 ulp can still flip
that last rounding; near zero, where the output's terms cancel, the f32
difference is absolute and can exceed the ulp of the tiny result.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import ragged_paged_attention as jrpa
from paddle_tpu_torch.ops import ragged_paged_attention as rpa

H, D, P, PS, MP = 2, 16, 12, 4, 5
SCRATCH = P - 1


def _inputs(seed, n, W, d=D):
    rng = np.random.RandomState(seed)
    kp = rng.randn(P, PS, H, d).astype(np.float32)
    vp = rng.randn(P, PS, H, d).astype(np.float32)
    q = rng.randn(n, W, H, d).astype(np.float32)
    table = rng.randint(0, P - 1, (n, MP)).astype(np.int32)
    table[0, -1] = SCRATCH                   # unused tail -> scratch
    table[-1, -2:] = -1                      # -1 entries clamp to page 0
    start = rng.randint(0, MP * PS - W, n).astype(np.int32)
    start[0] = 0                             # a row at start 0
    return q, kp, vp, table, start


def _cast(dtype, *arrays):
    """numpy f32 -> (jax arrays, torch tensors) of `dtype`, both holding
    the same rounded values."""
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at |x|."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 1e-5
        assert (np.abs(got - want) <= tol).all(), \
            float(np.max(np.abs(got - want) - tol))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W", [1, 3, 8])
def test_dense_plain_matches_jax_reference_and_kernel(W, dtype):
    q, kp, vp, table, start = _inputs(W, n=3, W=W)
    (jq, jkp, jvp), (tq, tkp, tvp) = _cast(dtype, q, kp, vp)
    before = rpa.plain_launches
    got = rpa.ragged_paged_attention(tq, tkp, tvp, torch.from_numpy(table),
                                     torch.from_numpy(start))
    assert rpa.plain_launches == before + 1
    assert got.dtype == tq.dtype and got.shape == (3, W, H, D)
    got = got.float().numpy()
    ref = jrpa.ragged_paged_attention(jq, jkp, jvp, jnp.asarray(table),
                                      jnp.asarray(start))
    ker = jrpa.ragged_paged_attention(jq, jkp, jvp, jnp.asarray(table),
                                      jnp.asarray(start), use_kernel=True,
                                      interpret=True)
    _assert_close(got, ref.astype(jnp.float32), dtype)
    _assert_close(got, ker.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_plain_matches_jax_reference_and_kernel(dtype):
    """A packed stream mixing rows: row 1 contributes a 3-token chunk,
    rows 0 and 2 one decode token each, and one token names a row past
    the table (clamped into it, as the JAX gather clamps)."""
    q, kp, vp, table, _ = _inputs(11, n=3, W=1)
    rng = np.random.RandomState(12)
    qt = rng.randn(6, H, D).astype(np.float32)
    rows = np.asarray([1, 1, 1, 0, 2, 2], np.int32)
    pos = np.asarray([5, 6, 7, 0, 13, 19], np.int32)
    (jq, jkp, jvp), (tq, tkp, tvp) = _cast(dtype, qt, kp, vp)
    got = rpa.ragged_paged_attention_packed(
        tq, tkp, tvp, torch.from_numpy(table), torch.from_numpy(rows),
        torch.from_numpy(pos)).float().numpy()
    args = (jq, jkp, jvp, jnp.asarray(table), jnp.asarray(rows),
            jnp.asarray(pos))
    ref = jrpa.ragged_paged_attention_packed(*args)
    ker = jrpa.ragged_paged_attention_packed(*args, use_kernel=True,
                                             interpret=True)
    _assert_close(got, ref.astype(jnp.float32), dtype)
    _assert_close(got, ker.astype(jnp.float32), dtype)
    # a row id past the table reads the last row, like the JAX gather
    rows_past = rows.copy()
    rows_past[4] = 7
    clamped = rpa.ragged_paged_attention_packed(
        tq, tkp, tvp, torch.from_numpy(table), torch.from_numpy(rows_past),
        torch.from_numpy(pos)).float().numpy()
    np.testing.assert_array_equal(clamped, got)


@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA card: the kernel has no CPU mode")
def test_cuda_tensor_launches_kernel_never_plain():
    """On CUDA tensors the wrappers launch the hand-written kernel (or
    raise) and never take the plain version; the kernel agrees with the
    plain version (f32 within 1e-5) and a malformed operand raises.
    head_dim 32: the kernel takes head_dim 32/64/128/256."""
    q, kp, vp, table, start = _inputs(3, n=3, W=3, d=32)
    dev = torch.device("cuda")
    tq, tkp, tvp, ttab, tst = (torch.from_numpy(a).to(dev) for a in
                               (q, kp, vp, table, start))
    rpa.reset_counts()
    got = rpa.ragged_paged_attention(tq, tkp, tvp, ttab, tst)
    packed = rpa.ragged_paged_attention_packed(
        tq[:, 0].contiguous(), tkp, tvp, ttab,
        torch.arange(3, dtype=torch.int32, device=dev), tst)
    torch.cuda.synchronize()
    assert rpa.kernel_launches == 2 and rpa.plain_launches == 0
    want = rpa._ragged_ref(tq, tkp, tvp, ttab, tst, 1.0 / np.sqrt(32))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(packed, got[:, 0])
    with pytest.raises(TypeError):
        rpa.ragged_paged_attention(tq, tkp, tvp, ttab.long(), tst)
    assert rpa.plain_launches == 0
