"""The port's fused LayerNorm (paddle_tpu_torch.ops.layer_norm) against
the JAX package: the forward against `fused_layer_norm_op`, whose Pallas
kernel runs in interpret mode on the CPU, in f32 and bf16; the backward
against `jax.vjp` of `_ln_ref`; and the shape rule that sends widths off
the 128 grid, or fewer than 8 rows, to `_ln_ref`.

Tolerances: f32 within 1e-5 (the same f32 statistics, summed in another
order; |y| <= ~4 here). bf16 outputs within one bf16 step at |y| <= 8
(0.0625): both sides compute in f32 and round once, and an f32 result
that sits on a rounding boundary may round either way. Gradients (f32)
within 1e-4: dx sums 256 products per row.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import layer_norm as JLN
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import layer_norm as LN


def _inputs(n, h, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h).astype(np.float32) * 2 + 0.5,
            rng.randn(h).astype(np.float32),
            rng.randn(h).astype(np.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 0.0625)])
def test_forward_matches_pallas_kernel(dtype, tol):
    x, w, b = _inputs(64, 256)
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    want = np.asarray(JLN.fused_layer_norm_op(jx, jw, jb, eps=1e-5)
                      ._value.astype(jnp.float32))
    td = getattr(torch, dtype)
    LN.reset_counts()
    got = LN.fused_layer_norm(*(torch.from_numpy(a).to(td)
                                for a in (x, w, b)), eps=1e-5)
    assert got.dtype == td and LN.plain_launches == 1
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_backward_matches_vjp_of_ln_ref():
    x, w, b = _inputs(32, 256, seed=1)
    g = np.random.RandomState(2).randn(32, 256).astype(np.float32)
    _, vjp = jax.vjp(lambda a, c, d: JLN._ln_ref(a, c, d, 1e-5),
                     *map(jnp.asarray, (x, w, b)))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    LN.fused_layer_norm(*ts, eps=1e-5).backward(torch.from_numpy(g))
    for t, wv in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wv),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("n,h", [(64, 200), (4, 256)])
def test_off_grid_shapes_take_ln_ref(n, h):
    """h % 128 != 0 or n < 8: `_ln_ref` (cast first, then scale), as the
    JAX `_ln_fwd_impl` routes them."""
    x, w, b = _inputs(n, h, seed=3)
    xb, wb, bb = (torch.from_numpy(a).bfloat16() for a in (x, w, b))
    got = LN.fused_layer_norm(xb, wb, bb)
    want = JLN.fused_layer_norm(*(jnp.asarray(a).astype(jnp.bfloat16)
                                  for a in (x, w, b)))
    assert torch.equal(got, LN._ln_ref(xb, wb, bb, 1e-5))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=0.0625, rtol=0)


def test_functional_routes_affine_to_fused_op():
    x, w, b = (torch.from_numpy(a) for a in _inputs(16, 128, seed=4))
    LN.reset_counts()
    y = F.layer_norm(x, 128, w, b)
    assert LN.plain_launches == 1
    torch.testing.assert_close(y, LN._ln_kernel_ref(x, w, b, 1e-5))
    y2 = F.layer_norm(x, [128])               # no affine: the plain form
    assert LN.plain_launches == 1
    torch.testing.assert_close(y2, LN._stats(x, 1e-5))


@pytest.mark.parametrize("bad,err", [
    (dict(x_dtype=torch.float16), TypeError),
    (dict(w_shape=(64,)), ValueError),
    (dict(h=16384), ValueError),
])
def test_kernel_operand_checks(bad, err):
    """The CUDA wrapper checks its operands before any launch."""
    h = bad.get("h", 128)
    x = torch.zeros(8, h, dtype=bad.get("x_dtype", torch.float32))
    w = torch.ones(bad.get("w_shape", (h,)))
    with pytest.raises(err):
        LN._launch(x, w, torch.zeros_like(w), 1e-5)
