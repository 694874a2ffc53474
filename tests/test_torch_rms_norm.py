"""The port's RMSNorm (paddle_tpu_torch.ops.layer_norm.fused_rms_norm,
`nn.functional.rms_norm`, `nn.RMSNorm`) against the JAX package: the
forward against `fused_rms_norm`, whose Pallas kernel runs in interpret
mode on the CPU, in f32 and bf16; input and weight gradients against
`jax.vjp` of `_rms_ref`; the shape rule that sends widths off the 128
grid, or fewer than 8 rows, to `_rms_ref`; the weight-less form; and the
refusal of `device=None` without a card.

Tolerances: f32 within 1e-5 (the same f32 mean of squares, summed in
another order; |y| <= ~5 here). bf16 outputs within one bf16 step at
|y| <= 8 (0.0625): both sides compute in f32 and round once, and an f32
result on a rounding boundary may round either way. Gradients (f32)
within 1e-4: dx sums 256 products per row, dw sums over 64 rows.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import layer_norm as JLN
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import layer_norm as LN

EPS = 1e-6


def _inputs(n, h, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h).astype(np.float32) * 2 + 0.5,
            rng.randn(h).astype(np.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 0.0625)])
def test_forward_matches_pallas_kernel(dtype, tol):
    x, w = _inputs(64, 256)
    want = np.asarray(JLN.fused_rms_norm(
        *(jnp.asarray(a).astype(dtype) for a in (x, w)), EPS)
        .astype(jnp.float32))
    td = getattr(torch, dtype)
    LN.reset_counts()
    got = LN.fused_rms_norm(*(torch.from_numpy(a).to(td) for a in (x, w)),
                            eps=EPS)
    assert got.dtype == td
    assert (LN.rms_plain_launches, LN.plain_launches) == (1, 0)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    assert torch.equal(got, LN._rms_kernel_ref(
        *(torch.from_numpy(a).to(td) for a in (x, w)), EPS))


def _jax_grads(x, w, g):
    _, vjp = jax.vjp(lambda a, c: JLN._rms_ref(a, c, EPS),
                     jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("entry", ["fused_rms_norm", "F.rms_norm",
                                   "nn.RMSNorm"])
def test_entry_points_forward_and_grads_match_jax(entry):
    """Each entry point against the JAX forward (interpret-mode kernel)
    and `jax.vjp` of `_rms_ref`, in f32; nn.RMSNorm with its weight set
    to w."""
    x, w = _inputs(64, 256, seed=1)
    g = np.random.RandomState(2).randn(64, 256).astype(np.float32)
    want = np.asarray(JLN.fused_rms_norm(jnp.asarray(x), jnp.asarray(w),
                                         EPS))
    want_dx, want_dw = _jax_grads(x, w, g)
    tx = torch.from_numpy(x).requires_grad_()
    if entry == "nn.RMSNorm":
        layer = nn.RMSNorm(256, epsilon=EPS, device="cpu")
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(w))
        tw = layer.weight
        y = layer(tx)
    else:
        tw = torch.from_numpy(w).requires_grad_()
        fn = LN.fused_rms_norm if entry == "fused_rms_norm" else F.rms_norm
        y = fn(tx, tw, EPS)
    np.testing.assert_allclose(y.detach().numpy(), want, atol=1e-5, rtol=0)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), want_dx, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), want_dw, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n,h", [(64, 200), (4, 256)])
def test_off_grid_shapes_take_rms_ref(n, h):
    """h % 128 != 0 or n < 8: `_rms_ref` (cast first, then scale), as the
    JAX `_rms_fwd_impl` routes them."""
    x, w = _inputs(n, h, seed=3)
    xb, wb = (torch.from_numpy(a).bfloat16() for a in (x, w))
    LN.reset_counts()
    got = LN.fused_rms_norm(xb, wb)
    assert LN.rms_plain_launches == 1
    want = JLN.fused_rms_norm(*(jnp.asarray(a).astype(jnp.bfloat16)
                                for a in (x, w)))
    assert torch.equal(got, LN._rms_ref(xb, wb, EPS))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=0.0625, rtol=0)


def test_weightless_form_matches_jax():
    """Without a weight, `F.rms_norm` is the plain form (no kernel), as
    in the JAX `F.rms_norm`."""
    x, _ = _inputs(16, 128, seed=4)
    want = JF.rms_norm(paddle.to_tensor(x), epsilon=EPS).numpy()
    LN.reset_counts()
    got = F.rms_norm(torch.from_numpy(x), epsilon=EPS)
    assert LN.rms_plain_launches == 0 and LN.rms_kernel_launches == 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_layer_weight_and_counts():
    """nn.RMSNorm's one parameter is `weight`, initialised to 1; its
    launches are counted apart from LayerNorm's."""
    layer = nn.RMSNorm(128, device="cpu")
    assert list(layer.state_dict()) == ["weight"]
    assert torch.equal(layer.weight, torch.ones(128))
    LN.reset_counts()
    layer(torch.randn(2, 8, 128))
    nn.LayerNorm(128, device="cpu")(torch.randn(2, 8, 128))
    assert (LN.rms_plain_launches, LN.plain_launches) == (1, 1)


def test_rms_norm_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None uses it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nn.RMSNorm(128)


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
        LN._rms_launch(x, w, EPS)
