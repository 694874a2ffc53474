"""LayerNorm's backward in the port (paddle_tpu_torch.ops.layer_norm): the
kernel's plain version `_ln_bwd_kernel_ref`, which the CPU runs, against
`jax.vjp` of the JAX `_ln_ref` (the JAX `_ln_bwd`) and against autograd of
the port's `_ln_ref` (the route it replaces); the mean and rstd the
forward saves; the control that the card's check must reject; and the
launch counts.

Tolerances:
- f32 against JAX: 1e-5 (atol and rtol; the same f32 sums in another
  order). bf16 weights there: dw and db within one bf16 step + 1e-5 (an
  f32 sum cast to bf16 on both sides).
- bf16 dx against JAX: one bf16 step of JAX's value (both round an f32 dx
  whose sums ran in another order).
- bf16 dw and db against JAX: 2^-6 of the column's sum of |terms|. This
  is a quirk of the reference, not of the port: XLA's CPU vjp transposes
  the broadcast of w and b into a bf16 `reduce_sum`, which strays from the
  exact sum of the same bf16 terms by up to ~0.6% of that sum of |terms|
  over 64 rows (0.25-0.34 at |dw| ~ 8-19 here), while the port sums in
  f32 and rounds once. So the port's dw and db are also held within one
  bf16 step of a float64 sum of the same rounded terms.
- The plain version against autograd of the port's `_ln_ref`: f32 1e-6
  (atol and rtol), bf16 `testing.check_ln_bwd` (one step of the rounding
  dtype, bits equal but for LN_BWD_FLIP of the elements).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import layer_norm as JLN
from paddle_tpu_torch import testing as T
from paddle_tpu_torch.ops import layer_norm as LN

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(n, h, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h).astype(np.float32) * 2 + 0.5,
            rng.randn(h).astype(np.float32),
            rng.randn(h).astype(np.float32),
            rng.randn(n, h).astype(np.float32))


def _jax_vjp(x, w, b, g, eps, dtype, wdtype):
    args = [jnp.asarray(a).astype(d) for a, d in
            ((x, dtype), (w, wdtype), (b, wdtype))]
    _, vjp = jax.vjp(lambda a, c, d: JLN._ln_ref(a, c, d, eps), *args)
    return [np.asarray(t.astype(jnp.float32))
            for t in vjp(jnp.asarray(g).astype(dtype))]


def _plain(x, w, b, g, eps, dtype, wdtype):
    """The port's plain backward from the plain forward's saved stats."""
    tx, tg = (torch.from_numpy(a).to(_DT[dtype]) for a in (x, g))
    tw, tb = (torch.from_numpy(a).to(_DT[wdtype]) for a in (w, b))
    _, mean, rstd = LN._ln_fwd_ref(tx, tw, tb, eps)
    return (tx, tg, tw, tb, mean, rstd), LN._ln_bwd_kernel_ref(
        tx, tg, tw, mean, rstd)


def _bf16_step(a):
    a = np.abs(a.astype(np.float64)).clip(2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("h", [128, 768, 2048])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_f32_plain_backward_matches_jax_vjp(h, eps, wdtype):
    x, w, b, g = _inputs(48, h, seed=h)
    want = _jax_vjp(x, w, b, g, eps, "float32", wdtype)
    _, got = _plain(x, w, b, g, eps, "float32", wdtype)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5,
                               rtol=1e-5)
    for t, wv in zip(got[1:], want[1:]):
        assert t.dtype == _DT[wdtype]
        tol = 1e-5 + (_bf16_step(wv) if wdtype == "bfloat16" else 1e-5
                      * np.abs(wv))
        assert (np.abs(t.float().numpy() - wv) <= tol).all()


@pytest.mark.parametrize("h", [768, 2048])
def test_bf16_plain_backward_against_jax_vjp(h):
    x, w, b, g = _inputs(64, h, seed=h + 1)
    want = _jax_vjp(x, w, b, g, 1e-5, "bfloat16", "bfloat16")
    (tx, tg, tw, _, mean, rstd), got = _plain(x, w, b, g, 1e-5, "bfloat16",
                                              "bfloat16")
    dx = got[0].float().numpy()
    assert (np.abs(dx - want[0]) <= _bf16_step(want[0])).all()
    xhat = (tx.float() - mean[:, None]) * rstd[:, None]
    terms = ((tg * xhat.bfloat16()).float(), tg.float())
    for t, wv, term in zip(got[1:], want[1:], terms):
        mag = term.abs().sum(0).numpy()
        assert (np.abs(t.float().numpy() - wv) <= 2.0 ** -6 * mag).all()
        exact = term.double().sum(0).numpy()
        assert (np.abs(t.double().numpy() - exact)
                <= _bf16_step(exact)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h", [(64, 768), (37, 2048), (8, 128)])
def test_plain_backward_matches_autograd_of_ln_ref(dtype, wdtype, n, h):
    """The plain version against the route it replaces, autograd of the
    port's `_ln_ref`, on the same inputs."""
    x, w, b, g = _inputs(n, h, seed=n + h)
    (tx, tg, tw, tb, mean, rstd), got = _plain(x, w, b, g, 1e-5, dtype,
                                               wdtype)
    with torch.enable_grad():
        xs, ws, bs = (t.detach().requires_grad_() for t in (tx, tw, tb))
        want = torch.autograd.grad(LN._ln_ref(xs, ws, bs, 1e-5),
                                   (xs, ws, bs), tg)
    if dtype == "float32":
        for t, wv in zip(got, want):
            assert t.dtype == wv.dtype
            torch.testing.assert_close(t, wv, atol=1e-6, rtol=1e-6)
    T.check_ln_bwd("autograd of _ln_ref", want, tx, tg, tw, mean, rstd)


@pytest.mark.parametrize("n,h", [(64, 768), (8, 128)])
def test_control_is_rejected(n, h):
    """dw from f32 xhat (c(xhat) skipped) fails the card's check in bf16,
    while the plain version passes it."""
    x, w, b, g = _inputs(n, h, seed=5)
    (tx, tg, tw, _, mean, rstd), got = _plain(x, w, b, g, 1e-5, "bfloat16",
                                              "bfloat16")
    assert T.check_ln_bwd("plain", got, tx, tg, tw, mean, rstd) == (0.0,
                                                                     0.0)
    with pytest.raises(AssertionError, match="dw"):
        T.check_ln_bwd("control", T.ln_bwd_control(tx, tg, tw, mean, rstd),
                       tx, tg, tw, mean, rstd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_saved_mean_and_rstd_match_stats(dtype):
    x, w, b, _ = _inputs(24, 256, seed=6)
    tx = torch.from_numpy(x).to(_DT[dtype]).reshape(2, 12, 256)
    tx.requires_grad_()
    y = LN.fused_layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b),
                            eps=1e-12)
    sx, _, mean, rstd = y.grad_fn.saved_tensors
    assert sx is tx or torch.equal(sx, tx)
    assert mean.shape == rstd.shape == (24,)
    assert mean.dtype == rstd.dtype == torch.float32
    xhat = (tx.detach().float() - mean.reshape(2, 12, 1)) * rstd.reshape(
        2, 12, 1)
    assert torch.equal(xhat, LN._stats(tx.detach(), 1e-12))
    assert torch.equal(mean, tx.detach().float().mean(-1).reshape(-1))


def test_cpu_backward_counts_as_plain_and_matches_plain_version():
    x, w, b, g = _inputs(32, 256, seed=7)
    tx, tw, tb = (torch.from_numpy(a).bfloat16().requires_grad_()
                  for a in (x, w, b))
    tg = torch.from_numpy(g).bfloat16()
    LN.reset_counts()
    LN.fused_layer_norm(tx, tw, tb).backward(tg)
    assert (LN.plain_launches, LN.bwd_plain_launches) == (1, 1)
    assert (LN.kernel_launches, LN.bwd_kernel_launches) == (0, 0)
    _, mean, rstd = LN._ln_fwd_ref(tx.detach(), tw.detach(), tb.detach(),
                                   1e-5)
    want = LN._ln_bwd_kernel_ref(tx.detach(), tg, tw.detach(), mean, rstd)
    for t, wv in zip((tx.grad, tw.grad, tb.grad), want):
        assert torch.equal(t, wv)
    LN.reset_counts()
    off = torch.from_numpy(x[:, :200]).requires_grad_()
    LN.fused_layer_norm(off, torch.ones(200), torch.zeros(200)).sum() \
        .backward()
    assert (LN.plain_launches, LN.bwd_plain_launches) == (1, 1)


@pytest.mark.parametrize("bad,err", [
    (dict(x_dtype=torch.float16), TypeError),
    (dict(g_shape=(8, 64)), ValueError),
    (dict(h=16384), ValueError),
])
def test_backward_kernel_operand_checks(bad, err):
    """The CUDA wrapper checks its operands before any launch."""
    h = bad.get("h", 128)
    x = torch.zeros(8, h, dtype=bad.get("x_dtype", torch.float32))
    g = torch.zeros(bad.get("g_shape", (8, h)), dtype=x.dtype)
    stats = torch.zeros(8)
    with pytest.raises(err):
        LN._bwd_launch(x, g, torch.ones(h), stats, stats)
