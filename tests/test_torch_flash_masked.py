"""The mask and dropout branches of the port's flash attention
(paddle_tpu_torch.ops.attention) against the JAX package on the CPU: the
plain forward and backward with a per-key bias (kvb, per batch and
broadcast), a full bias (fb, per batch and head, GQA included), bool
masks, causal + kvb, hash dropout (forward and backward) and a ragged
length, held against the Pallas kernels in interpret mode
(`_fwd_lse_impl` / `_bwd_impl`, or the public `flash_attention`, which
runs them) and against `mha_reference` / `jax.vjp`; the dropout hash and
`_keep_tile` bit for bit; `_normalize_mask`'s kvb/fb split for each
broadcast shape; and `F.scaled_dot_product_attention`'s routing of mask
and dropout.

Tolerances are the JAX package's own kernel tests' (tests/
test_flash_masked.py): forward within 2e-5; gradients within atol 3e-4 /
rtol 2e-3, and 5e-4 / 3e-3 with dropout (inputs ~0.3, cotangents ~1;
both sides sum the same f32 products in other tile orders). Keep-masks
and the bias split are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import attention as JA
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import attention as A

OUT_TOL = 2e-5
GRAD_TOL = dict(atol=3e-4, rtol=2e-3)
DROP_GRAD_TOL = dict(atol=5e-4, rtol=3e-3)
_D = jnp.zeros((1, 1), jnp.float32)


def _mk(B=2, Lq=256, Lk=256, Hq=2, Hkv=2, D=64, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, Lq, Hq, D) * 0.3).astype(np.float32)
    k = (rng.randn(B, Lk, Hkv, D) * 0.3).astype(np.float32)
    v = (rng.randn(B, Lk, Hkv, D) * 0.3).astype(np.float32)
    g = rng.randn(B, Lq, Hq, D).astype(np.float32)
    return q, k, v, g


def _cfg(causal, scale, rate=0.0, has_kvb=False, kvb_b=False, has_fb=False,
         fb_b=False, fb_h=False):
    return (causal, scale, rate, has_kvb, kvb_b, has_fb, fb_b, fb_h)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _close(got, want, **tol):
    tol = tol or dict(atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _plain(q, k, v, g, causal, sc, ex):
    """The port's plain forward and backward: (out, lse, dq, dk, dv)."""
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = A._fwd_ref(tq, tk, tv, causal, sc, ex)
    delta = (tg * out).sum(-1).transpose(1, 2).contiguous()
    return (out, lse) + A._bwd_ref(tq, tk, tv, tg, lse, delta, causal, sc,
                                   ex)


def _pallas(q, k, v, g, kvb, fb, seed, cfg):
    """The JAX kernels in interpret mode: (out, lse, dq, dk, dv)."""
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = JA._fwd_lse_impl(jq, jk, jv, kvb, fb, seed, cfg,
                                interpret=True)
    return (out, lse) + tuple(JA._bwd_impl(jq, jk, jv, lse, jg, out, kvb, fb,
                                           seed, cfg, interpret=True))


def _check_all(got, want, B, Hq, Lq, grad_tol):
    _close(got[0], want[0])
    _close(got[1], np.asarray(want[1]).reshape(B, Hq, Lq))
    for a, b in zip(got[2:], want[2:]):
        _close(a, b, **grad_tol)


@pytest.mark.parametrize("causal,per_batch", [(False, True), (True, True),
                                              (False, False)])
def test_kvb_matches_pallas_interpret(causal, per_batch):
    q, k, v, g = _mk()
    sc = 0.125
    kvb = np.zeros((2 if per_batch else 1, 256), np.float32)
    kvb[0, 192:] = -1e4                       # BERT's padding bias
    if per_batch:
        kvb[1, 150:] = -1e30
    want = _pallas(q, k, v, g, jnp.asarray(kvb), _D, _D,
                   _cfg(causal, sc, has_kvb=True, kvb_b=per_batch))
    got = _plain(q, k, v, g, causal, sc,
                 A._Extras(kvb=torch.from_numpy(kvb)))
    _check_all(got, want, 2, 2, 256, GRAD_TOL)


def test_full_bias_matches_pallas_interpret():
    q, k, v, g = _mk(seed=1)
    sc = 0.125
    rng = np.random.RandomState(5)
    fb = np.where(rng.rand(2, 2, 256, 256) > 0.3, 0.0,
                  -1e30).astype(np.float32)
    want = _pallas(q, k, v, g, _D, jnp.asarray(fb), _D,
                   _cfg(False, sc, has_fb=True, fb_b=True, fb_h=True))
    got = _plain(q, k, v, g, False, sc, A._Extras(fb=torch.from_numpy(fb)))
    _check_all(got, want, 2, 2, 256, GRAD_TOL)


@pytest.mark.parametrize("fb_shape", [(2, 4, 128, 128), (1, 1, 128, 128)])
def test_full_bias_gqa_matches_jax_route(fb_shape):
    """Hq 4 over Hkv 2: the JAX wrapper pre-folds a per-head bias into
    its folded rows; the port indexes the bias by query head."""
    q, k, v, g = _mk(Lq=128, Lk=128, Hq=4, Hkv=2, seed=2)
    sc = 0.125
    fb = np.random.RandomState(6).randn(*fb_shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, b, c: JA.flash_attention(
        a, b, c, scale=sc, attn_mask=jnp.asarray(fb)),
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = A.flash_attention(tq, tk, tv, scale=sc,
                            attn_mask=torch.from_numpy(fb))
    out.backward(torch.from_numpy(g))
    _close(out, jout)
    for got, want in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(g))):
        _close(got, want, **GRAD_TOL)


def test_bool_mask_matches_jax():
    q, k, v, g = _mk(Lq=128, Lk=128, seed=3)
    mask = np.random.RandomState(7).rand(2, 1, 1, 128) > 0.25
    ref = JA.mha_reference(*map(jnp.asarray, (q, k, v)), scale=0.125,
                           attn_mask=jnp.asarray(mask))
    jout = JA.flash_attention(*map(jnp.asarray, (q, k, v)), scale=0.125,
                              attn_mask=jnp.asarray(mask))
    tq, tk, tv, tm = _t(q, k, v, mask)
    _close(A.flash_attention(tq, tk, tv, scale=0.125, attn_mask=tm), jout)
    _close(A.mha_reference(tq, tk, tv, scale=0.125, attn_mask=tm), ref)


def test_dropout_forward_and_backward_match_pallas_interpret():
    q, k, v, g = _mk(B=1, Lq=128, Lk=128, seed=4)
    sc, rate, seed = 0.125, 0.2, 42
    cfg = _cfg(True, sc, rate=rate)
    want = _pallas(q, k, v, g, _D, _D,
                   jnp.full((1, 1), float(seed), jnp.float32), cfg)
    got = _plain(q, k, v, g, True, sc, A._Extras(rate=rate, seed=seed))
    _check_all(got, want, 1, 2, 128, DROP_GRAD_TOL)
    ref, vjp = jax.vjp(lambda a, b, c: JA.mha_reference(
        a, b, c, causal=True, scale=sc, dropout_rate=rate,
        dropout_seed=seed), *map(jnp.asarray, (q, k, v)))
    _close(got[0], ref)
    for a, b in zip(got[2:], vjp(jnp.asarray(g))):
        _close(a, b, **DROP_GRAD_TOL)


@pytest.mark.parametrize("L,hq,hkv", [(128, 4, 2), (200, 2, 2)])
def test_dropout_with_kvb_matches_jax_route(L, hq, hkv):
    """Dropout over a padding bias through the public entry points: GQA
    at L 128, and a ragged L 200 (the JAX wrapper pads to 256; without
    GQA its row counter is the real row, as the port's)."""
    q, k, v, g = _mk(Lq=L, Lk=L, Hq=hq, Hkv=hkv, seed=5)
    rate, seed = 0.25, 1234
    kvb = np.zeros((2, 1, 1, L), np.float32)
    kvb[0, ..., L - 40:] = -1e4
    jout, vjp = jax.vjp(lambda a, b, c: JA.flash_attention(
        a, b, c, attn_mask=jnp.asarray(kvb), dropout_rate=rate,
        dropout_seed=seed), *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = A.flash_attention(tq, tk, tv, attn_mask=torch.from_numpy(kvb),
                            dropout_rate=rate, dropout_seed=seed)
    out.backward(torch.from_numpy(g))
    _close(out, jout)
    for got, want in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(g))):
        _close(got, want, **DROP_GRAD_TOL)


def test_hash_and_keep_tile_bit_equal():
    x = np.random.RandomState(0).randint(0, 2 ** 32, 4096, dtype=np.uint64)
    want = np.asarray(JA._hash32(jnp.asarray(x.astype(np.uint32))))
    got = A._hash32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    for seed, b, h, rate in ((99, 0, 0, 0.3), (2 ** 24 - 1, 31, 11, 0.1)):
        jsalt = JA._drop_salt(jnp.uint32(seed), b, h)
        salt = A._drop_salt(seed, b, h)
        assert int(salt) == int(jsalt)
        rows, cols = np.arange(700, 1212), np.arange(0, 500)
        want = np.asarray(JA._keep_tile(jsalt, jnp.asarray(rows),
                                        jnp.asarray(cols), rate))
        got = A._keep_tile(salt, *_t(rows, cols), rate).numpy()
        assert np.array_equal(got, want)
        assert abs(got.mean() - (1 - rate)) < 0.01
    assert A._rate_thresh(0.1) == int(JA._rate_thresh(0.1))


@pytest.mark.parametrize("shape", [
    (2, 1, 1, 64), (1, 1, 1, 64), (64,), (2, 3, 48, 64), (2, 1, 48, 64),
    (1, 3, 1, 64), (2, 1, 1, 1), (2, 3, 48, 1), (48, 64)])
@pytest.mark.parametrize("kind", ["additive", "bool"])
def test_normalize_mask_split_equals_jax(shape, kind):
    """Each broadcast shape gives the JAX split (kvb or fb) with the same
    values; a 2-D mask is read as [1, 1, Lq, Lk]."""
    rng = np.random.RandomState(8)
    m = rng.rand(*shape) > 0.3 if kind == "bool" else \
        rng.randn(*shape).astype(np.float32)
    B, Hq, Lq, Lk = 2, 3, 48, 64
    jkvb, jfb = JA._normalize_mask(jnp.asarray(m), B, Hq, Lq, Lk)
    kvb, fb = A._normalize_mask(torch.from_numpy(m), B, Hq, Lq, Lk)
    assert (kvb is None) == (jkvb is None) and (fb is None) == (jfb is None)
    for got, want in ((kvb, jkvb), (fb, jfb)):
        if want is not None:
            assert got.dtype == torch.float32 and got.is_contiguous()
            assert np.array_equal(got.numpy(), np.asarray(want))


def test_sdpa_routes_mask_and_dropout_as_jax(monkeypatch):
    """F.scaled_dot_product_attention with a bool mask and dropout: the
    port's flash route (head_dim 64) and its `mha_reference` route
    (head_dim 32) against the JAX functional with the same seed; eval
    mode drops nothing."""
    for D in (64, 32):
        q, k, v, _ = _mk(Lq=128, Lk=128, D=D, seed=9)
        mask = np.random.RandomState(3).rand(2, 1, 1, 128) > 0.2
        gen = torch.Generator().manual_seed(11)
        seed = A._next_seed(torch.Generator().manual_seed(11))
        monkeypatch.setattr(JA, "_next_seed", lambda: seed)
        for training in (True, False):
            want = JF.scaled_dot_product_attention(
                *(paddle.to_tensor(x) for x in (q, k, v)),
                attn_mask=paddle.to_tensor(mask), dropout_p=0.1,
                training=training)
            A.reset_counts()
            got = F.scaled_dot_product_attention(
                *_t(q, k, v, mask), dropout_p=0.1, training=training,
                generator=gen)
            _close(got, want.numpy())
            assert A.plain_launches["flash_fwd"] == (D == 64)


def test_autograd_function_takes_the_plain_branches():
    q, k, v, g = _mk(B=1, Lq=128, Lk=128, Hq=4, Hkv=2, seed=10)
    kvb = np.zeros((1, 1, 1, 128), np.float32)
    kvb[..., 100:] = -1e4
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    A.reset_counts()
    out = A.flash_attention(tq, tk, tv, attn_mask=torch.from_numpy(kvb),
                            dropout_rate=0.1, dropout_seed=7)
    out.backward(torch.from_numpy(g))
    assert A.plain_launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                "flash_bwd_dkv": 1}
    assert sum(A.kernel_launches.values()) == 0
    ex = A._Extras(kvb=torch.from_numpy(kvb[:, 0, 0]), rate=0.1, seed=7)
    want = _plain(q, k, v, g, False, 0.125, ex)
    assert torch.equal(out.detach(), want[0])
    for got, w in zip((tq.grad, tk.grad, tv.grad), want[2:]):
        assert torch.equal(got, w)
