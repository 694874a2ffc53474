"""The rounding points of the port's bf16 tensor-core kernels, held on the
CPU through their plain versions.

Flash forward (`paddle_tpu_torch.ops.attention._fwd_ref` on bf16 q/k/v,
the plain walk of `flash_fwd_tc_kernel`): s = (q.k)*scale on the stored
bf16 values, p_use (p, or p * keep / (1 - rate)) rounded to bf16 before
P.V, l summing the unrounded, undropped p, over 64-key tiles.

- One key tile (L <= 64): the walk equals the rounding points written out
  in one pass (the same f32 operations in the same order; atol 1e-6).
- Against the JAX package on the same bf16 inputs: its Pallas forward in
  interpret mode (`_fwd_lse_impl`, f32 probabilities, output rounded
  once) and `mha_reference` (probabilities normalised, then rounded to
  bf16). lse within 1e-5: no rounding point touches it, only the place
  of the scale (f32 rounding). out within one bf16 ulp of |out| plus
  1e-5, plus the bound of the p rounding: each p_use moves by at most
  2^-8 of itself, so out moves by at most 2^-8 * W, W = sum_k (p_use_k /
  l) |v_k| (computed in f32 from the f32 walk's probabilities); against
  `mha_reference`, which rounds its own probabilities as well, 2^-7 * W.
  One ulp plus 1e-5 alone does not hold here: where out is near 0 the
  rounding of p moves it by up to ~80 such allowances against the
  Pallas forward and ~300 against `mha_reference` (std-1 inputs at L
  256); with the bound added the largest error stays below the
  allowance (0.76-0.89 of it there).

Flash backward (`_bwd_ref` on bf16 q/k/v, the plain walk of
`flash_dq_tc_kernel` and `flash_dkv_tc_kernel`): p = exp((q.k)*scale +
bias - lse) from the saved lse, dp = dO.v, dS = p*(dp - delta)*scale in
f32 rounded to bf16 before dS.K and dS^T.Q, p_use rounded to bf16
before p_use^T.dO, every product summed in f32.

- One key tile (L <= 128): the walk equals the points written out in one
  pass (atol 1e-6).
- Against the JAX package on the same bf16 inputs: its Pallas backward
  in interpret mode (`_bwd_impl`: dS and p_use in f32, each gradient
  rounded once) and `jax.vjp` of `mha_reference`. Each gradient within
  one bf16 ulp of |grad| plus 1e-5, plus the bound of the bf16
  roundings: rounding dS (p_use) moves each term by at most 2^-8 of
  itself, so dQ moves by at most 2^-8 W_dq, W_dq = sum_k |dS_k| |K_k|
  (dK: W_dk = sum_q |dS_q| |Q_q| over the group's heads; dV: W_dv =
  sum_q |p_use_q| |dO_q|), computed in f32 from the f32 walk. Against
  `mha_reference`, whose vjp rounds its own scores, dP and dS to bf16,
  2^-7 of W' instead, with W' the same sums over p (|dp| + |delta|)
  scale in place of |dS|: a rounding of dp or delta moves dS by a part
  of p |dp| or p |delta|, which |dS| = p |dp - delta| does not bound
  where dp is near delta.

Build (`paddle_tpu_torch.ops._build`): a library's name hashes the
headers its source includes, so an edited header rebuilds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as JA
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import attention as A

LSE_TOL = 1e-5
ATOL = 1e-5


def _bf16_inputs(B, L, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(B, L, h, D).astype(np.float32)
                                  ).bfloat16() for h in (Hq, Hkv, Hkv))


def _ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _padding_kvb(B, L, seed):
    lens = np.random.RandomState(seed).randint(L * 3 // 4, L + 1, (B,))
    valid = np.arange(L)[None, :] < lens[:, None]
    return torch.from_numpy(np.where(valid, 0.0, -1e4).astype(np.float32))


def _one_pass(q, k, v, causal, scale, ex):
    """The rounding points in one pass over all keys (one key tile)."""
    qh, kh, vh = A._heads(q, k, v)
    Lq, Lk = qh.shape[2], kh.shape[2]
    s = (qh @ kh.transpose(-1, -2)) * scale
    bias = ex.bias(0, Lk)
    if bias is not None:
        s = s + bias
    keep = A._tile_mask(Lq, 0, Lk, causal, q.device)
    if keep is not None:
        s = torch.where(keep, s, A._NEG)
    m = torch.maximum(torch.full_like(s[..., :1], A._NEG),
                      s.amax(-1, keepdim=True))
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    l = p.sum(-1, keepdim=True)
    drop = ex.drop(q, k, 0, Lk)
    if drop is not None:
        p = p * drop
    acc = p.to(torch.bfloat16).float() @ vh
    return (acc / l.clamp_min(A._DENOM_EPS)).transpose(1, 2)


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_one_tile_walk_is_the_rounding_points(causal, masked):
    q, k, v = _bf16_inputs(2, 48, 4, 2, 64, seed=11)
    ex = (A._Extras(_padding_kvb(2, 48, 12), None, 0.1, 77) if masked
          else A._NONE)
    got, _ = A._fwd_ref(q, k, v, causal, 0.125, ex, f32_out=True)
    want = _one_pass(q, k, v, causal, 0.125, ex)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    # and the rounding is really there: the f32 walk differs
    f32, _ = A._fwd_ref(q.float(), k.float(), v.float(), causal, 0.125, ex)
    assert float((f32 - got).abs().max()) > 1e-4


# (B, L, Hq, Hkv, D, causal, kvb + dropout 0.1): two or more 64-key tiles
# each, so the running max moves between tiles as in the kernel
CASES = [(1, 128, 4, 2, 64, True, False),
         (1, 128, 2, 2, 128, False, False),
         (2, 128, 2, 2, 64, False, True),
         (1, 100, 4, 2, 64, True, False)]


@pytest.mark.parametrize("B,L,Hq,Hkv,D,causal,masked", CASES)
def test_bf16_walk_matches_jax(B, L, Hq, Hkv, D, causal, masked):
    q, k, v = _bf16_inputs(B, L, Hq, Hkv, D, seed=L + D)
    sc = D ** -0.5
    kvb = _padding_kvb(B, L, seed=3) if masked else None
    rate, seed = (0.1, 1234) if masked else (0.0, 0)
    ex = A._Extras(kvb, None, rate, seed)
    out, lse = A._fwd_ref(q, k, v, causal, sc, ex)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    # W = sum_k (p_use_k / l) |v_k|, from the f32 walk's probabilities
    f32 = tuple(t.float() for t in (q, k, v))
    w = A.mha_reference(f32[0], f32[1], f32[2].abs(), causal=causal,
                        scale=sc, attn_mask=(None if kvb is None else
                                             kvb[:, None, None, :]),
                        dropout_rate=rate, dropout_seed=seed).numpy()
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    jmask = None if kvb is None else jnp.asarray(kvb.numpy())[:, None, None]
    ref = np.asarray(JA.mha_reference(
        jq, jk, jv, causal=causal, scale=sc, attn_mask=jmask,
        dropout_rate=rate, dropout_seed=seed).astype(jnp.float32))
    assert (np.abs(got - ref) <= _ulp(ref) + 2 ** -7 * w + ATOL).all()
    if L % 128:
        return                      # the Pallas kernel tiles by 128
    jkvb = jnp.zeros((1, 1), jnp.float32) if kvb is None else \
        jnp.asarray(kvb.numpy())
    cfg = (causal, sc, rate, masked, masked, False, False, False)
    jout, jlse = JA._fwd_lse_impl(jq, jk, jv, jkvb,
                                  jnp.zeros((1, 1), jnp.float32),
                                  jnp.full((1, 1), seed, jnp.float32), cfg,
                                  interpret=True)
    jout = np.asarray(jout.astype(jnp.float32))
    assert (np.abs(got - jout) <= _ulp(jout) + 2 ** -8 * w + ATOL).all()
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(B, Hq, L),
                               atol=LSE_TOL, rtol=0)


def _bwd_parts(q, k, v, g, lse, delta, causal, scale, ex):
    """f32 [B, Hq, ...] pieces of the backward in one pass over all keys:
    (qh, kh, vh, doh, p, dp, p_use), dp and p_use with dropout applied."""
    qh, kh, vh = A._heads(q, k, v)
    doh = g.float().transpose(1, 2)
    Lq, Lk = qh.shape[2], kh.shape[2]
    s = (qh @ kh.transpose(-1, -2)) * scale
    bias = ex.bias(0, Lk)
    if bias is not None:
        s = s + bias
    keep = A._tile_mask(Lq, 0, Lk, causal, q.device)
    if keep is not None:
        s = torch.where(keep, s, A._NEG)
    p = torch.exp(s - lse[..., None])
    dp = doh @ vh.transpose(-1, -2)
    p_use = p
    drop = ex.drop(q, k, 0, Lk)
    if drop is not None:
        p_use, dp = p * drop, dp * drop
    return qh, kh, vh, doh, p, dp, p_use


def _fold(x, Hkv):
    """[B, Hq, Lk, D] summed over each group of query heads, as [B, Lk,
    Hkv, D]."""
    B, Hq, Lk, D = x.shape
    return x.reshape(B, Hkv, Hq // Hkv, Lk, D).sum(2).transpose(1, 2)


def _bwd_one_pass(q, k, v, g, lse, delta, causal, scale, ex):
    """The backward's rounding points in one pass over all keys."""
    qh, kh, _, doh, p, dp, p_use = _bwd_parts(q, k, v, g, lse, delta,
                                              causal, scale, ex)
    ds = (p * (dp - delta[..., None]) * scale).bfloat16().float()
    p_use = p_use.bfloat16().float()
    Hkv = k.shape[2]
    return ((ds @ kh).transpose(1, 2),
            _fold(ds.transpose(-1, -2) @ qh, Hkv),
            _fold(p_use.transpose(-1, -2) @ doh, Hkv))


def _bwd_weights(q, k, v, g, lse, delta, causal, scale, ex, spread=False):
    """(W_dq, W_dk, W_dv) as numpy: sum_k |dS| |K|, sum_q |dS| |Q| and
    sum_q |p_use| |dO|, from f32 values; `spread`: |dS| replaced by p
    (|dp| + |delta|) scale."""
    f32 = tuple(t.float() for t in (q, k, v, g))
    qh, kh, _, doh, p, dp, p_use = _bwd_parts(*f32, lse, delta, causal,
                                              scale, ex)
    if spread:
        ws = p * (dp.abs() + delta[..., None].abs()) * scale
    else:
        ws = (p * (dp - delta[..., None]) * scale).abs()
    Hkv = k.shape[2]
    return ((ws @ kh.abs()).transpose(1, 2).numpy(),
            _fold(ws.transpose(-1, -2) @ qh.abs(), Hkv).numpy(),
            _fold(p_use.transpose(-1, -2) @ doh.abs(), Hkv).numpy())


def _grads_within(got, want, weights, frac):
    for name, a, b, w in zip(("dq", "dk", "dv"), got, want, weights):
        a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = np.asarray(b, np.float32)
        bound = _ulp(b) + ATOL + frac * w
        assert (np.abs(a - b) <= bound).all(), \
            (name, float((np.abs(a - b) / bound).max()))


def _bwd_inputs(B, L, Hq, Hkv, D, masked, causal, seed):
    q, k, v = _bf16_inputs(B, L, Hq, Hkv, D, seed=seed)
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        B, L, Hq, D).astype(np.float32)).bfloat16()
    kvb = _padding_kvb(B, L, seed=seed + 2) if masked else None
    rate, dseed = (0.1, 4321) if masked == "dropout" else (0.0, 0)
    return q, k, v, g, A._Extras(kvb, None, rate, dseed)


@pytest.mark.parametrize("causal,masked", [(True, None), (False, "dropout")])
def test_bwd_one_tile_walk_is_the_rounding_points(causal, masked):
    q, k, v, g, ex = _bwd_inputs(2, 96, 4, 2, 64, masked, causal, seed=21)
    out, lse = A._fwd_ref(q, k, v, causal, 0.125, ex)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = A._bwd_ref(q, k, v, g, lse, delta, causal, 0.125, ex,
                     f32_out=True)
    want = _bwd_one_pass(q, k, v, g, lse, delta, causal, 0.125, ex)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    # the roundings are really there: the f32 walk differs in each
    f32 = A._bwd_ref(*(t.float() for t in (q, k, v, g)), lse, delta,
                     causal, 0.125, ex)
    assert all(float((a - b).abs().max()) > 1e-4 for a, b in zip(f32, got))


# (B, L, Hq, Hkv, D, causal, mask): causal and not, GQA 4 -> 2, the
# per-key bias with and without dropout, head_dim 64 and 128
BWD_CASES = [(1, 128, 4, 2, 64, True, None),
             (1, 128, 2, 2, 128, False, None),
             (2, 128, 2, 2, 64, False, "kvb"),
             (1, 256, 4, 2, 64, True, "dropout")]


@pytest.mark.parametrize("B,L,Hq,Hkv,D,causal,masked", BWD_CASES)
def test_bf16_bwd_walk_matches_jax(B, L, Hq, Hkv, D, causal, masked):
    q, k, v, g, ex = _bwd_inputs(B, L, Hq, Hkv, D, masked, causal,
                                 seed=L + D + Hq)
    sc = D ** -0.5
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      for t in (q, k, v, g))
    # the Pallas backward on the Pallas forward's out and lse
    jkvb = jnp.zeros((1, 1), jnp.float32) if ex.kvb is None else \
        jnp.asarray(ex.kvb.numpy())
    has = ex.kvb is not None
    cfg = (causal, sc, ex.rate, has, has, False, False, False)
    jd = jnp.zeros((1, 1), jnp.float32)
    jseed = jnp.full((1, 1), ex.seed, jnp.float32)
    jout, jlse = JA._fwd_lse_impl(jq, jk, jv, jkvb, jd, jseed, cfg,
                                  interpret=True)
    jgrads = JA._bwd_impl(jq, jk, jv, jlse, jg, jout, jkvb, jd, jseed, cfg,
                          interpret=True)
    out = torch.tensor(np.asarray(jout.astype(jnp.float32))).bfloat16()
    lse = torch.tensor(np.asarray(jlse)).reshape(B, Hq, L)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = A._bwd_ref(q, k, v, g, lse, delta, causal, sc, ex)
    assert all(t.dtype == torch.bfloat16 for t in got)
    w = _bwd_weights(q, k, v, g, lse, delta, causal, sc, ex)
    _grads_within(got, [x.astype(jnp.float32) for x in jgrads], w, 2 ** -8)
    # jax.vjp of mha_reference, against the port's own forward
    jmask = None if ex.kvb is None else jkvb[:, None, None]
    _, vjp = jax.vjp(lambda a, b, c: JA.mha_reference(
        a, b, c, causal=causal, scale=sc, attn_mask=jmask,
        dropout_rate=ex.rate, dropout_seed=ex.seed), jq, jk, jv)
    jgrads = vjp(jg)
    out, lse = A._fwd_ref(q, k, v, causal, sc, ex)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = A._bwd_ref(q, k, v, g, lse, delta, causal, sc, ex)
    w = _bwd_weights(q, k, v, g, lse, delta, causal, sc, ex, spread=True)
    _grads_within(got, [x.astype(jnp.float32) for x in jgrads], w, 2 ** -7)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "t.cuh"\n#include <x.h>\n')
    (tmp_path / "t.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src, first = _build._target("k")
    assert [p.name for p in _build._sources(src)] == ["k.cu", "t.cuh"]
    (tmp_path / "t.cuh").write_text("// two\n")
    assert _build._target("k")[1] != first
    (tmp_path / "t.cuh").write_text("// one\n")
    assert _build._target("k")[1] == first
