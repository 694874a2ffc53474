"""The port's flash attention (paddle_tpu_torch.ops.attention) against the
JAX package's Pallas kernels run in interpret mode on the CPU: the plain
forward (out, lse) against `_flash_fwd_lse_impl`, the plain backward
(dq, dk, dv) against `_flash_bwd_impl`, causal and not, GQA 4 -> 2 and
MHA, head_dim 64 and 128; the ragged L 200 against the padded route of
the JAX `flash_attention` (forward and its vjp); and the port's
`autograd.Function` gradient against its plain backward.

Tolerances: f32 throughout, inputs ~0.1 and cotangents ~1. Both sides
sum the same f32 products in different tile orders (the JAX tiles are
128-512 keys, the port's plain walk 128), so values agree to a few f32
ulps of the partial sums: out and lse within 1e-5, gradients (sums of
up to 256 terms of magnitude ~0.1) within 1e-4 — the tolerances the JAX
package's own kernel tests use.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import attention as JA
from paddle_tpu_torch.ops import attention as A

OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _inputs(B, L, Hq, Hkv, D, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, L, Hq, D) * 0.1).astype(np.float32)
    k = (rng.randn(B, L, Hkv, D) * 0.1).astype(np.float32)
    v = (rng.randn(B, L, Hkv, D) * 0.1).astype(np.float32)
    g = rng.randn(B, L, Hq, D).astype(np.float32)
    return q, k, v, g


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (2, 2)])
@pytest.mark.parametrize("D", [64, 128])
def test_plain_fwd_bwd_match_pallas_interpret(causal, hq, hkv, D):
    q, k, v, g = _inputs(2, 256, hq, hkv, D)
    sc = 1.0 / np.sqrt(D)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jout, jlse = JA._flash_fwd_lse_impl(jq, jk, jv, causal, sc,
                                        interpret=True)
    jdq, jdk, jdv = JA._flash_bwd_impl(jq, jk, jv, jout, jlse, jg, causal,
                                       sc, interpret=True)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = A._fwd_ref(tq, tk, tv, causal, sc)
    _close(out, jout, OUT_TOL)
    # JAX folds GQA heads into rows: [B, Hkv, G*L, 1] is [B, Hq, L]
    _close(lse, np.asarray(jlse).reshape(2, hq, 256), OUT_TOL)
    delta = (tg * out).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = A._bwd_ref(tq, tk, tv, tg, lse, delta, causal, sc)
    _close(dq, jdq, GRAD_TOL)
    _close(dk, jdk, GRAD_TOL)
    _close(dv, jdv, GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_padded_route(causal):
    """L 200: the JAX wrapper pads to 256 with a -1e30 key bias; the
    port masks the ragged edge itself."""
    q, k, v, g = _inputs(2, 200, 4, 2, 64, seed=1)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout, vjp = jax.vjp(
        lambda a, b, c: JA.flash_attention(a, b, c, causal=causal),
        jq, jk, jv)
    jdq, jdk, jdv = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = A.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(g))
    _close(out, jout, OUT_TOL)
    _close(tq.grad, jdq, GRAD_TOL)
    _close(tk.grad, jdk, GRAD_TOL)
    _close(tv.grad, jdv, GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_uses_plain_backward(causal):
    q, k, v, g = _inputs(1, 128, 4, 2, 64, seed=2)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    A.reset_counts()
    out = A.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(g))
    assert A.plain_launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                "flash_bwd_dkv": 1}
    assert sum(A.kernel_launches.values()) == 0
    sc = 1.0 / np.sqrt(64)
    pq, pk, pv, pg = map(torch.from_numpy, (q, k, v, g))
    ref, lse = A._fwd_ref(pq, pk, pv, causal, sc)
    delta = (pg * ref).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = A._bwd_ref(pq, pk, pv, pg, lse, delta, causal, sc)
    assert torch.equal(out.detach(), ref)
    for got, want in ((tq.grad, dq), (tk.grad, dk), (tv.grad, dv)):
        assert torch.equal(got, want)


def test_plain_matches_mha_reference():
    """The f32 walk equals the one-shot softmax reference."""
    q, k, v, _ = _inputs(2, 192, 4, 2, 64, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, _ = A._fwd_ref(tq, tk, tv, True, 0.125)
    ref = JA.mha_reference(*map(jnp.asarray, (q, k, v)), causal=True,
                           scale=0.125)
    _close(out, ref, OUT_TOL)
    _close(A.mha_reference(tq, tk, tv, causal=True, scale=0.125), ref,
           OUT_TOL)


def test_masks_and_dropout_raise_on_kernel_route():
    """Masks and dropout are ported (test_torch_flash_masked.py); what
    the kernel route cannot take raises before any launch: a mask that
    does not broadcast to [B, H, Lq, Lk], a drop rate outside [0, 1),
    and two biases at once."""
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError):
        A.flash_attention(q, q, q, attn_mask=torch.zeros(3, 1, 1, 128))
    with pytest.raises(ValueError):
        A.flash_attention(q, q, q, attn_mask=torch.zeros(64, 128))
    with pytest.raises(ValueError):
        A.flash_attention(q, q, q, dropout_rate=1.0)
    ex = A._Extras(kvb=torch.zeros(1, 128), fb=torch.zeros(1, 1, 128, 128))
    with pytest.raises(ValueError):
        A._check_extras(ex, A._check(q, q, q), q.device)


@pytest.mark.parametrize("bad,err", [
    (dict(D=32), ValueError),                       # head_dim off 64/128/256
    (dict(dtype=torch.float16), TypeError),         # neither f32 nor bf16
    (dict(hkv=3), ValueError),                      # Hq % Hkv != 0
    (dict(transpose=True), ValueError),             # not contiguous
])
def test_kernel_operand_checks(bad, err):
    """The CUDA wrappers check their operands before any launch."""
    D, dt, hkv = bad.get("D", 64), bad.get("dtype", torch.float32), \
        bad.get("hkv", 2)
    q = torch.zeros(1, 128, 4, D, dtype=dt)
    k = torch.zeros(1, 128, hkv, D, dtype=dt)
    if bad.get("transpose"):
        k = torch.zeros(1, hkv, 128, D).transpose(1, 2)
    with pytest.raises(err):
        A._check(q, k, k)
