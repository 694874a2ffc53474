"""The port's dropout + residual + LayerNorm
(paddle_tpu_torch.ops.fused_ops.fused_dropout_residual_layer_norm)
against the JAX package's op of the same name:
  * with the same host bits (the JAX op's interpret-mode bits,
    `jax.random.bits(PRNGKey(seed), (n, h), uint32)`, handed to the port
    as its private `_host_bits`), the port's plain version against the
    JAX Pallas kernel in interpret mode;
  * eval and p = 0 against the JAX `_dropout_res_ln_ref`, on the kernel's
    widths and off them;
  * the port's own mask bits (the counter hash the kernel computes) equal
    to the JAX package's `_hash32` of the flat index and salt, the keep
    rule `bits <= int((1 - p) * (2^32 - 1))`, a kept fraction near 1 - p;
  * no gradient: `jax.grad` of the JAX op abandons its Pallas kernel for
    the threefry-masked reference, so the port's op raises in backward.

Tolerances: h within 1e-6 and out within 1e-5 in f32 (the same f32 sum,
and the same f32 statistics summed in another order; |out| <= ~5). Masks
and bits are integers and compared exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import attention as JA
from paddle_tpu.ops import fused_ops as JX
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.ops import fused_ops as X

EPS = 1e-5


def _inputs(n, h, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h).astype(np.float32),
            rng.randn(n, h).astype(np.float32),
            rng.randn(h).astype(np.float32),
            rng.randn(h).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("p,seed", [(0.1, 3), (0.5, 7)])
def test_host_bits_match_pallas_kernel(p, seed):
    """The JAX op draws host bits in interpret mode and runs its kernel's
    threshold, scale and LayerNorm on them; the port's plain version on
    the same bits gives the same h and out."""
    n, h = 32, 256
    x, r, w, b = _inputs(n, h)
    jout, jh = JX.fused_dropout_residual_layer_norm(
        *map(jnp.asarray, (x, r, w, b)), p=p, eps=EPS, seed=seed,
        training=True, interpret=True)
    bits = np.array(jax.random.bits(jax.random.PRNGKey(seed), (n, h),
                                    jnp.uint32))
    X.reset_counts()
    out, hv = X.fused_dropout_residual_layer_norm(
        *_t(x, r, w, b), p=p, eps=EPS, seed=seed,
        _host_bits=torch.from_numpy(bits.view(np.int32)))
    assert X.drln_plain_launches == 1
    np.testing.assert_allclose(hv.numpy(), np.asarray(jh), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    # the bits did drop elements: h differs from x + r where dropped
    dropped = (bits > X._keep_thresh(p))
    assert dropped.any()
    np.testing.assert_array_equal(hv.numpy()[dropped], r[dropped])


@pytest.mark.parametrize("h", [256, 200])
@pytest.mark.parametrize("p,training", [(0.1, False), (0.0, True)])
def test_eval_and_p0_match_reference(h, p, training):
    """No dropout (eval, or p = 0): out = LN(x + r) and h = x + r, against
    the JAX `_dropout_res_ln_ref`, on the kernel's widths (h % 128 == 0)
    and off them."""
    x, r, w, b = _inputs(16, h, seed=1)
    jout, jh = JX._dropout_res_ln_ref(
        *map(jnp.asarray, (x, r, w, b)), jax.random.PRNGKey(0), p, EPS,
        training)
    out, hv = X.fused_dropout_residual_layer_norm(
        *_t(x, r, w, b), p=p, eps=EPS, seed=5, training=training)
    np.testing.assert_allclose(hv.numpy(), np.asarray(jh), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)


def test_default_weight_and_bias_and_bf16():
    """No weight and bias: ones and zeros, as the JAX op; bf16 in, both
    outputs bf16, the kernel's f32 arithmetic rounded once."""
    x, r, _, _ = _inputs(16, 128, seed=2)
    xb, rb = (torch.from_numpy(a).bfloat16() for a in (x, r))
    out, hv = X.fused_dropout_residual_layer_norm(xb, rb, p=0.1, seed=9)
    assert out.dtype == hv.dtype == torch.bfloat16
    want = X._dropout_res_ln_kernel_ref(
        xb, rb, torch.ones(128, dtype=torch.bfloat16),
        torch.zeros(128, dtype=torch.bfloat16), 0.1, EPS, seed=9)
    assert torch.equal(out, want[0]) and torch.equal(hv, want[1])


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 + 17])
def test_hash_bits_equal_jax_hash(seed):
    """The kernel's bits are the JAX package's `_hash32` of the flat index
    (times 0x9E3779B1) xor the salt (times 0x85EBCA77), salt = seed mod
    2^31; `F._hash_keep` keeps by the same bits (its own rule)."""
    n, h = 8, 384
    salt = seed % (1 << 31)
    idx = jax.lax.iota(jnp.uint32, n * h) * jnp.uint32(0x9E3779B1)
    want = np.asarray(JA._hash32(idx ^ (jnp.uint32(salt)
                                        * jnp.uint32(0x85EBCA77))))
    got = X._hash_bits(seed, (n, h))
    assert np.array_equal(got.reshape(-1).numpy(), want.astype(np.int64))
    keep = F._hash_keep(salt, (n, h), 0.1)
    assert torch.equal(keep, got >= A._rate_thresh(0.1))


@pytest.mark.parametrize("p", [0.1, 0.3])
def test_in_kernel_mask_and_kept_fraction(p):
    """The op's own mask (x = 1, r = 0, so h != 0 exactly where kept) is
    bits <= int((1 - p) * (2^32 - 1)) of the hash bits, kept elements
    are 1 / (1 - p), and the kept fraction is within 0.01 of 1 - p over
    64 x 512 elements (4 standard deviations at p = 0.3)."""
    n, h = 64, 512
    x, r = torch.ones(n, h), torch.zeros(n, h)
    _, hv = X.fused_dropout_residual_layer_norm(x, r, p=p, seed=21)
    keep = hv != 0
    assert torch.equal(keep, X._hash_bits(21, (n, h)) <= X._keep_thresh(p))
    assert torch.equal(hv[keep], torch.full_like(hv[keep],
                                                 1 / np.float32(1 - p)))
    assert abs(float(keep.float().mean()) - (1 - p)) < 0.01
    # the same bits given as host bits give the same result
    bits = X._hash_bits(21, (n, h)).to(torch.uint32)
    _, hv2 = X.fused_dropout_residual_layer_norm(x, r, p=p, seed=0,
                                                 _host_bits=bits)
    assert torch.equal(hv, hv2)


def test_backward_raises():
    x, r, w, b = (t.requires_grad_() for t in _t(*_inputs(16, 128)))
    out, _ = X.fused_dropout_residual_layer_norm(x, r, w, b, p=0.1)
    with pytest.raises(NotImplementedError):
        out.sum().backward()


@pytest.mark.parametrize("bad,err", [
    (dict(x_dtype=torch.float16), TypeError),
    (dict(r_shape=(8, 64)), ValueError),
    (dict(bits_dtype=torch.int64), TypeError),
    (dict(h=16384), ValueError),
])
def test_kernel_operand_checks(bad, err):
    """The CUDA wrapper checks its operands before any launch."""
    h = bad.get("h", 128)
    x = torch.zeros(8, h, dtype=bad.get("x_dtype", torch.float32))
    r = torch.zeros(bad.get("r_shape", (8, h)), dtype=x.dtype)
    bits = (torch.zeros(8, h, dtype=bad["bits_dtype"])
            if "bits_dtype" in bad else None)
    with pytest.raises(err):
        X._drln_launch(x, r, torch.ones(h), torch.zeros(h), 0.1, EPS, 0,
                       bits)
