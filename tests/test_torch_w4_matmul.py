"""The port's W4A16 matmul (paddle_tpu_torch.ops.w4_matmul) and weight
quantizer (paddle_tpu_torch.quantization) against the JAX package.

- `quantize_weight` and `quantize_w4` give the JAX functions' bytes and
  scales exactly on the same f32 input: odd K (a padded nibble row), odd
  N, an N of 50257 (a vocab-wide column count).
- The plain version `_w4_ref` agrees with the JAX `w4_matmul` (the Pallas
  kernel in interpret mode; the jnp `_w4_ref` for odd K) within atol =
  rtol = 1e-5 in f32, the tolerance of the JAX package's own kernel test
  (both sides sum the f32 product in different orders). bf16 x: within
  one bf16 ulp of the larger magnitude plus 1e-5 (both round an f32
  result once).
- The CUDA wrapper checks its operands before any launch; on a card the
  kernel agrees with the plain version (that test skips without one).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import w4_matmul as jw4
from paddle_tpu.quantization import quantize_weight as jax_quantize_weight
from paddle_tpu_torch.ops import w4_matmul as w4
from paddle_tpu_torch.quantization import quantize_weight


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _weight(seed, K, N):
    w = np.random.RandomState(seed).randn(K, N).astype(np.float32)
    w[0, 0] = 0.0                   # a zero and a column of exact halves
    w[:, -1] = np.linspace(-3.5, 3.5, K, dtype=np.float32)
    return w


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K,N", [(64, 96), (9, 12), (33, 257)])
def test_quantize_weight_equals_jax(bits, K, N):
    w = _weight(K + N, K, N)
    q, s = quantize_weight(torch.from_numpy(w), axis=0, bits=bits)
    jq, js = jax_quantize_weight(jnp.asarray(w), axis=0, bits=bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("K,N", [(10, 8), (9, 12), (64, 257), (7, 50257)])
def test_quantize_w4_bytes_equal_jax(K, N):
    """Packed bytes and scales bit-equal to the JAX packer, odd K
    included; the unpack gives quantize_weight's int4 grid back."""
    w = _weight(K * N % 97, K, N)
    packed, scale = w4.quantize_w4(torch.from_numpy(w))
    jp, js = jw4.quantize_w4(w)
    assert packed.dtype == torch.int8 and packed.shape == ((K + 1) // 2, N)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    np.testing.assert_array_equal(w4._unpack_w4(packed, K).numpy(),
                                  np.asarray(jw4._unpack_w4(jp, K)))


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,K,N", [(4, 64, 256), (3, 64, 50), (1, 128, 96),
                                   (17, 32, 300), (5, 9, 12)])
def test_plain_matches_jax_w4_matmul(S, K, N, dtype):
    """S = 1, S off any tile, odd N, odd K (the JAX wrapper's jnp
    detour), f32 and bf16 activations."""
    rng = np.random.RandomState(S * K + N)
    x = rng.randn(S, K).astype(np.float32)
    packed, scale = jw4.quantize_w4(_weight(N, K, N))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jw4.w4_matmul(jnp.asarray(x, jd), packed, scale, K,
                                    block_n=32).astype(jnp.float32))
    before = w4.plain_launches
    got = w4.w4_matmul(torch.from_numpy(x).to(td),
                       torch.from_numpy(np.array(packed)),
                       torch.from_numpy(np.array(scale)), K)
    assert w4.plain_launches == before + 1
    assert got.dtype == td and got.shape == (S, N)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 1e-5
        assert (np.abs(got - want) <= tol).all()


def test_leading_dims_and_jax_reference():
    """[B, T, K] inputs keep their leading dims; the plain version equals
    the JAX jnp `_w4_ref` to f32 tolerance."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 64).astype(np.float32)
    packed, scale = w4.quantize_w4(torch.from_numpy(_weight(5, 64, 40)))
    got = w4.w4_matmul(torch.from_numpy(x), packed, scale, 64)
    assert got.shape == (2, 3, 40)
    want = jw4._w4_ref(jnp.asarray(x.reshape(6, 64)),
                       jnp.asarray(packed.numpy()),
                       jnp.asarray(scale.numpy()), 64)
    np.testing.assert_allclose(got.reshape(6, 40).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad,err", [
    ("x_dtype", TypeError),          # float16 activations
    ("scale_dtype", TypeError),      # bf16 scales
    ("packed_rows", ValueError),     # packed rows != ceil(K/2)
    ("strided", ValueError),         # non-contiguous packed weight
])
def test_kernel_operand_checks(bad, err):
    """The CUDA wrapper checks its operands before any launch."""
    K, N = 64, 32
    x = torch.zeros(4, K, dtype=torch.float16 if bad == "x_dtype"
                    else torch.float32)
    packed = torch.zeros((K + 1) // 2 + (bad == "packed_rows"), N,
                         dtype=torch.int8)
    if bad == "strided":
        packed = torch.zeros(N, (K + 1) // 2, dtype=torch.int8).t()
    scale = torch.ones(N, dtype=torch.bfloat16 if bad == "scale_dtype"
                       else torch.float32)
    with pytest.raises(err):
        w4._launch(x, packed, scale, K)


@pytest.mark.parametrize("S,K,N", [(16, 256, 384), (70, 97, 50), (1, 64, 33)])
def test_cuda_kernel_matches_plain(cuda, S, K, N):
    """On CUDA tensors the wrapper launches the kernel, never the plain
    version; f32 within atol = rtol = 1e-5 of it (the kernel scales the
    finished sum, the plain version each weight), and a row's output does
    not depend on the other rows."""
    rng = np.random.RandomState(S + K)
    x = torch.from_numpy(rng.randn(S, K).astype(np.float32)).to(cuda)
    packed, scale = w4.quantize_w4(torch.from_numpy(_weight(3, K, N)).to(
        cuda))
    w4.reset_counts()
    got = w4.w4_matmul(x, packed, scale, K)
    alone = w4.w4_matmul(x[-1:].contiguous(), packed, scale, K)
    torch.cuda.synchronize()
    assert w4.kernel_launches == 2 and w4.plain_launches == 0
    torch.testing.assert_close(got, w4._w4_ref(x, packed, scale, K),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(alone, got[-1:])
