"""The port's threefry random numbers (`paddle_tpu_torch.random`) against
`jax.random` on fixed keys, on the CPU: every value bit-equal (no
tolerance), in the `jax_threefry_partitionable` mode the installed jax
runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import random as R

SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 4), (16, 50304)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this module runs: the suite
    runs in several worker processes beside XLA's thread pools, and
    PyTorch's default of a thread per core then oversubscribes the CPU
    many times over. Results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind in "ui":
        assert np.array_equal(got.astype(np.int64), want.astype(np.int64))
    else:
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_partitionable_mode():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, -7, 123456789])
def test_prng_key(seed):
    _eq(R.PRNGKey(seed, device="cpu"), jax.random.PRNGKey(seed))


def test_split_and_fold_in():
    k, kt = jax.random.PRNGKey(7), R.PRNGKey(7, device="cpu")
    _eq(R.split(kt), jax.random.split(k))
    _eq(R.split(kt, 5), jax.random.split(k, 5))
    _eq(R.split(R.split(kt)[1], 3), jax.random.split(jax.random.split(k)[1],
                                                     3))
    for d in (0, 1, 12345, 2**31 - 1):
        _eq(R.fold_in(kt, d), jax.random.fold_in(k, d))
    _eq(R.fold_in(kt, -3), jax.random.fold_in(k, jnp.int32(-3)))
    # batched, as jax.vmap folds request ids then positions in
    kids, pos = np.arange(9, dtype=np.int32) * 37, np.arange(9) + 100
    want = jax.vmap(lambda a, b: jax.random.fold_in(
        jax.random.fold_in(k, a), b))(jnp.asarray(kids), jnp.asarray(pos))
    got = R.fold_in(R.fold_in(kt, torch.from_numpy(kids)),
                    torch.from_numpy(pos))
    _eq(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_gumbel(shape):
    k, kt = jax.random.PRNGKey(3), R.PRNGKey(3, device="cpu")
    _eq(R.bits(kt, shape), jax.random.bits(k, shape))
    _eq(R.uniform(kt, shape), jax.random.uniform(k, shape))
    _eq(R.uniform(kt, shape, minval=-2.5, maxval=3.75),
        jax.random.uniform(k, shape, minval=-2.5, maxval=3.75))
    _eq(R.gumbel(kt, shape), jax.random.gumbel(k, shape))


def test_gumbel_on_every_uniform_value():
    """The Gumbel transform -log(-log(u)) on all 2^23 values the f32
    uniform in [tiny, 1) can take: bit-equal to XLA's (whose CPU log is
    not the correctly rounded one)."""
    m = np.arange(2**23, dtype=np.uint32) | np.uint32(0x3F800000)
    u = m.view(np.float32) - np.float32(1.0)
    u = np.maximum(np.float32(np.finfo(np.float32).tiny), u)
    want = jax.jit(lambda x: -jnp.log(-jnp.log(x)))(u)
    got = -R._xla_log(-R._xla_log(torch.from_numpy(u)))
    _eq(got, want)


@pytest.mark.parametrize("shape", [(1, 5), (4, 33), (16, 50304)], ids=str)
def test_categorical(shape):
    rng = np.random.RandomState(shape[-1])
    logits = (rng.randn(*shape) * 3).astype(np.float32)
    logits[:, ::3] = -1e30                  # masked entries, as mask_logits
    k, kt = jax.random.PRNGKey(11), R.PRNGKey(11, device="cpu")
    _eq(R.categorical(kt, torch.from_numpy(logits)),
        jax.random.categorical(k, logits))
    # one key a row (the serving decoder's vmap over slots)
    keys = jax.random.split(k, shape[0])
    _eq(R.categorical(R.split(kt, shape[0]), torch.from_numpy(logits)),
        jax.vmap(jax.random.categorical)(keys, logits))


def test_counts_and_key_checks():
    R.reset_counts()
    kt = R.PRNGKey(0, device="cpu")
    R.categorical(R.split(kt, 2), torch.zeros(2, 8))
    R.fold_in(kt, 3)
    assert R.draws == {"bits": 1, "split": 1, "fold_in": 1}
    with pytest.raises(ValueError):
        R.split(R.split(kt, 2))
    with pytest.raises(ValueError):
        R.categorical(R.split(kt, 3), torch.zeros(2, 8))


def test_prng_key_defaults_to_the_card():
    """device=None means the card, as for every entry point of the port:
    without one, PRNGKey raises instead of drawing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None uses it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        R.PRNGKey(0)
    assert R.PRNGKey(0, device="cpu").device.type == "cpu"
