"""Counter-based random numbers bit-equal to `jax.random` (threefry2x32).

The port's sampling (`models.generation`, the serving decoder) draws
exactly the numbers the JAX package draws from the same keys, so a
seeded sampled stream is the same stream in both packages and on every
device. This module follows jax 0.9.0's `jax/_src/prng.py` and
`jax/_src/random.py` in the `jax_threefry_partitionable` mode (that
release's default):

- a key is two uint32 words, here an int64 tensor [..., 2] holding
  values in [0, 2^32); `PRNGKey(seed)` is (seed >> 32, seed & 0xFFFFFFFF)
  of the seed as a 32-bit integer;
- `split(key, n)[i]` and `fold_in(key, i)` are both threefry2x32(key,
  (0, i)), the two output words as the new key;
- the raw 32-bit bits of a shape are, for the flat index c of each
  element, the XOR of the two words of threefry2x32(key, (c >> 32,
  c & 0xFFFFFFFF));
- `uniform` keeps the top 23 bits as the mantissa of a float in [1, 2),
  subtracts 1 and maps [0, 1) onto [minval, maxval), clamped below at
  minval;
- `gumbel` is -log(-log(u)) of u = uniform(tiny, 1) (jax's "low" mode);
- `categorical(key, logits)` is argmax(gumbel + logits), the first index
  on ties.

The uint32 arithmetic runs in int64 tensors masked to 32 bits, so it
computes the same bits on the CPU and on the card; scalars reach the
card as fills, never as host-to-device copies (which wait for the card),
so draws enqueue without a sync. `log` is not torch's:
XLA's CPU backend evaluates it with Cephes' polynomial (one fused
multiply-add where LLVM contracts it), which differs from a correctly
rounded log on ~14% of f32 inputs; `_xla_log` reproduces it with exact
float64 products, so the Gumbel noise is bit-equal to jax's on every
uniform value (all 2^23 checked) and identical on every device. It is
all eager torch ops — no kernel; `draws` counts the calls that build
random bits, by function.
"""
import numpy as np
import torch

from .device import get_device

__all__ = ["PRNGKey", "split", "fold_in", "bits", "uniform", "gumbel",
           "categorical", "draws", "reset_counts"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

draws = {"bits": 0, "split": 0, "fold_in": 0}


def reset_counts():
    for k in draws:
        draws[k] = 0


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x1, x2)
    under the key words (k1, k2); int64 tensors of 32-bit values that
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def PRNGKey(seed, device=None):
    """The raw key of an integer seed (jax.random.PRNGKey): an int64
    tensor [2] on `device` (None: the card; every later call runs where
    its key is). The seed is taken as a 32-bit integer, as jax takes a
    Python int with 64-bit types disabled."""
    s = int(np.int64(seed).astype(np.int32))
    key = torch.zeros(2, dtype=torch.int64, device=get_device(device))
    key[1] = s & _MASK            # a fill: no host-to-device copy
    return key


def _words(key):
    key = torch.as_tensor(key)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has a last axis of 2, got {tuple(key.shape)}")
    key = key.long()
    return key[..., 0], key[..., 1]


def split(key, num=2):
    """`num` new keys from a key [2]: [num, 2]."""
    draws["split"] += 1
    k1, k2 = _words(key)
    if k1.dim():
        raise ValueError("split takes one key; fold_in takes a batch")
    c = torch.arange(int(num), dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(c), c)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data):
    """A new key from a key and a 32-bit integer. Batched: keys [..., 2]
    and data [...] (or a Python int) broadcast together, as
    `jax.vmap(jax.random.fold_in)` does."""
    draws["fold_in"] += 1
    k1, k2 = _words(key)
    if isinstance(data, torch.Tensor):
        d = data.to(k1.device).long() & _MASK
    else:
        d = torch.full((), int(data) & _MASK, dtype=torch.int64,
                       device=k1.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def bits(key, shape=()):
    """Raw uint32 bits (as int64) of `shape` under each key: a key [2]
    gives `shape`; keys [..., 2] give [..., *shape], each row drawn as
    the unbatched call draws it (`jax.vmap` of `jax.random.bits`)."""
    draws["bits"] += 1
    k1, k2 = _words(key)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    c = torch.arange(n, dtype=torch.int64, device=k1.device).reshape(shape)
    lead = k1.shape
    k1 = k1.reshape(lead + (1,) * len(shape))
    k2 = k2.reshape(lead + (1,) * len(shape))
    b1, b2 = threefry2x32(k1, k2, c >> 32, c & _MASK)
    return b1 ^ b2


def _fma64(a, b, c):
    """a * b + c rounded once to float32 (an f32 fused multiply-add): the
    float64 product of two f32 values is exact."""
    return (a.double() * b + c).float()


def _xla_log(x):
    """log of positive finite f32 values, bit-equal to XLA's CPU log:
    Cephes' polynomial on the mantissa in [sqrt(1/2), sqrt(2)), with the
    multiply-adds LLVM fuses (the polynomial's and y * x^3 + q1 * e)."""
    f32 = torch.float32
    x = torch.clamp_min(x.to(f32), float(np.finfo(np.float32).tiny))
    b = x.view(torch.int32).long()
    e = ((b >> 23) - 127).float() + 1.0
    m = ((b & 0x807FFFFF) | 0x3F000000).to(torch.int32).view(f32)
    low = m < 0.707106781186547524
    m = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.float()
    m2 = m * m
    m3 = m2 * m
    c = [float(np.float32(v)) for v in (
        7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
        -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
        2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)]
    y = _fma64(m, c[0], c[1])
    y1 = _fma64(m, c[3], c[4])
    y2 = _fma64(m, c[6], c[7])
    y = _fma64(y, m, c[2])
    y1 = _fma64(y1, m, c[5])
    y2 = _fma64(y2, m, c[8])
    y = _fma64(y, m3, y1)
    y = _fma64(y, m3, y2)
    y = _fma64(y, m3, (float(np.float32(-2.12194440e-4)) * e).double())
    out = (m - m2 * 0.5) + y
    return _fma64(e, 0.693359375, out.double())


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0):
    """Uniform f32 values in [minval, maxval) (jax.random.uniform); keys
    may be batched as in `bits`."""
    if dtype != torch.float32:
        raise NotImplementedError("uniform draws float32 only")
    r = bits(key, shape)
    f = ((r >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=f.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, _fma64(f, (hi - lo).double(), lo.double()))


def gumbel(key, shape=(), dtype=torch.float32):
    """Standard Gumbel f32 values (jax.random.gumbel, mode "low")."""
    tiny = float(np.finfo(np.float32).tiny)
    u = uniform(key, shape, dtype, minval=tiny, maxval=1.0)
    return -_xla_log(-_xla_log(u))


def categorical(key, logits, axis=-1):
    """Draw indices from softmax(logits) along `axis` by the Gumbel-max
    trick (jax.random.categorical): argmax(gumbel + logits), int64. A key
    [2] draws noise of the logits' whole shape; keys [..., 2] whose batch
    shape leads the logits' draw one row each (`jax.vmap` over keys and
    logits)."""
    logits = torch.as_tensor(logits)
    k = torch.as_tensor(key)
    nb = k.dim() - 1
    if tuple(k.shape[:-1]) != tuple(logits.shape[:nb]):
        raise ValueError(f"keys {tuple(k.shape)} do not lead logits "
                         f"{tuple(logits.shape)}")
    g = gumbel(k.to(logits.device), logits.shape[nb:], logits.dtype)
    return torch.argmax(g + logits, dim=axis)
