"""The port's hash dropout (`paddle_tpu_torch.ops.dropout`, which
`nn.functional.dropout` takes) against the JAX package's `F.dropout` in
the working dtypes, on the CPU, where the wrapper runs the kernel's plain
version `_hash_dropout_ref`:
  * bf16 and f16 at p 0.1, 0.3, 0.5: values and the vjp bit-equal to
    JAX's, whose weakly typed scalar 1 - p takes x's dtype (the divisor
    is bf16(0.9) = 0.8984375 at p 0.1, not 0.9);
  * the autograd function on CPU tensors in both modes, f32 and bf16,
    and the `axis` form (mask alone, then a broadcast where), bit-equal;
  * a bert_tiny bf16 forward with dropout 0.1 on the hidden states and
    the attention probabilities, within the bf16 tolerance of
    test_torch_bert.py's `test_bf16_forward_matches_jax`;
  * the port's `_dropout_res_ln_ref` (widths off the 128 grid) in bf16
    at p 0.1 against the JAX `_dropout_res_ln_ref` on the port's mask
    (fed to JAX by replacing `jax.random.bernoulli` in the test),
    bit-equal;
  * the launch counters: a CPU call counts one plain forward and one
    plain backward, eval and p 0 count nothing, the axis form one plain
    mask.
Masks are integers and compared exactly; every float here is one
IEEE-rounded division and one rounding to the working dtype on both
sides, so values are compared bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as JB
from paddle_tpu.nn.functional import common as JC
from paddle_tpu.ops import attention as JA
from paddle_tpu.ops import fused_ops as JX
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models import state_dict_from_numpy
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import dropout as D
from paddle_tpu_torch.ops import fused_ops as X

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
MODES = ("upscale_in_train", "downscale_in_infer")


def _salt(key):
    return int(jax.random.randint(key, (), 0, 2 ** 31 - 1))


@pytest.fixture
def same_salt(monkeypatch):
    """Both packages draw the salt of one JAX key for every call."""
    key = jax.random.PRNGKey(11)
    monkeypatch.setattr(JC, "next_key", lambda: key)
    monkeypatch.setattr(F, "_draw_salt", lambda generator=None: _salt(key))
    return _salt(key)


def _pair(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _jax_dropout(x, g, dtype, p, axis=None, mode="upscale_in_train"):
    """The JAX `F.dropout` of x (cast to `dtype`) and its vjp of g, as
    f32 numpy arrays."""
    jx = paddle.to_tensor(jnp.asarray(x).astype(dtype), stop_gradient=False)
    jy = JC.dropout(jx, p, axis, True, mode)
    (jy * paddle.to_tensor(jnp.asarray(g).astype(dtype))).sum().backward()
    return (np.asarray(jy.numpy()).astype(np.float32),
            np.asarray(jx.grad.numpy()).astype(np.float32))


def _port_dropout(x, g, dtype, p, axis=None, mode="upscale_in_train"):
    tx = torch.from_numpy(x).to(DTYPES[dtype]).requires_grad_()
    ty = F.dropout(tx, p, axis, True, mode)
    (dx,) = torch.autograd.grad(ty, tx, torch.from_numpy(g).to(tx.dtype))
    assert ty.dtype == dx.dtype == tx.dtype
    return ty.detach().float().numpy(), dx.float().numpy()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("p", [0.1, 0.3, 0.5])
def test_low_precision_values_and_vjp_equal_jax(dtype, p, same_salt):
    """BERT's activations at [64, 768]: the port divides by 1 - p rounded
    to x's dtype, as JAX does, and its gradient is the JAX vjp."""
    x, g = _pair((64, 768), dtype)
    want_y, want_dx = _jax_dropout(x, g, dtype, p)
    got_y, got_dx = _port_dropout(x, g, dtype, p)
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got_dx, want_dx)
    assert 0 < (got_y == 0).mean() < 1


def test_bf16_divisor_is_rounded_to_bf16():
    """At p 0.1 a kept bf16 x is divided by bf16(0.9) = 0.8984375."""
    assert D._divisor_value(0.1, torch.bfloat16) == 0.8984375
    assert D._divisor_value(0.1, torch.float32) == float(np.float32(0.9))
    x = torch.full((4096,), 1.0, dtype=torch.bfloat16)
    y = D._hash_dropout_ref(x, 7, 0.1)
    kept = y[y != 0].float()
    want = float(torch.tensor(1 / 0.8984375).bfloat16())
    assert kept.numel() and bool((kept == want).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_autograd_function_on_cpu_equals_jax(dtype, mode, same_salt):
    """`hash_dropout` on CPU tensors (the plain version, forward and
    backward) in both modes against the JAX `F.dropout` and its vjp."""
    x, g = _pair((3, 17, 65), dtype, seed=1)
    want_y, want_dx = _jax_dropout(x, g, dtype, 0.3, mode=mode)
    tx = torch.from_numpy(x).to(DTYPES[dtype]).requires_grad_()
    D.reset_counts()
    ty = D.hash_dropout(tx, 0.3, same_salt, mode == MODES[0])
    (dx,) = torch.autograd.grad(ty, tx, torch.from_numpy(g).to(tx.dtype))
    assert D.dropout_plain_launches == {"hash_dropout": 1,
                                        "hash_dropout_bwd": 1,
                                        "hash_dropout_mask": 0}
    np.testing.assert_array_equal(ty.detach().float().numpy(), want_y)
    np.testing.assert_array_equal(dx.float().numpy(), want_dx)


@pytest.mark.parametrize("axis", [0, [0, 2]])
@pytest.mark.parametrize("mode", MODES)
def test_axis_form_bf16_equals_jax(axis, mode, same_salt):
    """The `axis` form in bf16: the mask of `mask_shape` (the mask
    kernel's plain version here), broadcast by a where, values and vjp
    bit-equal to JAX's."""
    x, g = _pair((6, 5, 33), "bfloat16", seed=2)
    want_y, want_dx = _jax_dropout(x, g, "bfloat16", 0.4, axis, mode)
    D.reset_counts()
    got_y, got_dx = _port_dropout(x, g, "bfloat16", 0.4, axis, mode)
    assert D.dropout_plain_launches["hash_dropout_mask"] == 1
    assert D.dropout_plain_launches["hash_dropout"] == 0
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got_dx, want_dx)


def test_bert_tiny_bf16_forward_with_dropout_matches_jax(monkeypatch):
    """bert_tiny (hidden 128, 2 heads: the flash route), bf16, hidden and
    attention dropout 0.1 in train mode, one JAX key's salt for every
    hidden dropout and one seed for every attention dropout in both
    packages: logits within 2^-7 of their largest magnitude plus 2^-7
    (test_torch_bert.py's bf16 tolerance)."""
    key = jax.random.PRNGKey(3)
    monkeypatch.setattr(JC, "next_key", lambda: key)
    monkeypatch.setattr(F, "_draw_salt", lambda generator=None: _salt(key))
    monkeypatch.setattr(JA, "_next_seed", lambda: 4321)
    monkeypatch.setattr(F, "_next_seed", lambda generator=None: 4321)
    kw = dict(hidden_size=128, num_heads=2, hidden_dropout=0.1,
              attention_dropout=0.1, dtype="bfloat16")
    paddle.seed(7)
    jm = JB.BertForPretraining(JB.bert_tiny(**kw))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    model = TB.BertForPretraining(TB.bert_tiny(**kw), device="cpu")
    model.load_state_dict(state_dict_from_numpy(state, device="cpu"))
    model.train()
    rng = np.random.RandomState(2)
    ids = rng.randint(1, 1024, (2, 64)).astype("int32")
    mask = (np.arange(64)[None] < np.array([[64], [50]])).astype("int32")
    jout = jm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(mask))
    D.reset_counts()
    with torch.no_grad():
        out = model(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask))
    assert D.dropout_plain_launches["hash_dropout"] == 1 + 2 * 2
    for got, want in zip(out, jout):
        want = np.asarray(want.numpy(), np.float32)
        np.testing.assert_allclose(
            got.float().numpy(), want, rtol=0,
            atol=2.0 ** -7 * (1 + np.abs(want).max()))


def test_dropout_res_ln_ref_bf16_equals_jax_ref(monkeypatch):
    """The port's `_dropout_res_ln_ref` (h 200, off the kernel's grid) in
    bf16 at p 0.1 against the JAX `_dropout_res_ln_ref` on the same mask
    (the port's hash mask handed to JAX in place of its bernoulli draw):
    h and out bit-equal."""
    p, seed, (n, h) = 0.1, 5, (32, 200)
    x, r = _pair((n, h), "bfloat16", seed=3)
    w, b = _pair((h,), "float32", seed=4)
    keep = (X._hash_bits(seed, (n, h)) <= X._keep_thresh(p)).numpy()
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda k, q, shape: jnp.asarray(keep))
    jo, jh = JX._dropout_res_ln_ref(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(r).astype(jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(b), jax.random.PRNGKey(0), p, 1e-5, True)
    X.reset_counts()
    out, hv = X.fused_dropout_residual_layer_norm(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(r).bfloat16(),
        torch.from_numpy(w), torch.from_numpy(b), p=p, seed=seed)
    assert X.drln_plain_launches == 1
    assert out.dtype == hv.dtype == torch.bfloat16
    np.testing.assert_array_equal(hv.float().numpy(),
                                  np.asarray(jh).astype(np.float32))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(jo).astype(np.float32))


def test_launch_counters():
    """CPU tensors count plain launches by name and never a kernel one;
    eval and p 0 launch nothing."""
    x = torch.randn(4, 256, requires_grad=True)
    D.reset_counts()
    F.dropout(x, 0.1).sum().backward()
    F.dropout(x, 0.1, training=False)
    F.dropout(x, 0.0)
    assert D.dropout_plain_launches == {"hash_dropout": 1,
                                        "hash_dropout_bwd": 1,
                                        "hash_dropout_mask": 0}
    F.dropout(x, 0.1, axis=1)
    assert D.dropout_plain_launches["hash_dropout_mask"] == 1
    assert not any(D.dropout_kernel_launches.values())
    D.reset_counts()
    assert not any(D.dropout_plain_launches.values())


def test_kernel_wrapper_checks_operands():
    """The CUDA wrapper refuses a dtype the kernel does not take and a
    strided operand before any launch."""
    with pytest.raises(TypeError):
        D._launch("hash_dropout", torch.zeros(8, dtype=torch.float64), 1,
                  0.1, True)
    with pytest.raises(ValueError):
        D._launch("hash_dropout", torch.zeros(8, 8).t(), 1, 0.1, True)
