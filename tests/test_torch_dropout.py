"""The port's hash dropout (paddle_tpu_torch.nn.functional.dropout)
against the JAX package's `F.dropout`, bit for bit: for a salt drawn by
the JAX package's own rule (`randint(key, (), 0, 2**31 - 1)`), the
port's `_hash_keep(salt, shape, p)` equals the JAX `_hash_keep(key,
shape, p)` and `F.dropout` gives the same values (divide, then select)
and the same gradient; the salts come from the CPU generator a layer
holds; and GPT's attention dropout draws its seed outside the
activation recompute, so remat 'full' and 'none' train alike with
dropout on.

Everything is exact (the masks are integers; x / (1 - p) is one f32
division on both sides) except the GPT remat check, which compares one
package with itself bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.functional import common as JC
from paddle_tpu_torch.models import GPT, GPTPretrainingCriterion, gpt_tiny
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import attention as A


def _salt(key):
    return int(jax.random.randint(key, (), 0, 2 ** 31 - 1))


@pytest.mark.parametrize("shape", [(1000,), (2, 3, 17, 64)])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_hash_keep_equals_jax(shape, p):
    key = jax.random.PRNGKey(3)
    want = np.asarray(JC._hash_keep(key, shape, p))
    got = F._hash_keep(_salt(key), shape, p)
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_values_and_grad_equal_jax(p, monkeypatch):
    key = jax.random.PRNGKey(11)
    monkeypatch.setattr(JC, "next_key", lambda: key)
    monkeypatch.setattr(F, "_draw_salt", lambda generator=None: _salt(key))
    x = np.random.RandomState(0).randn(4, 33, 64).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = JC.dropout(jx, p)
    (jy * jy).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    ty = F.dropout(tx, p)
    (ty * ty).sum().backward()
    assert np.array_equal(ty.detach().numpy(), jy.numpy())
    np.testing.assert_array_equal(tx.grad.numpy(), jx.grad.numpy())


def test_dropout_layer_draws_salts_from_its_generator():
    x = torch.ones(8, 256)
    a = Dropout(0.3, generator=torch.Generator().manual_seed(5))
    b = Dropout(0.3, generator=torch.Generator().manual_seed(5))
    ya, yb = a(x), b(x)
    assert torch.equal(ya, yb)
    assert not torch.equal(a(x), ya)           # a new salt per call
    kept = float((ya != 0).float().mean())
    assert abs(kept - 0.7) < 0.03
    assert torch.equal(ya[ya != 0], torch.full_like(ya[ya != 0], 1 / 0.7))
    a.eval()
    assert a(x) is x


def test_gpt_dropout_remat_full_equals_none():
    """GPT with dropout 0.1 on the embeddings and the attention: remat
    'full' recomputes each block in the backward with the seed drawn
    before it, so it trains exactly as 'none' does."""
    b = np.random.RandomState(0).randint(0, 1024, (2, 129))
    batch = (torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:]))
    grads = []
    for policy in ("full", "none"):
        cfg = gpt_tiny(num_heads=2, max_seq_len=128, dtype="float32",
                       dropout=0.1, remat_policy=policy)
        model = GPT(cfg, device="cpu", seed=3)
        A.reset_counts()
        loss = GPTPretrainingCriterion()(model(batch[0]), batch[1])
        loss.backward()
        assert A.plain_launches["flash_fwd"] == (4 if policy == "full"
                                                 else 2)
        grads.append([p.grad for p in model.parameters()])
    for g1, g2 in zip(*grads):
        assert torch.equal(g1, g2)
