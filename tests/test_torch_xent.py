"""The port's streaming softmax cross-entropy
(paddle_tpu_torch.ops.fused_ops) against the JAX package's Pallas
kernels in interpret mode: loss and lse against `_xent_fwd_impl`, dx
against `_xent_bwd_impl`; and the port's `GPTPretrainingCriterion`
(fused route, with -100 labels) against the JAX criterion, loss and
gradient.

Tolerances: f32 logits of magnitude ~3 over a vocab of 1024-2048; the
running max/sum walks the same vocab blocks on both sides, so loss and
lse agree within 1e-5, and so does dx: |dx| <= |g| (up to ~3 here),
and an lse a few f32 ulps apart moves exp(x - lse) by as many ulps. The criterion's
mean over valid rows within 1e-6, its gradient within 1e-8 (entries
~1/(N*V)).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.ops import fused_ops as JX
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.ops import fused_ops as X


def _inputs(n, v, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n, v) * 3).astype(np.float32),
            rng.randint(0, v, n).astype(np.int32),
            rng.randn(n).astype(np.float32))


@pytest.mark.parametrize("n,v", [(256, 1024), (512, 2048), (256, 384)])
def test_forward_backward_match_pallas_interpret(n, v):
    x, lab, g = _inputs(n, v)
    jloss, jlse = JX._xent_fwd_impl(jnp.asarray(x), jnp.asarray(lab),
                                    interpret=True)
    jdx = JX._xent_bwd_impl(jnp.asarray(x), jnp.asarray(lab), jlse,
                            jnp.asarray(g), interpret=True)
    tx = torch.from_numpy(x).requires_grad_()
    X.reset_counts()
    loss, lse = X.fused_softmax_cross_entropy(tx, torch.from_numpy(lab))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0],
                               atol=1e-5, rtol=0)
    loss.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               atol=1e-5, rtol=0)
    assert X.plain_launches == {"xent_fwd": 1, "xent_bwd": 1}
    assert sum(X.kernel_launches.values()) == 0


def test_can_fuse_xent_is_the_jax_shape_rule():
    assert X.can_fuse_xent(8192, 50304)
    assert not X.can_fuse_xent(8000, 50304)            # rows off 256
    assert not X.can_fuse_xent(256, 1000)              # no 128 divisor
    assert X.can_fuse_xent(256, 384)


def test_criterion_matches_jax_with_ignored_labels():
    """Fused route (N = 512 rows, V = 1024) against the JAX criterion,
    which takes its cross_entropy route on the CPU: the same loss."""
    x, lab, _ = _inputs(512, 1024, seed=1)
    lab[::7] = -100
    logits = x.reshape(2, 256, 1024)
    labels = lab.reshape(2, 256)
    jcrit = JaxCriterion()

    def jloss(lg):
        return jcrit(paddle.to_tensor(lg), paddle.to_tensor(labels))._value
    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    X.reset_counts()
    got = GPTPretrainingCriterion()(tl, torch.from_numpy(labels))
    got.backward()
    assert X.plain_launches["xent_fwd"] == 1
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad),
                               atol=1e-8, rtol=0)


def test_criterion_unfused_route():
    """Rows off the 256 grid take `F.cross_entropy`."""
    x, lab, _ = _inputs(100, 1024, seed=2)
    lab[:5] = -100
    X.reset_counts()
    got = GPTPretrainingCriterion()(torch.from_numpy(x)[None],
                                    torch.from_numpy(lab)[None])
    assert sum(X.plain_launches.values()) == 0
    logp = torch.log_softmax(torch.from_numpy(x), -1)
    keep = torch.from_numpy(lab) >= 0
    want = -logp[keep, torch.from_numpy(lab)[keep].long()].mean()
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("bad,err", [
    (dict(labels=torch.int64), TypeError),
    (dict(logits=torch.float16), TypeError),
    (dict(n_labels=3), ValueError),
])
def test_kernel_operand_checks(bad, err):
    """The CUDA wrappers check their operands before any launch."""
    logits = torch.zeros(4, 256, dtype=bad.get("logits", torch.float32))
    labels = torch.zeros(bad.get("n_labels", 4),
                         dtype=bad.get("labels", torch.int32))
    with pytest.raises(err):
        X._check(logits, labels)
