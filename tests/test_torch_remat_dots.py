"""remat 'dots' in the port's GPT (`remat_policy="dots"`: a non-reentrant
`torch.utils.checkpoint` whose selective-checkpoint policy saves the
block's `mm` / `addmm` products that a backward reads and recomputes the
rest) against the JAX 'dots' policy and against the port's own 'full'
remat, on `gpt_tiny`
(2 heads, so head_dim 64 takes the flash route) on the CPU.

Tolerances, each with its reason:
  * against JAX: loss within 1e-5 and every gradient within 1e-6 (the
    same f32 weights and batch; matmuls summed in other orders, ~1e-6
    relative, on gradients of at most ~0.1).
  * 'dots' against 'full' inside the port: bit-equal, f32 and bf16 (the
    saved products are the forward's own values, and the recompute runs
    the same CPU ops on the same inputs).
"""
import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor as JaxTensor
from paddle_tpu.models import GPT as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn.layer_base import functional_call, state_pytree
from paddle_tpu_torch.models import (GPT, GPTPretrainingCriterion, gpt_tiny,
                                     state_dict_from_numpy)
from paddle_tpu_torch.models import gpt as gpt_mod

CFG = dict(num_heads=2, max_seq_len=128)


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


def _batch(B=2, L=128, seed=0):
    ids = np.random.RandomState(seed).randint(0, 1024, (B, L + 1))
    return ids[:, :-1].astype("int32"), ids[:, 1:].astype("int32")


def _np_state(jmodel):
    return {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}


def _port(np_state, policy, dtype="float32"):
    m = GPT(gpt_tiny(remat_policy=policy, dtype=dtype, **CFG), device="cpu")
    m.load_state_dict(state_dict_from_numpy(np_state, device="cpu"))
    if dtype == "bfloat16":
        m = m.bfloat16()
    return m


def _loss_and_grads(model, x, y):
    model.zero_grad(set_to_none=True)
    loss = GPTPretrainingCriterion()(model(torch.from_numpy(x)),
                                     torch.from_numpy(y))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def test_dots_matches_jax_dots():
    paddle.seed(7)
    jmodel = JaxGPT(jax_gpt_tiny(remat_policy="dots", dtype="float32",
                                 **CFG))
    x, y = _batch()
    params = state_pytree(jmodel)

    def f(p):
        with functional_call(jmodel, p):
            return JaxCriterion()(jmodel(JaxTensor(x)),
                                  JaxTensor(y))._value

    jloss, jgrads = jax.value_and_grad(f)(params)
    loss, grads = _loss_and_grads(_port(_np_state(jmodel), "dots"), x, y)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=0)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dots_bit_equal_to_full(dtype):
    paddle.seed(3)
    np_state = _np_state(JaxGPT(jax_gpt_tiny(dtype="float32", **CFG)))
    x, y = _batch(seed=1)
    want_loss, want = _loss_and_grads(_port(np_state, "full", dtype), x, y)
    loss, got = _loss_and_grads(_port(np_state, "dots", dtype), x, y)
    assert torch.equal(loss, want_loss)
    for k in want:
        assert torch.equal(got[k], want[k]), k


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_saves_the_products_and_nothing_else(monkeypatch):
    """What each policy keeps from the forward:
    * tensors the autograd graph saves outside the checkpointed blocks
      (counted by a `saved_tensors_hooks` pack hook): the same under
      'dots' as under 'full' — nothing of the attention or LayerNorm
      outputs on top;
    * tensors the selective checkpoint caches (counted by wrapping the
      policy): under 'dots' the three Linear products of each block
      whose outputs a backward reads (qkv [B*L, 3h], proj [B*L, h], fc1
      [B*L, 4h]), and no other op's — not fc2's, which feeds only the
      residual add, whose backward needs no input;
    * in the backward, 'full' reruns 3 products of each block (qkv,
      proj, fc1: the recompute stops before fc2) and 'dots' none, while
      both rerun the attention (its plain version's batched `bmm`)."""
    paddle.seed(3)
    np_state = _np_state(JaxGPT(jax_gpt_tiny(dtype="float32", **CFG)))
    x, y = _batch(seed=2)
    B, L = x.shape
    h, n_layers = 128, 2
    cached = []

    def counting(ctx, op, *args, **kwargs):
        decision = gpt_mod._save_dots(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            cached.append((op, tuple(args[-2].shape[:1]) +
                           tuple(args[-1].shape[1:])))
        return decision

    monkeypatch.setattr(gpt_mod, "_dots_context", functools.partial(
        create_selective_checkpoint_contexts, counting))
    saved, backward_ops = {}, {}
    for policy in ("full", "dots"):
        model = _port(np_state, policy)
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = GPTPretrainingCriterion()(model(torch.from_numpy(x)),
                                             torch.from_numpy(y))
        saved[policy] = sorted(shapes)
        with _OpCount() as mode:
            loss.backward()
        backward_ops[policy] = mode.counts
    assert saved["dots"] == saved["full"]
    want = [(torch.ops.aten.addmm.default, (B * L, n))
            for n in (3 * h, h, 4 * h)] * n_layers
    assert cached == want
    addmm = torch.ops.aten.addmm.default
    assert backward_ops["full"].get(addmm, 0) == 3 * n_layers
    assert backward_ops["dots"].get(addmm, 0) == 0
    bmm = torch.ops.aten.bmm.default
    assert backward_ops["dots"][bmm] == backward_ops["full"][bmm] > 0
