"""The port's multi-tensor AdamW update (paddle_tpu_torch.ops.fused_ops.
adamw_update_multi, the plain path of the multi-tensor CUDA kernel
`csrc/adamw.cu`, and the optimizer `AdamW`, which makes one such call per
group of parameters that share their dtypes and master copy) against the
per-tensor update and the JAX package.

- Over a mixed list (odd sizes, a 1-element tensor, an empty one, f32 and
  bf16 groups, a group with f32 master copies), with and without a clip
  scale: every tensor bit-equal to a per-tensor `adamw_update_` from the
  same state. On the CPU both routes run the same plain update tensor by
  tensor, so this checks only that the multi-tensor call hands each
  tensor its own state, clip scale and bias corrections, in order; the
  kernel's bits are held to the per-tensor launches on the card by
  chip_smoke.py.
- Against the JAX `fused_adamw` (its Pallas kernel in interpret mode),
  one step at a time from the JAX state of the step before, at
  tests/test_torch_adamw.py's tolerances: f32 within 1e-6, bf16 within
  one bf16 ulp of the JAX value (both round an f32 value once; XLA
  contracts `b1 * m + (1 - b1) * g` into an FMA on the CPU).
- The optimizer groups by (p, g, slot dtypes, master) and calls the
  multi-tensor update once per group; 3 Trainer steps of gpt_tiny with
  it are bit-equal, losses and parameters, to the same steps with one
  `adamw_update_` a parameter (`paddle_tpu_torch.testing.PerTensorAdamW`,
  the route chip_smoke.py replays on the card). On the CPU this too
  checks the grouping and order only, as above.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.fused_ops import fused_adamw as jax_fused_adamw
from paddle_tpu_torch.distributed import LossBuffer, Trainer
from paddle_tpu_torch.models import GPT, GPTPretrainingCriterion, gpt_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import fused_ops as X
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import optimizer as O
from paddle_tpu_torch.testing import PerTensorAdamW

HYPER = (1e-3, 0.9, 0.999, 1e-8, 0.1)           # lr, b1, b2, eps, wd
STEP = 3
F32, BF16 = torch.float32, torch.bfloat16
SIZES = (1, 7, 300, 4097, 0)


def _bc(step):
    return tuple(1.0 - b ** step for b in HYPER[1:3])


def _ulp_close(got, want, err_msg=""):
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(want), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    err = np.abs(np.asarray(got, np.float32) - want)
    assert (err <= ulp).all(), (err_msg, float((err / ulp).max()))


def _group(rng, pd, gd, sd, master):
    """(p, g, m, v, master) for every size of SIZES, m and v as Adam
    leaves them (|m| < sqrt(v))."""
    out = []
    for n in SIZES:
        p = rng.randn(n).astype(np.float32)
        m = rng.randn(n).astype(np.float32) * 1e-2
        v = 4 * m * m + (rng.randn(n).astype(np.float32) * 1e-2) ** 2
        g = rng.randn(n).astype(np.float32) * 3
        out.append((torch.from_numpy(p).to(pd), torch.from_numpy(g).to(gd),
                    torch.from_numpy(m).to(sd), torch.from_numpy(v).to(sd),
                    torch.from_numpy(p.copy()) if master else None))
    return out


# the groups of a mixed list: (p, g, slot dtypes, f32 master)
GROUPS = [(F32, F32, F32, False), (BF16, BF16, BF16, False),
          (BF16, BF16, F32, True), (BF16, F32, BF16, False)]


def _clone(group):
    return [tuple(None if t is None else t.clone() for t in e) for e in group]


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("pd,gd,sd,master", GROUPS)
def test_multi_is_bit_equal_to_per_tensor(pd, gd, sd, master, clip):
    rng = np.random.RandomState(5)
    group = _group(rng, pd, gd, sd, master)
    scale = torch.tensor(0.37) if clip else None
    multi, single = _clone(group), _clone(group)
    X.reset_counts()
    X.adamw_update_multi(*zip(*[e[:4] for e in multi]), *HYPER, *_bc(STEP),
                         masters=[e[4] for e in multi], scale=scale)
    assert X.adamw_plain_launches == len(SIZES)
    for p, g, m, v, ma in single:
        X.adamw_update_(p, g, m, v, *HYPER, *_bc(STEP), master=ma,
                        scale=scale)
    assert X.adamw_kernel_launches == 0
    for a, b, before in zip(multi, single, group):
        assert a[0].dtype == pd and a[2].dtype == sd
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)
        if before[0].numel():
            assert not torch.equal(a[2], before[2])     # it was updated


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_multi_matches_pallas_kernel_step_by_step(dtype):
    """3 steps over the mixed sizes in one call a step, each tensor
    against the JAX `fused_adamw` in interpret mode from the JAX state of
    the step before."""
    rng = np.random.RandomState(6)
    sizes = [n for n in SIZES if n]
    jname = "float32" if dtype == F32 else "bfloat16"
    jstate = [[jnp.asarray(rng.randn(n).astype(np.float32)).astype(jname),
               jnp.zeros(n, jname), jnp.zeros(n, jname)] for n in sizes]
    lr, b1, b2, eps, wd = HYPER
    for step in range(1, 4):
        grads = [rng.randn(n).astype(np.float32) * 2 for n in sizes]
        # copies: the update writes in place, and np.asarray shares the
        # JAX buffer
        tstate = [[torch.tensor(np.asarray(a.astype(jnp.float32))).to(dtype)
                   for a in st] for st in jstate]
        X.adamw_update_multi([s[0] for s in tstate],
                             [torch.from_numpy(g).to(dtype) for g in grads],
                             [s[1] for s in tstate], [s[2] for s in tstate],
                             lr, b1, b2, eps, wd, 1.0 - b1 ** step,
                             1.0 - b2 ** step)
        jstate = [list(jax_fused_adamw(st[0], jnp.asarray(g).astype(jname),
                                       st[1], st[2], step, lr, beta1=b1,
                                       beta2=b2, eps=eps, weight_decay=wd,
                                       interpret=True))
                  for st, g in zip(jstate, grads)]
        for got_t, want_t in zip(tstate, jstate):
            for got, want in zip(got_t, want_t):
                want = np.asarray(want.astype(jnp.float32))
                if dtype == F32:
                    np.testing.assert_allclose(got.numpy(), want, atol=1e-6,
                                               rtol=0)
                else:
                    _ulp_close(got.float().numpy(), want, f"step {step}")


def test_optimizer_calls_once_per_group(monkeypatch):
    """Parameters of three dtype groups (f32; bf16 with f32 masters; bf16
    with f32 gradients and masters), interleaved: one multi-tensor call a
    group a step, each with its own tensors in order."""
    calls = []
    real = O.adamw_update_multi

    def spy(params, grads, ms, vs, *args, masters=None, **kw):
        calls.append(([id(p) for p in params],
                      {(p.dtype, g.dtype, m.dtype, ma is not None)
                       for p, g, m, ma in zip(params, grads, ms, masters)}))
        return real(params, grads, ms, vs, *args, masters=masters, **kw)

    monkeypatch.setattr(O, "adamw_update_multi", spy)
    rng = np.random.RandomState(8)
    params = [torch.from_numpy(rng.randn(n).astype(np.float32)).to(d)
              for n, d in ((5, F32), (6, BF16), (7, F32), (8, BF16),
                           (9, BF16))]
    grads = [torch.ones_like(p) for p in params]
    grads[4] = grads[4].float()
    opt = AdamW(1e-3, multi_precision=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    opt.apply_gradients(params, grads)
    assert [ids for ids, _ in calls] == [
        [id(params[0]), id(params[2])], [id(params[1]), id(params[3])],
        [id(params[4])]]
    assert [keys for _, keys in calls] == [
        {(F32, F32, F32, False)}, {(BF16, BF16, F32, True)},
        {(BF16, F32, F32, True)}]


@pytest.mark.parametrize("acc_dtype", [None, "bfloat16"])
def test_trainer_steps_bit_equal_to_per_tensor_route(acc_dtype):
    cfg = gpt_tiny(num_heads=2, max_seq_len=64, dtype="float32")
    ids = np.random.RandomState(9).randint(0, cfg.vocab_size, (2, 65))
    batch = {"input_ids": ids[:, :-1].astype("int32"),
             "labels": ids[:, 1:].astype("int32")}
    crit = GPTPretrainingCriterion()
    runs = []
    for cls in (AdamW, PerTensorAdamW):
        model = GPT(cfg, device="cpu", seed=0)
        opt = cls(1e-3, weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0),
                  accumulator_dtype=acc_dtype)
        tr = Trainer(model, opt, lambda m, b: crit(m(b["input_ids"]),
                                                   b["labels"]),
                     device="cpu")
        buf = LossBuffer(drain_every=3)
        for _ in range(3):
            buf.append(tr.step(batch))
        runs.append((buf.losses, model.state_dict()))
    (l1, s1), (l2, s2) = runs
    assert l1 == l2
    assert set(s1) == set(s2)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
