"""The port's AdamW update (paddle_tpu_torch.ops.fused_ops: the plain
version of the CUDA AdamW kernel, and the optimizer `AdamW` that runs it
on every parameter) against the JAX package: `fused_adamw`, whose Pallas
kernel runs in interpret mode on the CPU, over several steps, and the
JAX `AdamW` rule (`apply_gradients_pytree`) with the global-norm clip,
bf16 slots and f32 master weights.

Tolerances, each with its reason:
  * f32 within 1e-6 (|p| <= ~4 here, so a few f32 ulps): against the
    JAX kernel the same operations in the same order, rounded by another
    backend; against the JAX rule the decay sits inside the update's
    bracket instead of in a second subtraction, one extra rounding a
    step.
  * bf16 within one bf16 ulp of the reference's value: both sides compute
    in f32 and round once, and an f32 value on a rounding boundary may
    round either way.
  * the clip folded into the update against a clip followed by an
    update: bit-equal (the same f32 product, rounded to g's dtype).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.ops.fused_ops import fused_adamw as jax_fused_adamw
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import fused_ops as X
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-3


def _ulp_close(got, want, err_msg=""):
    """|got - want| within one bf16 ulp of want (want held in f32)."""
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(want), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    err = np.abs(np.asarray(got, np.float32) - want)
    assert (err <= ulp).all(), (err_msg, float((err / ulp).max()))


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _to_torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_update_matches_pallas_kernel(dtype, wd):
    """4 steps of the port's `fused_adamw` (the kernel's plain version on
    the CPU) against the JAX `fused_adamw` in interpret mode, p, m and v
    all in `dtype`, 3000 elements (no multiple of the JAX block). Each
    step starts both sides from the JAX state of the step before, so
    each comparison holds one update's rounding: XLA contracts `b1 * m +
    (1 - b1) * g` into an FMA on the CPU, and a bf16 slot that rounded
    the other way at one step would carry its ulp into the next."""
    rng = np.random.RandomState(0)
    p = rng.randn(3000).astype(np.float32)
    grads = [rng.randn(3000).astype(np.float32) * 2 for _ in range(4)]
    td = getattr(torch, dtype)
    jp, jm, jv = (_to_jax(a, dtype) for a in (p, 0 * p, 0 * p))
    X.reset_counts()
    for step, g in enumerate(grads, 1):
        tp, tm, tv = (_to_torch(np.asarray(a.astype(jnp.float32)), td)
                      for a in (jp, jm, jv))
        jp, jm, jv = jax_fused_adamw(jp, _to_jax(g, dtype), jm, jv, step,
                                     LR, weight_decay=wd, interpret=True)
        tp, tm, tv = X.fused_adamw(tp, _to_torch(g, td), tm, tv, step, LR,
                                   weight_decay=wd)
        for got, want, name in ((tp, jp, "p"), (tm, jm, "m"),
                                (tv, jv, "v")):
            assert got.dtype == td
            want = np.asarray(want.astype(jnp.float32))
            if dtype == "float32":
                np.testing.assert_allclose(got.numpy(), want, atol=1e-6,
                                           rtol=0, err_msg=f"{name} {step}")
            else:
                _ulp_close(got.float().numpy(), want, f"{name} {step}")
    assert X.adamw_plain_launches == 4 and X.adamw_kernel_launches == 0


@pytest.mark.parametrize("pdtype,acc_dtype,multi_precision", [
    ("float32", None, False), ("float32", "bfloat16", False),
    ("bfloat16", "bfloat16", True), ("bfloat16", None, False)])
def test_adamw_optimizer_matches_jax_rule(pdtype, acc_dtype,
                                          multi_precision):
    """3 steps of the port's CPU `AdamW` (clip 1.0, wd 0.1) against the
    JAX `AdamW.apply_gradients_pytree`: f32 parameters and f32 master
    copies within 1e-6, bf16 parameters and bf16 slots within one ulp."""
    rng = np.random.RandomState(4)
    shapes = {"w": (64, 48), "b": (48,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 3).astype(np.float32) for k, s in
              shapes.items()} for _ in range(3)]
    kw = dict(learning_rate=LR, weight_decay=0.1,
              multi_precision=multi_precision, accumulator_dtype=acc_dtype)
    jo = jopt.AdamW(grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), **kw)
    jp = {k: _to_jax(v, pdtype) for k, v in p0.items()}
    state = jo.init_state_pytree(jp)
    for g in grads:
        jp, state = jo.apply_gradients_pytree(
            jp, {k: _to_jax(v, pdtype) for k, v in g.items()}, state)
    td = getattr(torch, pdtype)
    to = AdamW(grad_clip=ClipGradByGlobalNorm(1.0), **kw)
    tp = [_to_torch(p0[k], td) for k in shapes]
    X.reset_counts()
    for g in grads:
        to.apply_gradients(list(zip(tp, [_to_torch(g[k], td)
                                         for k in shapes])))
    assert X.adamw_plain_launches == 3 * len(shapes)
    for t, k in zip(tp, shapes):
        slots = to._state[t]
        assert t.dtype == td and ("master" in slots) == multi_precision
        assert slots["moment1"].dtype == (torch.bfloat16 if acc_dtype
                                          else torch.float32)
        want = np.asarray(jp[k].astype(jnp.float32))
        if pdtype == "float32":
            np.testing.assert_allclose(t.numpy(), want, atol=1e-6, rtol=0,
                                       err_msg=k)
        else:
            _ulp_close(t.float().numpy(), want, k)
        if multi_precision:
            np.testing.assert_allclose(
                slots["master"].numpy(),
                np.asarray(state["slots"][k]["master"]), atol=1e-6, rtol=0,
                err_msg=k)
        for slot in ("moment1", "moment2"):
            got = slots[slot].float().numpy()
            ref = np.asarray(state["slots"][k][slot].astype(jnp.float32))
            if acc_dtype:
                _ulp_close(got, ref, f"{k}.{slot}")
            else:
                np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6,
                                           err_msg=f"{k}.{slot}")


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
def test_clip_scale_folded_equals_clip_then_update(gdtype):
    """The clip's scale passed to the update equals the clip's own pass
    (scale in f32, round to g's dtype) followed by an unclipped update:
    bit for bit, with bf16 p and slots and f32 gradients too."""
    rng = np.random.RandomState(1)
    grads = [_to_torch(rng.randn(*s).astype(np.float32) * 5, gdtype)
             for s in ((40, 24), (24,))]
    clip = ClipGradByGlobalNorm(1.0)
    scale = clip.scale(grads)
    assert float(scale) < 1.0
    clipped = [cg for _, cg in clip([(torch.zeros_like(g), g)
                                     for g in grads])]
    for g, cg in zip(grads, clipped):
        p0 = _to_torch(rng.randn(*g.shape).astype(np.float32),
                       torch.bfloat16)
        states = []
        for gv, s in ((g, scale), (cg, None)):
            p = p0.clone()
            m, v = torch.zeros_like(p), torch.zeros_like(p)
            X.adamw_update_(p, gv, m, v, LR, 0.9, 0.999, 1e-8, 0.01, 0.1,
                            0.001, scale=s)
            states.append((p, m, v))
        for a, b in zip(*states):
            assert torch.equal(a, b)


def test_adam_keeps_the_eager_rule():
    """`Adam` (L2 decay, which the AdamW kernel has no term for) does not
    go through the fused update."""
    from paddle_tpu_torch.optimizer import Adam
    p = torch.ones(16, 8)
    X.reset_counts()
    Adam(LR, weight_decay=0.1).apply_gradients([(p, torch.ones(16, 8))])
    assert X.adamw_plain_launches == 0 and not torch.equal(
        p, torch.ones(16, 8))


@pytest.mark.parametrize("bad,err", [
    (dict(p_dtype=torch.float16), TypeError),
    (dict(v_dtype=torch.bfloat16), TypeError),
    (dict(g_len=15), ValueError),
    (dict(master_dtype=torch.bfloat16), TypeError),
    (dict(scale_len=2), TypeError),
])
def test_kernel_operand_checks(bad, err):
    """The CUDA wrapper checks its operands before any launch."""
    p = torch.zeros(16, dtype=bad.get("p_dtype", torch.float32))
    g = torch.zeros(bad.get("g_len", 16))
    m = torch.zeros(16)
    v = torch.zeros(16, dtype=bad.get("v_dtype", torch.float32))
    master = (torch.zeros(16, dtype=bad["master_dtype"])
              if "master_dtype" in bad else None)
    scale = torch.ones(bad["scale_len"]) if "scale_len" in bad else None
    with pytest.raises(err):
        X._adamw_launch(p, g, m, v, master, scale,
                        (LR, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001))
