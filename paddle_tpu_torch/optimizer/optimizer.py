"""Optimizers (counterpart of `paddle_tpu/optimizer/optimizer.py`).

The update follows the JAX `Optimizer.apply_gradients_pytree`: the step
count starts at 1; the gradient clip runs first, over all gradients;
each parameter's update is computed in f32 from the parameter (or from
its f32 `master` copy when `multi_precision` is set and the parameter is
bf16/fp16); the gradient is multiplied by `rescale_grad` (Momentum's),
then an L2 decay coeff * p is added to it (`weight_decay` a float, or a
`regularizer` object whose coefficient is read, as in JAX); slots are
stored in `accumulator_dtype` (default f32); the result is cast back to
the parameter's dtype once and written in place. The learning rate is a
float or an `lr.LRScheduler`, read once a step by `get_lr()` as a Python
float (the kernels and the f32 torch ops round it to f32 once, as the
JAX step's f32 `lr` argument is); `Trainer.step` advances the scheduler
after the update. `state_dict` / `set_state_dict` use the JAX layout:
`step`, `{index}.{slot}` (with `master` under `multi_precision`) and
`LR_Scheduler`. `SGD`, `Momentum` and `Adam` run
that rule per tensor, eagerly in f32 torch ops. `apply_gradients` takes
Paddle's `(param, grad)` pairs and hands them to the clip (the JAX
`apply_gradients`); the Trainer updates through `_apply_named`, whose
clip sees the parameters' dotted names (the JAX `apply_gradients_pytree`
with `clip_pytree`).

`AdamW` groups its parameters by the AdamW kernel's template arguments
(parameter, gradient and slot dtypes, master copy or not) and makes one
call of `ops.fused_ops.adamw_update_multi` per group: on the card, one
launch of the hand-written multi-tensor AdamW kernel for the whole
group (GPT's and BERT's lists are each one group), which reads and
writes p, m, v (and the master) in place and folds in the global-norm
clip's scale, read on the card, so the clip no longer rewrites every
gradient; on the CPU, the kernel's plain version tensor by tensor, the
same arithmetic. Every element's bits are those of a per-tensor
`adamw_update_`. It differs from the JAX `AdamW` rule only in rounding:
the decoupled decay sits inside the update's bracket, `p - lr *
(mhat / (sqrt(vhat) + eps) + wd * p)`, as in the JAX `fused_adamw`
kernel, not in a second subtraction. `Adam` (L2 decay added to the
gradient, which the kernel has no term for) keeps the eager per-tensor
f32 rule of `Optimizer.apply_gradients`.
"""
import copy

import numpy as np
import torch

from ..ops.fused_ops import adamw_update_multi
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]

_LOW = (torch.bfloat16, torch.float16)


def _dtype(name):
    if name is None or isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def _decay_coeff(weight_decay):
    """The L2 coefficient of `weight_decay`: None -> 0, a number, or a
    decay object's `_coeff` (`coeff`), as the JAX `Optimizer` reads it."""
    if weight_decay is None:
        return 0.0
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay)
    return float(getattr(weight_decay, "_coeff",
                         getattr(weight_decay, "coeff", 0.0)))


class Optimizer:
    _slot_names = ()
    _rescale_grad = 1.0

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 accumulator_dtype=None):
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError("learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate)}")
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._learning_rate = (learning_rate
                               if isinstance(learning_rate, LRScheduler)
                               else float(learning_rate))
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._acc_dtype = _dtype(accumulator_dtype)
        self._wd = _decay_coeff(weight_decay)
        self._state = {}              # param -> {slot: tensor}
        self._step_count = 0

    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self):
        return (self._learning_rate
                if isinstance(self._learning_rate, LRScheduler) else None)

    def bind(self, parameters):
        """Set the parameters this optimizer updates (the Trainer binds
        the model's when the optimizer was built without any)."""
        self._parameter_list = list(parameters)

    def _slots(self, p):
        st = self._state.get(p)
        if st is None:
            st = {n: torch.zeros(p.shape, device=p.device,
                                 dtype=self._acc_dtype or torch.float32)
                  for n in self._slot_names}
            if self._multi_precision and p.dtype in _LOW:
                st["master"] = p.detach().float()
            self._state[p] = st
        return st

    def _update_rule(self, p, g, slots, lr, step):
        """(new_p, new_slots) from f32 p, g and slots."""
        raise NotImplementedError

    def _slot_dtype(self, name):
        return (torch.float32 if name == "master"
                else self._acc_dtype or torch.float32)

    # -- checkpointing ------------------------------------------------------
    def state_dict(self):
        """{"step", "{i}.{slot}": tensor, "LR_Scheduler": dict}: the JAX
        layout, parameters named by their index in the parameter list
        (the JAX parameters' `name` is None, so the JAX keys are the
        same). Slots that do not exist yet are left out. A snapshot:
        the slots are copies (the AdamW kernel updates the live ones in
        place), as the JAX arrays are immutable."""
        out = {"step": self._step_count}
        for i, p in enumerate(self._parameter_list or []):
            for k, v in self._state.get(p, {}).items():
                out[f"{i}.{k}"] = v.detach().clone()
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = copy.deepcopy(
                self._lr_scheduler.state_dict())
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Restore a `state_dict` (tensors or numpy arrays): each slot
        onto its parameter's device in its configured dtype (a bf16 slot
        stays bf16; the f32 master stays f32), the step count and the
        scheduler's state."""
        from ..models.convert import _tensor
        self._step_count = int(state_dict.get("step", 0))
        names = self._slot_names + (("master",) if self._multi_precision
                                    else ())
        for i, p in enumerate(self._parameter_list or []):
            slots = {}
            for k in names:
                v = state_dict.get(f"{i}.{k}")
                if v is None:
                    continue
                if not isinstance(v, torch.Tensor):
                    v = _tensor(v, copy=False)
                if tuple(v.shape) != tuple(p.shape):
                    raise ValueError(f"slot {i}.{k} has shape "
                                     f"{tuple(v.shape)}, the parameter "
                                     f"{tuple(p.shape)}")
                slots[k] = v.to(p.device, self._slot_dtype(k), copy=True)
            if slots:
                self._state[p] = slots
        sched = self._lr_scheduler
        if "LR_Scheduler" in state_dict and sched is not None:
            sched.set_state_dict(dict(state_dict["LR_Scheduler"]))

    def _folds_clip(self, clip):
        """Whether `_update` takes a global-norm clip as a scale factor
        instead of clipped gradients (the fused AdamW does)."""
        return False

    @torch.no_grad()
    def apply_gradients(self, params_grads):
        """One update (in place) from `(param, grad)` pairs, Paddle's
        form (the JAX `Optimizer.apply_gradients`): the clip receives the
        pairs (a `None` gradient or a `need_clip=False` parameter passes
        it unclipped), then every parameter with a gradient is updated."""
        pairs = list(params_grads)
        self._clip_and_update(
            pairs, [p for p, _ in pairs], None,
            all(getattr(p, "need_clip", True) for p, _ in pairs),
            lambda clip: clip(pairs))

    @torch.no_grad()
    def _apply_named(self, names, params, grads, lr=None):
        """The Trainer's update (the JAX `apply_gradients_pytree` with
        `clip_pytree`): the clip sees every gradient under its
        parameter's dotted name."""
        params, names, grads = list(params), list(names), list(grads)
        self._clip_and_update(
            list(zip(params, grads)), names, lr, True,
            lambda clip: zip(params, clip.clip_pytree(
                dict(zip(names, grads))).values()))

    def _clip_and_update(self, pairs, tags, lr, may_fold, clip_pairs):
        """One step from `(param, grad)` pairs, `tags` their parameters
        or names for the clip: a global-norm clip's scale is folded into
        `_update` where the optimizer takes it so (`_folds_clip`) and
        `may_fold` holds, else `clip_pairs(clip)` gives the clipped
        pairs; every pair with a gradient is then updated."""
        lr = self.get_lr() if lr is None else float(lr)
        self._step_count += 1
        clip, scale = self._grad_clip, None
        if clip is not None:
            if may_fold and self._folds_clip(clip):
                kept = [(g, t) for (_, g), t in zip(pairs, tags)
                        if g is not None]
                if kept:
                    scale = clip.scale([g for g, _ in kept],
                                       [t for _, t in kept])
            else:
                pairs = clip_pairs(clip)
        pairs = [(p, g) for p, g in pairs if g is not None]
        self._update([p for p, _ in pairs], [g for _, g in pairs], lr, scale)

    def _update(self, params, grads, lr, scale):
        """Update `params` in place from clipped `grads`, eagerly in
        f32: the gradient rescaled, then the L2 decay added to it."""
        step = self._step_count
        for p, g in zip(params, grads):
            slots = self._slots(p)
            master = slots.get("master")
            pv = master if master is not None else p.float()
            gv = g.float()
            if self._rescale_grad != 1.0:
                gv = gv * self._rescale_grad
            if self._wd:
                gv = gv + self._wd * pv
            f32 = {n: slots[n].float() for n in self._slot_names}
            new_p, new_slots = self._update_rule(pv, gv, f32, lr, step)
            for n, v in new_slots.items():
                slots[n] = v.to(slots[n].dtype)
            if master is not None:
                slots["master"] = new_p
            p.copy_(new_p.to(p.dtype))


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, accumulator_dtype=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, accumulator_dtype)

    def _update_rule(self, p, g, slots, lr, step):
        return p - lr * g, {}


class Momentum(Optimizer):
    """v = momentum * v + g; p - lr * v, or p - lr * (g + momentum * v)
    with `use_nesterov`. The velocity is f32 (the JAX `Momentum` takes no
    `accumulator_dtype`); `use_multi_tensor` is accepted and changes
    nothing, as in JAX."""
    _slot_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov
        self._rescale_grad = float(rescale_grad)

    def _update_rule(self, p, g, slots, lr, step):
        v = self._momentum * slots["velocity"] + g
        if self._nesterov:
            new_p = p - lr * (g + self._momentum * v)
        else:
            new_p = p - lr * v
        return new_p, {"velocity": v}


class Adam(Optimizer):
    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, accumulator_dtype=None):
        if lazy_mode:
            raise NotImplementedError("Adam(lazy_mode=True) is not ported")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, accumulator_dtype)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _bias_corrections(self, step):
        """1 - beta^step in f32, as the JAX rule raises f32 betas to an
        f32 step."""
        return tuple(float(np.float32(1) - np.float32(b) ** np.float32(step))
                     for b in (self._beta1, self._beta2))

    def _update_rule(self, p, g, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g.square()
        bc1, bc2 = self._bias_corrections(step)
        new_p = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + self._epsilon)
        return new_p, {"moment1": m, "moment2": v}


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 accumulator_dtype=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError("AdamW's lr_ratio and "
                                      "apply_decay_param_fun are not ported")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode,
                         multi_precision, accumulator_dtype=accumulator_dtype)

    def _folds_clip(self, clip):
        return hasattr(clip, "scale")

    def _update(self, params, grads, lr, scale):
        """One fused multi-tensor AdamW update per group of parameters
        that share their dtypes and master copy, the global-norm clip's
        `scale` folded in."""
        bc1, bc2 = self._bias_corrections(self._step_count)
        groups = {}
        for p, g in zip(params, grads):
            slots = self._slots(p)
            master = slots.get("master")
            key = (p.device, p.dtype, g.dtype, slots["moment1"].dtype,
                   master is not None)
            groups.setdefault(key, []).append(
                (p, g, slots["moment1"], slots["moment2"], master))
        for group in groups.values():
            ps, gs, ms, vs, masters = zip(*group)
            adamw_update_multi(ps, gs, ms, vs, lr, self._beta1, self._beta2,
                               self._epsilon, self._wd, bc1, bc2,
                               masters=masters, scale=scale)
