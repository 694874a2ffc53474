"""Optimizers (counterpart of `paddle_tpu/optimizer/optimizer.py`).

The update follows the JAX `Optimizer.apply_gradients_pytree`: the step
count starts at 1; the gradient clip runs first, over all gradients;
each parameter's update is computed in f32 from the parameter (or from
its f32 `master` copy when `multi_precision` is set and the parameter is
bf16/fp16); moment slots are stored in `accumulator_dtype` (default
f32); the result is cast back to the parameter's dtype and written in
place. The learning rate is a constant (schedulers are not ported).

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
import numpy as np
import torch

from ..ops.fused_ops import adamw_update_multi

__all__ = ["Optimizer", "Adam", "AdamW"]

_LOW = (torch.bfloat16, torch.float16)


def _dtype(name):
    if name is None or isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


class Optimizer:
    _slot_names = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 accumulator_dtype=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported: pass a float")
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._acc_dtype = _dtype(accumulator_dtype)
        self._wd = float(weight_decay or 0.0)
        self._state = {}              # param -> {slot: tensor}
        self._step_count = 0

    def get_lr(self):
        return self._learning_rate

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

    @torch.no_grad()
    def apply_gradients(self, params, grads, lr=None):
        """One update of `params` (in place) from `grads`, in the same
        order, eagerly in f32; weight decay is L2 (added to the
        gradient)."""
        lr = self.get_lr() if lr is None else float(lr)
        self._step_count += 1
        step = self._step_count
        params, grads = list(params), list(grads)
        if self._grad_clip is not None:
            grads = self._grad_clip(grads)
        for p, g in zip(params, grads):
            slots = self._slots(p)
            master = slots.get("master")
            pv = master if master is not None else p.float()
            gv = g.float()
            if self._wd:
                gv = gv + self._wd * pv
            f32 = {n: slots[n].float() for n in self._slot_names}
            new_p, new_slots = self._update_rule(pv, gv, f32, lr, step)
            for n, v in new_slots.items():
                slots[n] = v.to(slots[n].dtype)
            if master is not None:
                slots["master"] = new_p
            p.copy_(new_p.to(p.dtype))


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

    @torch.no_grad()
    def apply_gradients(self, params, grads, lr=None):
        """One update of `params` (in place) from `grads`: the clip's
        scale, then one fused multi-tensor AdamW update per group of
        parameters that share their dtypes and master copy."""
        lr = self.get_lr() if lr is None else float(lr)
        self._step_count += 1
        params, grads = list(params), list(grads)
        scale = (self._grad_clip.scale(grads)
                 if self._grad_clip is not None and grads else None)
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
