"""Gradient clipping (counterpart of `paddle_tpu/nn/clip.py`).

Each clip takes `(param, grad)` pairs (`clip(params_grads)`, Paddle's
calling form) and returns them clipped: a `None` gradient and a
parameter with `need_clip=False` pass through unclipped (and stay out of
a global norm). `clip_pytree({name: grad})` is the Trainer's form (the
JAX `clip_pytree`): every gradient is clipped, and the MoE clip's
predicate sees the parameter's dotted name. Norms are summed in f32;
each clipped gradient is computed in f32 and cast back to its own dtype.
"""
import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "ClipGradForMOEByGlobalNorm"]


def _clipped(p, g):
    """Whether the pair's gradient is clipped (the JAX eager rule)."""
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        """[(param, grad), ...] -> the same pairs, gradients clipped."""
        return [(p, self._clip_one(g) if _clipped(p, g) else g)
                for p, g in params_grads]

    def clip_pytree(self, grads):
        """{name: grad} -> {name: clipped grad}, every gradient clipped."""
        return {k: self._clip_one(g) for k, g in grads.items()}

    def _clip_one(self, g):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every element to [min, max]; `min` defaults to -max."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_one(self, g):
        return g.clamp(self.min, self.max)


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient on its own by min(clip_norm / max(||g||_2,
    1e-12), 1)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_one(self, g):
        g32 = g.float()
        norm = torch.sqrt(g32.square().sum())
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return (g32 * scale).to(g.dtype)


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every clipped gradient by min(clip_norm / max(||g||_2,
    1e-12), 1), where ||g||_2 is the norm of all clipped gradients
    together. `group_name` and `auto_skip_clip` are accepted and change
    nothing, as in JAX."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _sq(self, grads, tags):
        """The f32 squared norm of `grads`; `tags` (parameters or names,
        one a gradient) matter only to the MoE clip."""
        return sum(g.float().square().sum() for g in grads)

    def scale(self, grads, tags=None):
        """The f32 scale factor (a 0-d tensor, on the gradients' device)
        for these gradients, `tags` their parameters or names. `AdamW`
        folds it into its fused update, which scales and rounds each
        gradient as the clip does, without a pass over every gradient
        and without fetching the scale."""
        grads = list(grads)
        tags = [None] * len(grads) if tags is None else list(tags)
        norm = torch.sqrt(self._sq(grads, tags))
        return torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                           max=1.0)

    def _scaled(self, g, s):
        return (g.float() * s).to(g.dtype)

    def __call__(self, params_grads):
        pairs = list(params_grads)
        kept = [(p, g) for p, g in pairs if _clipped(p, g)]
        if not kept:
            return pairs
        s = self.scale([g for _, g in kept], [p for p, _ in kept])
        return [(p, self._scaled(g, s) if _clipped(p, g) else g)
                for p, g in pairs]

    def clip_pytree(self, grads):
        if not grads:
            return dict(grads)
        s = self.scale(grads.values(), grads.keys())
        return {k: self._scaled(g, s) for k, g in grads.items()}


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    """MoE-aware global-norm clip (reference
    `incubate/distributed/models/moe/grad_clip.py`): expert and dense
    gradients form ONE global norm, the expert part summed across the
    expert-parallel group. `is_expert_param_func(param_or_name) -> bool`
    selects the expert gradients: it receives the parameter on the pair
    path and the dotted name on the Trainer's path (`clip_pytree`), as
    in JAX. The port runs on one card without a mesh, so the experts'
    squared norm is already whole there and needs no collective over
    `moe_axis`; the two parts are summed in the JAX order (dense, then
    expert)."""

    def __init__(self, clip_norm, is_expert_param_func=None,
                 moe_axis="ep", group_name="default_moe_group"):
        super().__init__(clip_norm, group_name)
        self.is_expert = is_expert_param_func or (lambda p: False)
        self.moe_axis = moe_axis

    def _sq(self, grads, tags):
        sq_normal, sq_moe = 0.0, 0.0
        for g, tag in zip(grads, tags):
            s = g.float().square().sum()
            if self.is_expert(tag):
                sq_moe = sq_moe + s
            else:
                sq_normal = sq_normal + s
        return torch.as_tensor(sq_normal + sq_moe, dtype=torch.float32)
