"""Gradient clipping (counterpart of `paddle_tpu/nn/clip.py`)."""
import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scale every gradient by min(clip_norm / max(||g||_2, 1e-12), 1),
    where ||g||_2 is the norm of all gradients together. The squared norm
    is summed in f32 over every gradient; each gradient is scaled in f32
    and cast back to its own dtype (the JAX `clip_pytree`)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def scale(self, grads):
        """The f32 scale factor (a 0-d tensor, on the gradients' device)
        for these gradients. `AdamW` passes it to its fused update, which
        scales and rounds each gradient as `__call__` does, without this
        pass over every gradient and without fetching the scale."""
        sq = sum(g.float().square().sum() for g in grads)
        norm = torch.sqrt(sq)
        return torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                           max=1.0)

    def __call__(self, grads):
        """[g, ...] -> [clipped g, ...]."""
        grads = list(grads)
        if not grads:
            return grads
        s = self.scale(grads)
        return [(g.float() * s).to(g.dtype) for g in grads]
