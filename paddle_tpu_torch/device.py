"""Device resolution for the PyTorch/CUDA port (counterpart of
`paddle_tpu/framework/device.py`).

Every entry point of the port takes `device=None`, which means the CUDA
card. Without CUDA such a call raises instead of carrying on quietly on
the CPU; the CPU runs only when the caller names it (`device="cpu"`, as
the tests do).
"""
import torch

__all__ = ["get_device", "cuda_available"]


def cuda_available():
    """True when PyTorch sees a CUDA device."""
    return torch.cuda.is_available()


def get_device(device=None):
    """Resolve `device` to a `torch.device`: None means "cuda". A CUDA
    device without CUDA raises. On CUDA, float32 matmuls are pinned to
    full float32 (TF32 off): the serving path's f32 logits
    (`x.float() @ lm_head`) and every f32 comparison against the JAX
    reference assume it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the "
                "CPU explicitly")
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
