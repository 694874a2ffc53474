"""Weight quantization recipe (counterpart of `paddle_tpu/quantization.py`
`quantize_weight`): per-channel symmetric integer weights with f32
scales. The serving decoder's W4A16 packer (`ops.w4_matmul.quantize_w4`)
comes through here, as in the JAX package.
"""
import torch

__all__ = ["quantize_weight"]


def quantize_weight(w, axis=0, bits=8):
    """w [in, out] float -> (int8 w_q, f32 scale) per channel, symmetric;
    `bits` sets the grid (8 -> +-127, 4 -> +-7). The f32 amax over `axis`
    gives scale = max(amax / qmax, 1e-8), then q = clip(round(w / scale)).
    It divides (a multiply by the reciprocal rounds differently) and
    `torch.round` rounds half to even like `jnp.round`, so the same f32
    input gives the JAX package's bytes and scales."""
    qmax = float(2 ** (bits - 1) - 1)
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax / qmax, 1e-8)
    q = torch.clamp(torch.round(w32 / scale), -qmax, qmax).to(torch.int8)
    return q, scale
