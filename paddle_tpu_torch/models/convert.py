"""Carry a JAX model's weights into the port.

`state_dict_from_numpy` takes the dict `{name: numpy array}` exactly as
the JAX `PagedGPTDecoder` reads its model (`{k: np.asarray(v._value)}`)
and returns torch tensors under the same names, so the same weights
compute the same thing in both packages.
"""
import numpy as np
import torch

from ..device import get_device

__all__ = ["state_dict_from_numpy"]


def state_dict_from_numpy(np_state, device=None, dtype=None):
    """{name: array} -> {name: tensor} on `device`; `dtype` (a torch
    dtype) casts every tensor, None keeps each array's own dtype."""
    dev = get_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev, dtype)
            for k, v in np_state.items()}
