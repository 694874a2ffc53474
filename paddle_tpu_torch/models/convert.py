"""Carry a JAX model's weights into the port.

`state_dict_from_numpy` takes the dict `{name: numpy array}` exactly as
the JAX package hands out a model's state
(`{k: np.asarray(v._value) for k, v in model.state_dict().items()}`:
parameters and persistable buffers, such as BatchNorm's `_mean` and
`_variance`) and returns torch tensors under the same names, so the same
weights compute the same thing in both packages: a port `GPT`, BERT or
`ResNet` takes them with
`model.load_state_dict(state_dict_from_numpy(np_state))`, each cast to
its parameter's or buffer's dtype (f32 or bf16, numpy's bfloat16
exactly).
"""
import numpy as np
import torch

from ..device import get_device

__all__ = ["state_dict_from_numpy"]


def _tensor(arr):
    """A CPU tensor of `arr`; numpy's bfloat16 extension type (which
    torch cannot read) goes through float32, exactly."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).bfloat16()
    return torch.from_numpy(arr)


def state_dict_from_numpy(np_state, device=None, dtype=None):
    """{name: array} -> {name: tensor} on `device`; `dtype` (a torch
    dtype) casts every tensor, None keeps each array's own dtype."""
    dev = get_device(device)
    return {k: _tensor(v).to(dev, dtype) for k, v in np_state.items()}
