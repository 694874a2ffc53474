"""Carry a JAX model's weights into the port.

`state_dict_from_numpy` takes the dict `{name: numpy array}` exactly as
the JAX package hands out a model's state
(`{k: np.asarray(v._value) for k, v in model.state_dict().items()}`:
parameters and persistable buffers, such as BatchNorm's `_mean` and
`_variance`) and returns torch tensors under the same names, so the same
weights compute the same thing in both packages: a port `GPT`, BERT,
`ResNet` or `GPTMoE` (whose experts keep the JAX names and shapes,
`blocks.{i}.moe.gate_w` [h, E], `.w1` [E, h, f], ...) takes them with
`model.load_state_dict(state_dict_from_numpy(np_state))`, each cast to
its parameter's or buffer's dtype (f32 or bf16, numpy's bfloat16
exactly).

A quantized JAX model carries across the same way: its `quantize_model`,
`PTQ` or `QAT` buffers (`weight_q` int8 or packed int4 nibbles,
`weight_scale`, `act_scale`, the fake-quant observers' int32 `seen` and
f32 `scale`) keep their dtypes and 0-dim shapes, so the port's model,
quantized the same way (`paddle_tpu_torch.quantization`), takes them with
`load_state_dict` and computes what the JAX model computes;
`QuantizedLinearA8W8` rebuilds its K-contiguous weight copy on load.

`trainer_state_from_numpy` does the same for a JAX `Trainer.state()`
(parameters, optimizer slots and step counts under the model's names),
so a state saved by the JAX package resumes in the port's
`Trainer.load_state` (bf16 moment slots stay bf16).
"""
import numpy as np
import torch

from ..device import get_device

__all__ = ["state_dict_from_numpy", "trainer_state_from_numpy"]


def _tensor(arr, copy=True):
    """A CPU tensor of `arr`: a copy, or with `copy=False` a view of a
    writable array (for callers that copy it onward at once); numpy's
    bfloat16 extension type (which torch cannot read) goes through
    float32, exactly."""
    arr = np.array(arr) if copy else np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).bfloat16()
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def state_dict_from_numpy(np_state, device=None, dtype=None):
    """{name: array} -> {name: tensor} on `device`; `dtype` (a torch
    dtype) casts every floating-point tensor, None keeps each array's own
    dtype. Integer arrays (int8 quantized weights, int32 observer counts)
    keep theirs either way."""
    dev = get_device(device)
    out = {}
    for k, v in np_state.items():
        t = _tensor(v)
        out[k] = t.to(dev, dtype if dtype is not None
                      and t.is_floating_point() else t.dtype)
    return out


def trainer_state_from_numpy(jax_state, device=None):
    """A JAX `Trainer.state()` (numpy leaves; the JAX layout) -> the
    port's `Trainer.state()` tree with tensors on `device`, each leaf in
    its own dtype (bf16 slots stay bf16), step counts as ints. The JAX
    trainer's grad-transform state has no counterpart and raises."""
    if "gt_state" in jax_state:
        raise NotImplementedError("grad_transform state is not ported")
    dev = get_device(device)
    opt = jax_state["opt_state"]
    return {
        "params": {k: _tensor(v).to(dev)
                   for k, v in jax_state["params"].items()},
        "opt_state": {
            "slots": {n: {k: _tensor(v).to(dev) for k, v in s.items()}
                      for n, s in opt["slots"].items()},
            "step": int(np.asarray(opt["step"]))},
        "step": int(jax_state.get("step", 0))}
