"""Weight-decay regularizers (counterpart of `paddle_tpu/regularizer.py`).

An optimizer given one as `weight_decay` reads its coefficient and adds
coeff * p to each gradient, for `L1Decay` too: that is what the JAX
`Optimizer` does with any decay object (it reads `_coeff`), so the port
does the same. Called on a parameter, each gives its own term (coeff *
sign(p) for L1), as the JAX classes do."""
import torch

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self.coeff = self._coeff

    def __call__(self, param):
        return self._coeff * torch.sign(param)


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self.coeff = self._coeff

    def __call__(self, param):
        return self._coeff * param
