"""Optimizers and LR schedulers of the training path (counterpart of
`paddle_tpu/optimizer`)."""
from . import lr
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr"]
