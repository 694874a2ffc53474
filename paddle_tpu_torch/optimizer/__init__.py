"""Optimizers of the training path (counterpart of
`paddle_tpu/optimizer`)."""
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]
