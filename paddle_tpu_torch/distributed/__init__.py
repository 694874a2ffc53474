"""Training loop of the port (counterpart of `paddle_tpu/distributed`;
one card, no mesh)."""
from .trainer import LossBuffer, Trainer

__all__ = ["Trainer", "LossBuffer"]
