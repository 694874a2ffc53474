"""Incubating APIs (counterpart of `paddle_tpu/incubate`): the MoE
namespace."""
from . import moe

__all__ = ["moe"]
