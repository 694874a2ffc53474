"""Kernels of the port: each module holds a plain PyTorch version, the
wrapper of its hand-written CUDA kernel (`csrc/`) and launch counters.
Import the modules themselves (`from paddle_tpu_torch.ops import
ragged_paged_attention as rpa`) so their counters read live. As in the
JAX package, `block_sparse_attention` and `paged_attention` are
importable from here as modules, and `PagedKVCache` as a class."""
from . import block_sparse_attention, paged_attention  # noqa: F401
from .paged_attention import PagedKVCache

__all__ = ["block_sparse_attention", "paged_attention", "PagedKVCache"]
