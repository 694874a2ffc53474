"""Kernels of the port: each module holds a plain PyTorch version, the
wrapper of its hand-written CUDA kernel (`csrc/`) and launch counters.
Import the modules themselves (`from paddle_tpu_torch.ops import
ragged_paged_attention as rpa`) so their counters read live."""
