"""Tensor manipulation of the ported paths (counterpart of
`paddle_tpu/tensor/manipulation.py`): `flatten`."""

__all__ = ["flatten"]


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """x with axes start_axis..stop_axis (negative counts from the end)
    merged into one; a 0-d x becomes [1]."""
    nd = x.dim()
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    return x.reshape(tuple(x.shape[:s]) + (-1,) + tuple(x.shape[e + 1:]))
