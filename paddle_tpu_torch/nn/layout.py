"""Global data-format (layout) switch (counterpart of
`paddle_tpu/nn/layout.py`).

`set_channels_last(True)` flips the default layout of every conv, norm
and pool layer and functional whose `data_format` the caller left
unspecified, from channel-first ("NCHW") to channel-last ("NHWC").
Explicit `data_format=...` arguments always win. Layers resolve the
default at construction, so flipping the switch later does not change a
model already built.

On the card the port runs an NHWC tensor through PyTorch as its NCHW
permutation, which is a `channels_last` tensor, so the channel-last
layout needs no copy there.
"""
__all__ = ["set_channels_last", "channels_last_enabled", "resolve_data_format"]

# process-global, as in the JAX package: layers snapshot their layout at
# construction
_state = {"flag": False}

_CHANNEL_FIRST = {1: "NCL", 2: "NCHW", 3: "NCDHW"}
_CHANNEL_LAST = {1: "NLC", 2: "NHWC", 3: "NDHWC"}


def set_channels_last(flag=True):
    """Make channel-last the default layout for layers and functionals
    that were not given an explicit data_format. Returns the previous
    setting."""
    prev = channels_last_enabled()
    _state["flag"] = bool(flag)
    return prev


def channels_last_enabled():
    return _state["flag"]


def resolve_data_format(data_format, n_spatial):
    """None -> the current default for `n_spatial` dims; explicit strings
    pass through untouched."""
    if data_format is not None:
        return data_format
    table = _CHANNEL_LAST if channels_last_enabled() else _CHANNEL_FIRST
    return table[n_spatial]
