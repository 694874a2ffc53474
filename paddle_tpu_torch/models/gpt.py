"""GPT configuration, presets and a seeded random state dict
(counterpart of `paddle_tpu/models/gpt.py`).

Only what the serving slice needs: the config, its parameter count,
the presets, and `init_state_dict`, which makes the JAX `GPT`'s state
dict (same keys, same shapes, Paddle's `[in, out]` Linear layout) from
a seeded `torch.Generator`. The training forward and flash attention
are not ported yet.
"""
import dataclasses
import math

import torch

from ..device import get_device

__all__ = ["GPTConfig", "init_state_dict", "gpt_tiny", "gpt_125m",
           "gpt_350m", "gpt_760m", "gpt_1p3b"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: int = 0              # 0 -> 4*hidden
    max_seq_len: int = 1024
    dtype: str = "bfloat16"          # compute dtype of the serving path
    tie_embeddings: bool = True
    init_std: float = 0.02

    def __post_init__(self):
        if self.ffn_hidden == 0:
            self.ffn_hidden = 4 * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    def num_params(self):
        h, L, v = self.hidden_size, self.num_layers, self.vocab_size
        per_block = (4 * h * h + 2 * h * self.ffn_hidden + 9 * h
                     + 2 * self.ffn_hidden)
        return v * h + self.max_seq_len * h + L * per_block + 2 * h


def init_state_dict(cfg, seed=0, device=None):
    """Random float32 weights with the JAX `GPT`'s keys and shapes, drawn
    from one `torch.Generator` seeded with `seed` on `device`: N(0,
    init_std) for embeddings, qkv and fc1; N(0, init_std/sqrt(2L)) for
    the residual-out projections (proj, fc2); LayerNorm weights 1 and
    every bias 0 — the JAX model's initializers. The numbers differ from
    JAX's for the same seed (another generator); parity tests carry the
    JAX weights across with `models.convert.state_dict_from_numpy`."""
    dev = get_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    h, f = cfg.hidden_size, cfg.ffn_hidden
    std, out_std = cfg.init_std, cfg.init_std / math.sqrt(2.0 * cfg.num_layers)

    def normal(shape, s):
        return torch.empty(shape, dtype=torch.float32, device=dev).normal_(
            0.0, s, generator=g)

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    sd = {"wte.weight": normal((cfg.vocab_size, h), std),
          "wpe.weight": normal((cfg.max_seq_len, h), std)}
    for i in range(cfg.num_layers):
        p = f"blocks.{i}."
        sd[p + "ln1.weight"] = const((h,), 1.0)
        sd[p + "ln1.bias"] = const((h,), 0.0)
        sd[p + "qkv.weight"] = normal((h, 3 * h), std)
        sd[p + "qkv.bias"] = const((3 * h,), 0.0)
        sd[p + "proj.weight"] = normal((h, h), out_std)
        sd[p + "proj.bias"] = const((h,), 0.0)
        sd[p + "ln2.weight"] = const((h,), 1.0)
        sd[p + "ln2.bias"] = const((h,), 0.0)
        sd[p + "fc1.weight"] = normal((h, f), std)
        sd[p + "fc1.bias"] = const((f,), 0.0)
        sd[p + "fc2.weight"] = normal((f, h), out_std)
        sd[p + "fc2.bias"] = const((h,), 0.0)
    sd["ln_f.weight"] = const((h,), 1.0)
    sd["ln_f.bias"] = const((h,), 0.0)
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = normal((h, cfg.vocab_size), std)
    return sd


def _preset(kw, **defaults):
    """Config factory body: caller kwargs override the preset's fields."""
    defaults.update(kw)
    return GPTConfig(**defaults)


def gpt_tiny(**kw):
    return _preset(kw, vocab_size=1024, hidden_size=128, num_layers=2,
                   num_heads=4, max_seq_len=256)


def gpt_125m(**kw):
    return _preset(kw, hidden_size=768, num_layers=12, num_heads=12)


def gpt_350m(**kw):
    return _preset(kw, hidden_size=1024, num_layers=24, num_heads=16)


def gpt_760m(**kw):
    return _preset(kw, hidden_size=1536, num_layers=24, num_heads=16)


def gpt_1p3b(**kw):
    return _preset(kw, hidden_size=2048, num_layers=24, num_heads=16)
