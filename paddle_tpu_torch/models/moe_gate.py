"""MoE gate family (counterpart of `paddle_tpu/models/moe_gate.py`;
reference `incubate/distributed/models/moe/gate/{naive,switch,gshard}_gate.py`).

A gate is a routing policy over the router logits: it owns no
parameters (the router projection lives in `MoEMLP`) and plugs into the
k-round selection loop of `models/moe.py` through two hooks:
  select_logits(logits, key, train)  -> logits used for argmax selection
  keep_round(k, gate_val, key, train) -> per-token keep mask or None

* `NaiveTopKGate` — plain top-k (k rounds of argmax), uniform keep.
* `SwitchGate` — top-1; in training the raw scores get additive uniform
  noise in [1-eps, 1+eps].
* `GShardGate` — top-2; in training the second expert is kept with
  probability min(1, 2*g2) per token (dropped when 2*g2 < u).

The noise is drawn with the port's threefry (`random.uniform`), bit-equal
to `jax.random.uniform` for the same key. `draws_random(train)` (the
port's own) says whether a policy reads its keys, so that the dispatch
derives none for a policy that does not.
"""
import torch

from .. import random

__all__ = ["NaiveTopKGate", "SwitchGate", "GShardGate", "make_gate"]


class NaiveTopKGate:
    """Plain top-k routing (reference naive_gate.py)."""

    name = "topk"

    def __init__(self, top_k=2):
        self.top_k = int(top_k)

    @property
    def normalize_combine(self):
        """Renormalize combine weights over the selected experts. False
        for top-1: the renormalized weight degenerates to 1, killing the
        router's task-loss gradient (Switch scales by the raw prob)."""
        return self.top_k > 1

    def draws_random(self, train):
        return False

    def select_logits(self, logits, key, train):
        return logits

    def keep_round(self, k, gate_val, key, train):
        return None


class SwitchGate(NaiveTopKGate):
    """Top-1 routing with training-time jitter (reference
    switch_gate.py: `noise = rand*2*eps + 1 - eps; score += noise`)."""

    name = "switch"

    def __init__(self, switch_eps=0.1):
        super().__init__(top_k=1)
        self.switch_eps = float(switch_eps)

    def draws_random(self, train):
        return bool(train)

    def select_logits(self, logits, key, train):
        if not train:
            return logits
        noise = random.uniform(key, logits.shape, torch.float32,
                               1.0 - self.switch_eps, 1.0 + self.switch_eps)
        return logits + noise


class GShardGate(NaiveTopKGate):
    """Top-2 with random second-expert routing (reference
    gshard_gate.py): token i's 2nd expert is dropped when
    2 * g2_i < uniform_i — i.e. kept with probability min(1, 2*g2)."""

    name = "gshard"

    def __init__(self, random_routing=True):
        super().__init__(top_k=2)
        self.random_routing = random_routing

    def draws_random(self, train):
        return bool(train and self.random_routing)

    def keep_round(self, k, gate_val, key, train):
        # training-time regularizer only: inference stays deterministic
        if k == 0 or not self.random_routing or not train:
            return None
        u = random.uniform(key, gate_val.shape, torch.float32)
        return (2.0 * gate_val) >= u


def make_gate(gate, cfg):
    """Gate factory: `gate` is a policy instance or one of
    "topk" | "switch" | "gshard" (config knobs taken from MoEConfig)."""
    if not isinstance(gate, str):
        return gate
    if gate == "topk":
        return NaiveTopKGate(top_k=cfg.top_k)
    if gate == "switch":
        return SwitchGate(switch_eps=cfg.switch_eps)
    if gate == "gshard":
        return GShardGate(random_routing=cfg.random_routing)
    raise ValueError(
        f"unknown MoE gate {gate!r}: expected 'topk', 'switch', 'gshard' "
        "or a gate policy instance")
