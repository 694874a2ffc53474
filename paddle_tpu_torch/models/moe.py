"""Mixture-of-Experts GPT (counterpart of `paddle_tpu/models/moe.py`;
reference `incubate/distributed/models/moe`).

The JAX package dispatches tokens with one-hot `dispatch` / `combine`
tensors [T, E, C] and einsums. The port routes by index and keeps the
same padded [E, C] layout, so every shape stays static and nothing waits
for the card: each round of the k-round top-k loop records every token's
expert and its slot (its position in that expert's queue, after the
earlier rounds' tokens), the kept tokens are gathered into a zeroed
[E, C, h] buffer (a slot holds one token, so the copy is exact, as
JAX's einsum of a single 1.0 is), the experts run as batched products,
and each token gathers its top_k outputs back and sums them weighted, in
f32, rounded to x's dtype once. The semantics are JAX's:

- the router is x @ gate_w in f32, softmax in f32; a gate policy
  (`moe_gate.py`) may select on jittered logits (Switch) and drop a
  token from a round (GShard), while the combine weights and the aux
  loss use the clean probabilities;
- argmax takes the first index on ties; capacity C = max(1,
  int(capacity_factor * T * top_k / E)); round 0 fills every token's
  first slot before round 1 starts; a token whose position is >= C is
  dropped;
- top-k > 1 renormalizes the combine weights by the sum of every
  selected gate (counted before GShard's drop and before capacity); they
  are rounded to x's dtype before the combine;
- aux = E * sum(mean(probs, 0) * frac_tokens / top_k), frac_tokens
  counted after GShard's drop and before capacity;
- the keys: fold_in(key, T) then split gives the selection and routing
  keys, round k uses fold_in(routing key, k), and no key means key(0).
  In training `MoEMLP` draws its key from a threefry stream the model
  owns (the n-th forward takes fold_in(PRNGKey(seed), n)); JAX draws
  from the framework's global key counter, which other random ops also
  advance.

Gradients reach `gate_w` through the combine weights and the aux loss's
probabilities, never through the argmax or the masks. `GPTMoE` runs its
blocks without recompute whatever `cfg.remat` says, as in JAX; like
JAX's it has no untied head and no KV-cache decoding.
"""
import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn as tnn

from .. import random
from ..device import get_device
from ..nn import functional as F
from ..nn.initializer import Constant, Normal
from ..nn.layer import _param
from ..ops.attention import _next_seed
from .gpt import GPT, GPTBlock, GPTConfig
from .moe_gate import make_gate

__all__ = ["MoEConfig", "MoEMLP", "GPTMoEBlock", "GPTMoE", "MoERouting",
           "gpt_moe_tiny", "gpt_moe_small"]


@dataclasses.dataclass
class MoEConfig(GPTConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    moe_every: int = 2  # every Nth block gets an MoE MLP
    gate: str = "topk"  # "topk" | "switch" | "gshard" (moe_gate.py)
    switch_eps: float = 0.1       # SwitchGate training jitter
    random_routing: bool = True   # GShard random 2nd-expert drop

    def __post_init__(self):
        super().__post_init__()
        # "switch" is top-1, "gshard" top-2 by definition; keep top_k (the
        # FLOPs/capacity accounting input) consistent with the policy
        if isinstance(self.gate, str):
            if self.gate == "switch":
                self.top_k = 1
            elif self.gate == "gshard":
                self.top_k = 2
            elif self.gate != "topk":
                raise ValueError(
                    f"unknown MoE gate {self.gate!r}: "
                    "'topk', 'switch' or 'gshard'")
        else:
            # a policy instance defines its own k
            self.top_k = int(self.gate.top_k)

    def _n_moe_blocks(self):
        return sum(1 for i in range(self.num_layers)
                   if i % self.moe_every == self.moe_every - 1)

    def _expert_mlp_params(self):
        # one expert's FF: w1 [h,f] + b1 [f] + w2 [f,h] + b2 [h]
        h, f = self.hidden_size, self.ffn_hidden
        return 2 * h * f + f + h

    def num_params(self):
        # dense equivalent + per-MoE-block gate and the (E-1) extra experts
        # replacing that block's dense MLP
        extra = self._n_moe_blocks() * (
            self.hidden_size * self.num_experts
            + (self.num_experts - 1) * self._expert_mlp_params())
        return super().num_params() + extra

    def num_active_params(self):
        """Per-token activated parameters (backbone + gate + top_k of the
        E experts in each MoE block): the N of the 6N FLOPs a token."""
        extra = self._n_moe_blocks() * (
            self.hidden_size * self.num_experts
            + (self.top_k - 1) * self._expert_mlp_params())
        return super().num_params() + extra


class MoERouting(NamedTuple):
    """One dispatch's routing, detached: `experts`, `slots` and
    `weights` are [T, top_k] (round k in column k); `slots` is expert * C
    + position for a kept token and E * C for a dropped one; `selected`
    is False where the gate policy dropped the token from the round;
    `weights` are the f32 combine weights (0 where dropped)."""
    capacity: int
    experts: torch.Tensor
    selected: torch.Tensor
    keep: torch.Tensor
    slots: torch.Tensor
    weights: torch.Tensor
    aux: torch.Tensor


def _draws(gate_policy, train):
    """Whether the policy reads its keys (a policy without the port's
    `draws_random` is taken to)."""
    return getattr(gate_policy, "draws_random", lambda t: True)(train)


def _route(x, gate_w, num_experts, gate_policy, capacity_factor, key=None,
           train=False):
    """(combine weights [T, top_k] f32, aux f32, routing) for tokens x
    [T, H]; the weights and aux carry gradients to x and gate_w."""
    T = x.shape[0]
    E, K = num_experts, gate_policy.top_k
    C = max(1, int(capacity_factor * T * K / E))
    dev = x.device
    draws = _draws(gate_policy, train)
    sel_key = route_key = None
    if draws:
        if key is None:
            key = random.PRNGKey(0, device=dev)
        sel_key, route_key = random.split(random.fold_in(key, T))

    logits = x.float() @ gate_w.float()                          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    with torch.no_grad():
        remaining = torch.softmax(
            gate_policy.select_logits(logits.detach(), sel_key, train),
            dim=-1)
    base = torch.zeros(E, dtype=torch.long, device=dev)
    frac = torch.zeros(E, dtype=torch.float32, device=dev)
    gates, experts, selected, keeps, slots = [], [], [], [], []
    for k in range(K):
        with torch.no_grad():
            expert = torch.argmax(remaining, dim=-1)             # [T]
            onehot = torch.nn.functional.one_hot(expert, E)      # [T, E]
            remaining = remaining * (1.0 - onehot.float())
        # the combine weight comes from the CLEAN probs at the expert
        gate = probs.gather(1, expert[:, None])[:, 0]
        gates.append(gate)
        with torch.no_grad():
            extra = gate_policy.keep_round(
                k, gate.detach(),
                random.fold_in(route_key, k) if draws else None, train)
            if extra is None:
                sel = torch.ones(T, dtype=torch.bool, device=dev)
            else:
                sel = extra.bool()
                onehot = onehot * sel[:, None]
            frac = frac + onehot.float().mean(0)
            # position of each token within its expert's queue: the scan
            # runs along the tokens of each expert's row (a scan down the
            # columns of [T, E] gets E threads on the card)
            queue = onehot.t().contiguous()                      # [E, T]
            pos = (torch.cumsum(queue, 1) - queue + base[:, None]).gather(
                0, expert[None, :])[0]
            keep = (pos < C) & sel
            base = base + (onehot * keep[:, None]).sum(0)
            slots.append(torch.where(keep, expert * C + pos, E * C))
        experts.append(expert)
        selected.append(sel)
        keeps.append(keep)

    keep = torch.stack(keeps, 1)
    weights = torch.stack(gates, 1) * keep.float()
    if getattr(gate_policy, "normalize_combine", K > 1):
        # the renormalisation counts every SELECTED expert (g1 + g2),
        # before random drops and capacity
        gate_sum = gates[0]
        for g in gates[1:]:
            gate_sum = gate_sum + g
        weights = weights / torch.clamp(gate_sum, min=1e-9)[:, None]
    aux = E * (probs.mean(0) * frac / K).sum()
    routing = MoERouting(C, torch.stack(experts, 1),
                         torch.stack(selected, 1), keep,
                         torch.stack(slots, 1), weights.detach(),
                         aux.detach())
    return weights, aux, routing


def _experts(x, w1, b1, w2, b2, weights, routing):
    """y [T, H]: the kept tokens gathered into the [E, C, H] slots, the
    experts' FF (gelu, tanh form) as batched products, and each token's
    outputs weighted and summed in f32, rounded to x's dtype once.
    Unused slots and dropped tokens read rows spread over the tensor
    (masked to zero, or weighted 0), so that the gathers' backward adds
    its zeros without piling atomics onto one row."""
    T, H = x.shape
    E, C = w1.shape[0], routing.capacity
    n, dt, dev = E * C, x.dtype, x.device
    slots = routing.slots
    with torch.no_grad():
        token = torch.full((n + 1,), -1, dtype=torch.long, device=dev)
        token.scatter_(0, slots.reshape(-1), torch.arange(
            T, device=dev).repeat_interleave(slots.shape[1]))
        token = token[:n]
        used = token >= 0
        token = torch.where(used, token, torch.arange(n, device=dev) % T)
        pick = torch.where(routing.keep, slots, torch.arange(
            slots.numel(), device=dev).view_as(slots) % n)
    expert_in = torch.where(used[:, None], x.index_select(0, token), 0.0)
    expert_in = expert_in.view(E, C, H)
    h = F.gelu(torch.bmm(expert_in, w1.to(dt)) + b1[:, None, :].to(dt),
               approximate=True)
    out = (torch.bmm(h, w2.to(dt)) + b2[:, None, :].to(dt)).view(n, H)
    picked = out.index_select(0, pick.reshape(-1)).view(T, -1, H).float()
    y = (weights.to(dt).float()[:, :, None] * picked).sum(1)
    return y.to(dt)


def _moe_dispatch(x, gate_w, w1, b1, w2, b2, gate_policy, capacity_factor,
                  key=None, train=False):
    """x: [T, H] tokens. Returns (y [T, H], aux_loss f32 scalar), as the
    JAX `_moe_dispatch` does."""
    weights, aux, routing = _route(x, gate_w, w1.shape[0], gate_policy,
                                   capacity_factor, key, train)
    return _experts(x, w1, b1, w2, b2, weights, routing), aux


class _KeyStream:
    """A threefry key stream: draw n is fold_in(PRNGKey(seed), n). A
    draw whose key nobody reads advances the count without hashing."""

    def __init__(self, seed, device):
        self.seed, self.device, self.count = int(seed), device, 0
        self._base = None

    def next(self, materialize=True):
        n = self.count
        self.count += 1
        if not materialize:
            return None
        if self._base is None:
            self._base = random.PRNGKey(self.seed, device=self.device)
        return random.fold_in(self._base, n)


class MoEMLP(tnn.Module):
    """Drop-in MLP replacement: top-k routed experts. Parameters gate_w
    [h, E] and w1 [E, h, f] ~ N(0, init_std), w2 [E, f, h] ~ N(0,
    init_std / sqrt(2L)), b1 [E, f] and b2 [E, h] zero, drawn in that
    order from `generator`. Its training keys come from `keys`, a stream
    seeded with 0 that its owner may replace (`GPTMoE` gives all its
    layers one). `last_aux_loss` and `last_routing` hold the latest
    forward's."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        dev = get_device(device)
        h, f, E = cfg.hidden_size, cfg.ffn_hidden, cfg.num_experts
        init = Normal(0.0, cfg.init_std)
        out_init = Normal(0.0, cfg.init_std / math.sqrt(2.0 * cfg.num_layers))
        self.gate_w = _param((h, E), init, dev, generator)
        self.w1 = _param((E, h, f), init, dev, generator)
        self.b1 = _param((E, f), Constant(0.0), dev, generator)
        self.w2 = _param((E, f, h), out_init, dev, generator)
        self.b2 = _param((E, h), Constant(0.0), dev, generator)
        self.gate_policy = make_gate(cfg.gate, cfg)
        self.keys = _KeyStream(0, dev)
        self.last_aux_loss = None
        self.last_routing = None

    def forward(self, x):
        B, L, H = x.shape
        policy, train = self.gate_policy, self.training
        key = self.keys.next(_draws(policy, train)) if train else None
        flat = x.reshape(B * L, H)
        weights, aux, routing = _route(flat, self.gate_w, self.w1.shape[0],
                                       policy, self.cfg.capacity_factor, key,
                                       train)
        y = _experts(flat, self.w1, self.b1, self.w2, self.b2, weights,
                     routing)
        self.last_aux_loss = aux
        self.last_routing = routing
        return y.reshape(B, L, H)


class GPTMoEBlock(GPTBlock):
    """A GPT block; every `moe_every`-th one (index % moe_every ==
    moe_every - 1) has routed experts (`moe`) in place of fc1 / fc2."""

    def __init__(self, cfg, layer_idx, *, device=None, generator=None):
        super().__init__(cfg, device=device, generator=generator)
        if layer_idx % cfg.moe_every == cfg.moe_every - 1:
            del self.fc1
            del self.fc2
            self.moe = MoEMLP(cfg, device=device, generator=generator)
        else:
            self.moe = None

    def forward(self, x, cache=None, pos=None, dropout_seed=None):
        if cache is not None:
            raise _no_cache()
        if self.moe is None:
            return super().forward(x, dropout_seed=dropout_seed)
        x, _ = self._attention_half(x, dropout_seed=dropout_seed)
        return x + self.moe(self.ln2(x))


def _no_cache():
    return NotImplementedError("GPTMoE has no KV-cache decoding (neither "
                               "has the JAX package's)")


class GPTMoE(GPT):
    """GPT with routed-expert MLPs every `moe_every` blocks (reference
    GPT-MoE recipe: PaddleNLP MoE + fleet expert parallel), on one card.
    Parameters are drawn as `GPT`'s are (seed `seed`, construction
    order); the MoE layers' training keys come from one threefry stream
    seeded with `seed`."""

    def __init__(self, cfg, *, device=None, seed=0):
        if not cfg.tie_embeddings:
            raise NotImplementedError("GPTMoE has no untied lm_head "
                                      "(neither has the JAX package's)")
        super().__init__(cfg, device=device, seed=seed)
        keys = _KeyStream(seed, self.wte.weight.device)
        for m in self.moe_layers():
            m.keys = keys

    def _new_block(self, cfg, index, device, generator):
        return GPTMoEBlock(cfg, index, device=device, generator=generator)

    def moe_layers(self):
        """The MoEMLPs, in block order."""
        return [b.moe for b in self.blocks if b.moe is not None]

    def _run_block(self, block, x):
        # no per-block recompute: the aux losses are read back from the
        # blocks after the forward
        seed = (_next_seed(self._rng) if self.training and self.cfg.dropout
                else None)
        return block(x, dropout_seed=seed)

    def init_cache(self, batch_size, max_len):
        raise _no_cache()

    def forward(self, input_ids, cache=None, pos=0):
        if cache is not None:
            raise _no_cache()
        return super().forward(input_ids)

    def aux_loss(self):
        """The MoE blocks' latest aux losses summed, times
        aux_loss_weight; an f32 zero when there is none."""
        total = None
        for m in self.moe_layers():
            if m.last_aux_loss is not None:
                total = (m.last_aux_loss if total is None
                         else total + m.last_aux_loss)
        if total is None:
            return torch.zeros((), dtype=torch.float32,
                               device=self.wte.weight.device)
        return total * self.cfg.aux_loss_weight


def gpt_moe_tiny(**kw):
    base = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=64, dtype="float32", num_experts=4, top_k=2,
                remat=False)
    base.update(kw)
    return MoEConfig(**base)


def gpt_moe_small(**kw):
    """~350M-class dense backbone with 8 experts every 2nd block (the
    single-chip bench config)."""
    base = dict(hidden_size=1024, num_layers=12, num_heads=16,
                num_experts=8, top_k=2)
    base.update(kw)
    return MoEConfig(**base)
