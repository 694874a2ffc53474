"""Autoregressive generation from the KV cache (counterpart of
`paddle_tpu/models/generation.py`): greedy, temperature / top-k / top-p
sampling and beam search.

The JAX package compiles the prefill and the decode loop (one
`lax.scan`); here the prefill is one cached forward and the decode loop
a Python loop of device ops over fixed-size tensors at host-known
positions, so it enqueues without waiting for the card: nothing is
fetched before the loop ends. Sampling draws through `random` — the
port's threefry, bit-equal to `jax.random` — with the same key walk as
the JAX `generate`, so a seeded run samples the tokens the JAX package
samples from the same logits. `mask_logits` is the one sampling mask,
shared with the serving decoder.
"""
import math

import numpy as np
import torch

from .. import random as prng

__all__ = ["generate", "beam_search", "mask_logits"]


def mask_logits(logits, temperature, top_k, top_p):
    """Temperature / top-k / nucleus filtering in f32 (the JAX
    `mask_logits`): logits / temperature; entries below the k-th largest
    set to -1e30; then, over the logits sorted high to low, the entries
    below the first one whose cumulative softmax reaches `top_p` set to
    -1e30. The division is by an f32 0-d tensor (PyTorch's CUDA `x /
    scalar` multiplies by a reciprocal). The nucleus's softmax and
    cumulative sum run in float64 and are compared with f32(top_p): the
    same on the CPU and the card up to float64 rounding, where f32 sums
    in the devices' different orders would disagree at the boundary. JAX
    sums in f32 in XLA's order, so a row whose cumulative sum lands
    within f32 rounding of `top_p` can keep an entry more or less than
    the JAX mask (a boundary entry of near-zero probability)."""
    x = logits.float()
    x = x / torch.full((), float(temperature), dtype=torch.float32,
                       device=x.device)
    if top_k and top_k > 0:
        kth = torch.topk(x, int(top_k), dim=-1).values[..., -1:]
        x = torch.where(x < kth, -1e30, x)
    if top_p and top_p < 1.0:
        srt = torch.sort(x, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(srt.double(), dim=-1), dim=-1)
        idx = (cum < float(np.float32(top_p))).sum(-1, keepdim=True)
        V = x.shape[-1]
        # past the last entry: JAX's gather fills NaN, which masks nothing
        cutoff = torch.where(idx < V, srt.gather(-1, idx.clamp(max=V - 1)),
                             float("nan"))
        x = torch.where(x < cutoff, -1e30, x)
    return x


def _sample(logits, key, temperature, top_k, top_p):
    if temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1)
    return prng.categorical(key, mask_logits(logits, temperature, top_k,
                                             top_p))


def _top_k(x, k):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (`jax.lax.top_k`'s order, which
    `torch.topk` does not promise): a stable descending sort."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _prefill(model, ids, max_len):
    cache = model.init_cache(ids.shape[0], max_len)
    logits, cache = model(ids, cache=cache, pos=0)
    return logits[:, -1], cache


def _ids(model, input_ids):
    dev = model.wte.weight.device
    if isinstance(input_ids, torch.Tensor):
        return input_ids.to(dev, torch.int64)
    return torch.as_tensor(input_ids, dtype=torch.int64, device=dev)


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, temperature=1.0, top_k=0,
             top_p=1.0, eos_token_id=None, seed=0, num_beams=1,
             length_penalty=0.0):
    """[B, L_in + max_new_tokens] int64 token ids on the model's device
    (greedy when temperature == 0). Sampling splits `PRNGKey(seed)` once
    for the first token and once more before the loop, then once a step,
    as the JAX `generate` does. With `eos_token_id`, every token after a
    row's first EOS becomes EOS. `num_beams > 1` runs beam search and
    refuses the sampling options."""
    if num_beams > 1:
        if not (temperature in (0.0, 1.0) and not top_k
                and top_p in (0, 1.0)):
            raise ValueError(
                "beam search explores by score, not sampling: leave "
                "temperature/top_k/top_p at defaults")
        out, _ = beam_search(model, input_ids, max_new_tokens, num_beams,
                             eos_token_id, length_penalty)
        return out
    ids = _ids(model, input_ids)
    B, L_in = ids.shape
    max_len = L_in + max_new_tokens
    if max_len > model.cfg.max_seq_len:
        raise ValueError(f"{max_len} tokens exceed the model's max_seq_len "
                         f"{model.cfg.max_seq_len}")
    model.eval()
    last, cache = _prefill(model, ids, max_len)
    sampled = temperature != 0.0
    key = prng.PRNGKey(seed, device=ids.device) if sampled else None
    sub = None
    if sampled:
        key, sub = prng.split(key)
    tok = _sample(last, sub, temperature, top_k, top_p)
    toks = [tok]
    if sampled and max_new_tokens > 1:
        key = prng.split(key)[0]
    for t in range(max_new_tokens - 1):
        if sampled:
            key, sub = prng.split(key)
        logits, cache = model(tok[:, None], cache=cache, pos=L_in + t)
        tok = _sample(logits[:, -1], sub, temperature, top_k, top_p)
        toks.append(tok)
    gen = torch.stack(toks, dim=1)
    if eos_token_id is not None and max_new_tokens > 1:
        hit = torch.cumsum((gen == eos_token_id).int(), dim=1) > 0
        prev = torch.nn.functional.pad(hit[:, :-1], (1, 0))
        gen = torch.where(prev, eos_token_id, gen)
    return torch.cat([ids, gen], dim=1)


@torch.no_grad()
def beam_search(model, input_ids, max_new_tokens=32, num_beams=4,
                eos_token_id=None, length_penalty=0.0):
    """Beam search (the JAX `beam_search`): returns (ids [B, L_in + T],
    scores [B]). Each step expands the K live beams over the vocabulary,
    keeps the top K (the lower index first on ties), and reorders the KV
    cache to follow the surviving beams; a beam that emitted EOS is
    frozen with one candidate, its pad continuation at its unchanged
    score. The best beam is picked by score / length**length_penalty;
    everything after its first EOS is padding (EOS)."""
    ids = _ids(model, input_ids)
    B, L_in = ids.shape
    K, T = int(num_beams), int(max_new_tokens)
    max_len = L_in + T
    if max_len > model.cfg.max_seq_len:
        raise ValueError(f"{max_len} tokens exceed the model's max_seq_len "
                         f"{model.cfg.max_seq_len}")
    eos = -1 if eos_token_id is None else int(eos_token_id)
    pad = eos if eos_token_id is not None else 0
    dev = ids.device
    model.eval()
    last, cache = _prefill(model, ids, max_len)
    logp0 = torch.log_softmax(last.float(), dim=-1)
    scores, first = _top_k(logp0, K)                     # [B, K]
    cache = [tuple(x.repeat_interleave(K, dim=0) for x in c) for c in cache]
    toks = torch.full((B, K, T), pad, dtype=torch.int64, device=dev)
    toks[:, :, 0] = first
    finished = first == eos
    V = logp0.shape[-1]
    b_idx = torch.arange(B, device=dev)[:, None]
    cur = first
    neg_inf = torch.full((), -math.inf, device=dev)
    for t in range(T - 1):
        logits, cache = model(cur.reshape(B * K, 1), cache=cache,
                              pos=L_in + t)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        logp = logp.reshape(B, K, V)
        cand = torch.where(finished[:, :, None], neg_inf,
                           scores[:, :, None] + logp)
        frozen = torch.full((B, K, V), -math.inf, device=dev)
        frozen[:, :, pad] = torch.where(finished, scores, neg_inf)
        cand = torch.maximum(cand, frozen).reshape(B, K * V)
        scores, flat = _top_k(cand, K)
        beam = flat // V
        tok = flat % V
        sel = (b_idx * K + beam).reshape(-1)
        cache = [tuple(x.index_select(0, sel) for x in c) for c in cache]
        toks = toks[b_idx, beam]
        finished = finished[b_idx, beam] | (tok == eos)
        toks[:, :, t + 1] = tok
        cur = tok
    if eos >= 0:
        hit = torch.cumsum((toks == eos).int(), dim=-1) > 0
        lengths = T - hit.sum(-1) + hit.any(-1).int()
        prev = torch.nn.functional.pad(hit[:, :, :-1], (1, 0))
        toks = torch.where(prev, pad, toks)
    else:
        lengths = torch.full((B, K), T, device=dev)
    norm = scores / lengths.clamp_min(1).float() ** length_penalty
    best = torch.argmax(norm, dim=1)
    rows = torch.arange(B, device=dev)
    return torch.cat([ids, toks[rows, best]], dim=1), norm[rows, best]
