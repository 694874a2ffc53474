"""GPT: configuration, presets, a seeded random state dict, and the
training model (counterpart of `paddle_tpu/models/gpt.py`).

`GPT` is the pre-LN decoder the JAX package trains: learned positions,
flash attention on the causal path, per-block activation recompute
(`torch.utils.checkpoint`: `remat_policy="full"` saves nothing of the
block, "dots" saves the outputs of its four Linear products, as JAX's
`dots_with_no_batch_dims_saveable` does), and the tied head accumulated
in f32 with f32 logits (an untied head returns its Linear's dtype). With
a KV cache (`init_cache`, `forward(ids, cache=..., pos=...)`) it decodes
as the JAX `GPT` does: each block writes k and v at `pos` into static
[B, max_len, H, D] buffers and attends over the whole buffer in f32 with
a `q_pos >= k_pos` mask (plain torch ops, as the JAX path is plain jnp).
Its parameter names and shapes are
the JAX `GPT`'s state dict, so `init_state_dict` and
`convert.state_dict_from_numpy` feed both `GPT` and the serving path's
`PagedGPTDecoder`. `GPTPretrainingCriterion` is the causal-LM loss with
pad label -100, through the streaming cross-entropy kernel where
`can_fuse_xent` holds.
"""
import dataclasses
import functools
import math

import torch
from torch import nn as tnn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import nn
from ..device import get_device
from ..nn import functional as F
from ..nn.initializer import Normal
from ..ops.attention import _next_seed
from ..ops.fused_ops import can_fuse_xent, fused_softmax_cross_entropy

__all__ = ["GPTConfig", "GPT", "GPTBlock", "GPTPretrainingCriterion",
           "init_state_dict", "gpt_tiny", "gpt_125m", "gpt_350m",
           "gpt_760m", "gpt_1p3b"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: int = 0              # 0 -> 4*hidden
    max_seq_len: int = 1024
    dropout: float = 0.0
    sp_mode: str = "ring"            # 'ring' | 'zigzag' | 'ulysses'
    dtype: str = "bfloat16"          # compute dtype
    remat: bool = True               # recompute each block in the backward
    remat_policy: str = "full"       # 'full' | 'dots' | 'none'
    tie_embeddings: bool = True
    init_std: float = 0.02
    tp_overlap: str = "off"          # 'off' | 'bulk' | 'ring'
    tp_overlap_chunks: int = 4       # free-dim tiles per overlapped site

    def __post_init__(self):
        """`sp_mode` and `tp_overlap` pick the sequence- and tensor-
        parallel branches, which the JAX model takes only under a mesh
        with sp > 1 or tp > 1. The port has no mesh (a decoder asked for
        one raises), so on its one card every value runs the plain
        attention and Linear, as the JAX model does on one device."""
        if self.ffn_hidden == 0:
            self.ffn_hidden = 4 * self.hidden_size
        if self.sp_mode not in ("ring", "zigzag", "ulysses"):
            raise ValueError(f"sp_mode must be 'ring', 'zigzag' or "
                             f"'ulysses', got {self.sp_mode!r}")
        if self.tp_overlap not in ("off", "bulk", "ring"):
            raise ValueError(f"tp_overlap must be 'off', 'bulk' or "
                             f"'ring', got {self.tp_overlap!r}")
        if self.remat_policy not in ("full", "dots", "none"):
            raise ValueError(f"remat_policy must be 'full', 'dots' or "
                             f"'none', got {self.remat_policy!r}")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    def num_params(self):
        h, L, v = self.hidden_size, self.num_layers, self.vocab_size
        per_block = (4 * h * h + 2 * h * self.ffn_hidden + 9 * h
                     + 2 * self.ffn_hidden)
        return v * h + self.max_seq_len * h + L * per_block + 2 * h


def init_state_dict(cfg, seed=0, device=None):
    """Random float32 weights with the JAX `GPT`'s keys and shapes: the
    state of `GPT(cfg, device, seed)`, whose layers draw them from one
    `torch.Generator` seeded with `seed` on `device` — N(0, init_std)
    for embeddings, qkv and fc1; N(0, init_std/sqrt(2L)) for the
    residual-out projections (proj, fc2); LayerNorm weights 1 and every
    bias 0, the JAX model's initializers. The numbers differ from JAX's
    for the same seed (another generator); parity tests carry the JAX
    weights across with `models.convert.state_dict_from_numpy`."""
    model = GPT(cfg, device=device, seed=seed)
    return {k: v.detach() for k, v in model.state_dict().items()}


class GPTBlock(tnn.Module):
    """Pre-LN decoder block: x + proj(attn(ln1(x))), then
    x + fc2(gelu(fc1(ln2(x))))."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        init = Normal(0.0, cfg.init_std)
        # scaled init on the residual-out projections (GPT-2/3 recipe)
        out_init = Normal(0.0, cfg.init_std / math.sqrt(2.0 * cfg.num_layers))
        kw = {"device": device, "generator": generator}
        self.ln1 = nn.LayerNorm(h, device=device)
        self.qkv = nn.Linear(h, 3 * h, weight_init=init, **kw)
        self.proj = nn.Linear(h, h, weight_init=out_init, **kw)
        self.ln2 = nn.LayerNorm(h, device=device)
        self.fc1 = nn.Linear(h, cfg.ffn_hidden, weight_init=init, **kw)
        self.fc2 = nn.Linear(cfg.ffn_hidden, h, weight_init=out_init, **kw)

    def forward(self, x, cache=None, pos=None, dropout_seed=None):
        """x [B, L, h] -> [B, L, h]; with a `cache` (k, v) and `pos`,
        (out, cache) after writing this call's k and v at `pos`.
        `dropout_seed`: the attention dropout's seed, drawn by the caller
        outside any recompute so the backward's rerun drops the same
        probabilities."""
        x, cache = self._attention_half(x, cache, pos, dropout_seed)
        y = F.gelu(self.fc1(self.ln2(x)), approximate=True)
        with _Unread():
            y = self.fc2(y)
        return x + y if cache is None else (x + y, cache)

    def _attention_half(self, x, cache=None, pos=None, dropout_seed=None):
        """x + proj(attn(ln1(x))), and the cache after this call's
        writes."""
        cfg = self.cfg
        B, L = x.shape[0], x.shape[1]
        qkv = self.qkv(self.ln1(x)).reshape(B, L, 3, cfg.num_heads,
                                             cfg.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is not None:
            attn, cache = _attend_cached(q, k, v, cache, pos)
        else:
            attn = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=cfg.dropout,
                training=self.training, dropout_seed=dropout_seed)
        return x + self.proj(attn.reshape(B, L, cfg.hidden_size)), cache


def _attend_cached(q, k, v, cache, pos):
    """Decode-time attention against a static KV buffer (the JAX
    `GPTBlock._attend_cached`): k and v [B, L, H, D] are written at
    positions pos..pos+L-1 of the buffers (start clamped so the rows fit,
    as `dynamic_update_slice` clamps), IN PLACE — the port has no buffer
    donation — then q attends over the whole buffer in f32 with the
    `q_pos >= k_pos` mask and -1e30 for masked scores. `pos` is an
    int."""
    k_buf, v_buf = cache
    B, Lq, H, D = q.shape
    Lmax = k_buf.shape[1]
    dev = q.device
    q_pos, rows = _positions(pos, Lq, dev, Lmax)
    k_buf.index_copy_(1, rows, k.to(k_buf.dtype))
    v_buf.index_copy_(1, rows, v.to(v_buf.dtype))
    scale = 1.0 / math.sqrt(D)
    qh = q.transpose(1, 2).float() * scale
    kh = k_buf.transpose(1, 2).float()
    vh = v_buf.transpose(1, 2).float()
    s = qh @ kh.transpose(-1, -2)                       # [B, H, Lq, Lmax]
    k_pos = torch.arange(Lmax, device=dev)[None, :]
    s = torch.where(q_pos[:, None] >= k_pos, s, -1e30)
    probs = torch.softmax(s, dim=-1)
    out = (probs @ vh).transpose(1, 2).to(q.dtype)
    return out, (k_buf, v_buf)


def _positions(pos, L, device, max_len=None):
    """Positions pos..pos+L-1 on `device` and, given the buffer length,
    the rows they are written to (the start clamped so all L fit). The
    int `pos` builds them with `arange` alone (no host-to-device copy,
    which would wait for the card)."""
    p = int(pos)
    start = p if max_len is None else min(max(p, 0), max_len - L)
    return (torch.arange(p, p + L, device=device),
            torch.arange(start, start + L, device=device))


class _Unread:
    """While `active`, the block runs a product whose output no backward
    reads: fc2's, which feeds only the residual add. 'dots' does not keep
    it (JAX's partial evaluation drops that residual too), and the
    recompute stops before it reruns it: the backward needs only fc2's
    inputs, which the recompute has by then."""
    active = False

    def __enter__(self):
        _Unread.active = True

    def __exit__(self, *exc):
        _Unread.active = False


def _save_dots(ctx, op, *args, **kwargs):
    """remat 'dots': keep the products that have no batch dimensions —
    F.linear's `addmm` (or `mm` on a non-contiguous input) — whose
    outputs a backward reads (qkv, proj, fc1), and recompute everything
    else, the attention kernel included (JAX's
    `dots_with_no_batch_dims_saveable`: a `pallas_call` is no dot)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) \
            and not _Unread.active:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_dots_context = functools.partial(create_selective_checkpoint_contexts,
                                  _save_dots)


class _TiedHead(torch.autograd.Function):
    """logits = x @ wte^T with f32 accumulation and f32 logits (the JAX
    `dot_general(..., preferred_element_type=f32)`). In bf16 the backward
    rounds the f32 logits' gradient to bf16 and runs bf16 products with
    f32 accumulation — what the TPU's default matmul precision does with
    an f32 operand — so dx and dwte come out in bf16."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.dtype == torch.float32:
            return x @ w.t()
        if x.is_cuda:
            return torch.ops.aten.mm.dtype(x, w.t(), torch.float32)
        return x.float() @ w.float().t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w, g.t() @ x


class GPT(tnn.Module):
    """GPT decoder for training. Parameters are drawn in f32 at
    construction, in construction order, from one `torch.Generator`
    seeded with `seed` on `device` (None: the card). Call `.bfloat16()`
    for the bf16 training path, as the JAX model's users do."""

    def __init__(self, cfg, device=None, seed=0):
        super().__init__()
        self.cfg = cfg
        dev = get_device(device)
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        # dropout salts and seeds: a CPU generator, so a draw costs no
        # host sync
        self._rng = torch.Generator()
        self._rng.manual_seed(int(seed))
        init = Normal(0.0, cfg.init_std)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                weight_init=init, device=dev, generator=g)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size,
                                weight_init=init, device=dev, generator=g)
        self.drop = nn.Dropout(cfg.dropout, generator=self._rng)
        self.blocks = nn.LayerList(
            [self._new_block(cfg, i, dev, g) for i in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, device=dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     weight_init=init, bias=False,
                                     device=dev, generator=g)

    def _new_block(self, cfg, index, device, generator):
        return GPTBlock(cfg, device=device, generator=generator)

    def _run_block(self, block, x):
        """One block; under remat its activations are recomputed in the
        backward instead of stored: all of them ('full'), or all but the
        Linear products that a backward reads ('dots')."""
        cfg = self.cfg
        seed = (_next_seed(self._rng) if self.training and cfg.dropout
                else None)
        if cfg.remat and cfg.remat_policy != "none" and \
                torch.is_grad_enabled():
            kw = ({"context_fn": _dots_context}
                  if cfg.remat_policy == "dots" else {})
            return checkpoint(block, x, None, None, seed,
                              use_reentrant=False, **kw)
        return block(x, dropout_seed=seed)

    def init_cache(self, batch_size, max_len):
        """Decode KV cache: per block a zeroed (k, v) pair [batch_size,
        max_len, H, D] in the config's dtype on the model's device."""
        cfg = self.cfg
        shape = (batch_size, max_len, cfg.num_heads, cfg.head_dim)
        kw = {"dtype": getattr(torch, cfg.dtype),
              "device": self.wte.weight.device}
        return [(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
                for _ in self.blocks]

    def forward(self, input_ids, cache=None, pos=0):
        """input_ids [B, L] -> logits [B, L, V]: f32 from the tied head,
        the Linear's dtype from an untied one (as in JAX). With a `cache`
        (`init_cache`) the tokens sit at positions pos..pos+L-1 and the
        call returns (logits, cache)."""
        cfg = self.cfg
        B, L = input_ids.shape
        positions = _positions(pos if cache is not None else 0, L,
                               input_ids.device)[0]
        x = self.wte(input_ids) + self.wpe(positions)
        x = self.drop(x.to(getattr(torch, cfg.dtype)))
        if cache is not None:
            new_cache = []
            for block, c in zip(self.blocks, cache):
                x, c = block(x, cache=c, pos=pos)
                new_cache.append(c)
        else:
            for block in self.blocks:
                x = self._run_block(block, x)
        x = self.ln_f(x).reshape(B * L, cfg.hidden_size)
        if cfg.tie_embeddings:
            logits = _TiedHead.apply(x, self.wte.weight)
        else:
            logits = self.lm_head(x)
        logits = logits.reshape(B, L, -1)
        return logits if cache is None else (logits, new_cache)


class GPTPretrainingCriterion(tnn.Module):
    """Causal-LM loss (f32), ignoring pad label -100. Where
    `can_fuse_xent(N, V)` holds, the rows go through the streaming
    cross-entropy kernel with labels clamped to >= 0, invalid rows
    zeroed and the sum divided by max(#valid, 1); otherwise
    `F.cross_entropy`."""

    def forward(self, logits, labels):
        V = logits.shape[-1]
        flat = logits.reshape(-1, V)
        lab = labels.reshape(-1)
        if can_fuse_xent(flat.shape[0], V):
            valid = lab >= 0
            rows, _ = fused_softmax_cross_entropy(flat, lab.clamp_min(0))
            rows = torch.where(valid, rows, 0.0)
            return rows.sum() / valid.sum().clamp_min(1).float()
        return F.cross_entropy(flat, lab, ignore_index=-100)


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
