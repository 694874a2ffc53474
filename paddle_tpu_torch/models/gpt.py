"""GPT: configuration, presets, a seeded random state dict, and the
training model (counterpart of `paddle_tpu/models/gpt.py`).

`GPT` is the pre-LN decoder the JAX package trains: learned positions,
flash attention on the causal path, per-block activation recompute
(`remat_policy="full"`, `torch.utils.checkpoint`), and the tied head
accumulated in f32 with f32 logits (an untied head returns its Linear's
dtype). Its parameter names and shapes are
the JAX `GPT`'s state dict, so `init_state_dict` and
`convert.state_dict_from_numpy` feed both `GPT` and the serving path's
`PagedGPTDecoder`. `GPTPretrainingCriterion` is the causal-LM loss with
pad label -100, through the streaming cross-entropy kernel where
`can_fuse_xent` holds.
"""
import dataclasses
import math

import torch
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint

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
    remat_policy: str = "full"       # 'full' | 'none'; 'dots' not ported
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

    def forward(self, x, dropout_seed=None):
        """`dropout_seed`: the attention dropout's seed, drawn by the
        caller outside any recompute so the backward's rerun drops the
        same probabilities."""
        cfg = self.cfg
        B, L = x.shape[0], x.shape[1]
        qkv = self.qkv(self.ln1(x)).reshape(B, L, 3, cfg.num_heads,
                                             cfg.head_dim)
        attn = F.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], is_causal=True,
            dropout_p=cfg.dropout, training=self.training,
            dropout_seed=dropout_seed)
        x = x + self.proj(attn.reshape(B, L, cfg.hidden_size))
        y = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate=True))
        return x + y


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
        if cfg.remat and cfg.remat_policy == "dots":
            raise NotImplementedError(
                "remat_policy='dots' is not ported (ROADMAP queue 1); use "
                "'full' or 'none'")
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
            [GPTBlock(cfg, device=dev, generator=g)
             for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, device=dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     weight_init=init, bias=False,
                                     device=dev, generator=g)

    def _run_block(self, block, x):
        """One block; under remat 'full' its activations are recomputed
        in the backward instead of stored."""
        cfg = self.cfg
        seed = (_next_seed(self._rng) if self.training and cfg.dropout
                else None)
        if cfg.remat and cfg.remat_policy == "full" and \
                torch.is_grad_enabled():
            return checkpoint(block, x, seed, use_reentrant=False)
        return block(x, seed)

    def forward(self, input_ids):
        """input_ids [B, L] -> logits [B, L, V]: f32 from the tied head,
        the Linear's dtype from an untied one (as in JAX)."""
        cfg = self.cfg
        B, L = input_ids.shape
        positions = torch.arange(L, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(positions)
        x = self.drop(x.to(getattr(torch, cfg.dtype)))
        for block in self.blocks:
            x = self._run_block(block, x)
        x = self.ln_f(x).reshape(B * L, cfg.hidden_size)
        if cfg.tie_embeddings:
            logits = _TiedHead.apply(x, self.wte.weight)
        else:
            logits = self.lm_head(x)
        return logits.reshape(B, L, -1)


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
