"""Paged-KV GPT decode executor over page pools (counterpart of
`paddle_tpu/serving/decoder.py`): stacked weights, the per-tick decode,
the fused multi-tick decode, the packed ragged horizon and the packed
prefill.

JAX compiles each of these into one program and threads the KV pools
through them functionally (`donate_argnums` lets XLA reuse the
buffers). PyTorch runs eagerly and has no counterpart of donation, so
the port writes the pools IN PLACE (`_kv_set`): the pools never exist
twice. The multi-tick horizons are Python loops of device ops on
fixed-size tensors — no `.item()`, no boolean-mask indexing, no branch
on a device value — so a horizon enqueues without waiting for the card;
the engine fetches results at block boundaries only.

Every attention call goes through `ops.ragged_paged_attention`: the
hand-written CUDA kernel on the card, its plain version on the CPU.
Ported: a float32 or bfloat16 pool, no weight or KV quantization,
greedy decoding, the packed layout, one device.
"""
import collections

import numpy as np
import torch
import torch.nn.functional as F

from ..device import get_device
from ..ops import ragged_paged_attention as rpa

__all__ = ["PagedGPTDecoder", "MultiDecodeOut", "RaggedMultiOut",
           "pow2_at_least", "pool_token_bytes"]

# decode_multi's result bundle (device tensors): a caller feeds
# tokens/lens/done/remaining into the next horizon and fetches
# tokens_block/done_before only at sync points
MultiDecodeOut = collections.namedtuple(
    "MultiDecodeOut", ["tokens_block", "done_before", "tokens", "lens",
                       "done", "remaining"])

# ragged_multi's result bundle: like MultiDecodeOut plus the device-
# resident prompt-suffix carry (pend/pend_n), the per-tick `emitted`
# mask (False for filler ticks of frozen slots AND for mid-prefill
# ticks) and `real` [k], the real token positions each tick consumed
RaggedMultiOut = collections.namedtuple(
    "RaggedMultiOut", ["tokens_block", "emitted", "real", "tokens",
                       "lens", "done", "remaining", "pend", "pend_n"])

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# int32 sentinel budget: "unlimited" remaining tokens
_NO_LIMIT = np.iinfo(np.int32).max // 2


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (slice 1 serves a "
        "float32/bfloat16 pool, greedy, packed, on one device; later "
        "slices add it)")


def pow2_at_least(n):
    """Smallest power of two >= max(n, 1): the bucket-rounding rule shared
    by the packed dispatch (scheduler `t_tokens`, the packed prefill)."""
    p = 1
    while p < max(int(n), 1):
        p *= 2
    return p


def _ln(x, w, b):
    """LayerNorm as the JAX decoder computes it: f32 statistics with the
    population variance, eps 1e-5, affine in f32, then cast back."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-5) * w + b).to(x.dtype)


def _mm(x, w, b):
    """x [..., in] @ w [in, out] + b, in x's dtype."""
    return x @ w + b


def pool_token_bytes(cfg, itemsize=2):
    """KV bytes one context token costs PER LAYER in a plain pool of
    `itemsize`-byte elements (K and V together) — the byte model behind
    `kv_token_bytes` and `step_hbm_bytes`. The quantized layouts' pricing
    arrives with their pools."""
    return int(2 * cfg.num_heads * cfg.head_dim * itemsize)


def _kv_set(pool, pids, offs, val):
    """Write `val` [..., H, D] at (pids, offs) of ONE layer's page pool,
    in place — the single KV write primitive of every serving path
    (scratch routing is the caller's pids)."""
    pool[pids.long(), offs.long()] = val.to(pool.dtype)


class PagedGPTDecoder:
    """Stacked-weight GPT decode executor over paged KV pools.

    `state_dict` holds the JAX `GPT`'s keys in Paddle's [in, out] Linear
    layout (`models.init_state_dict`, or `models.state_dict_from_numpy`
    of a JAX model). The last page of the pool (`num_pages - 1`) is the
    reserved scratch page that absorbs every write of a padded, frozen
    or inactive position."""

    def __init__(self, cfg, state_dict, num_pages=128, page_size=16,
                 max_batch=8, max_pages_per_seq=None, quant=None,
                 kv_quant=None, dtype=None, temperature=0.0, mesh=None,
                 packed=True, device=None):
        if quant is not None:
            raise _not_ported(f"weight quantization quant={quant!r}")
        if kv_quant is not None:
            raise _not_ported(f"KV quantization kv_quant={kv_quant!r}")
        if temperature:
            raise _not_ported("sampled decoding (temperature > 0)")
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (mesh=)")
        if not packed:
            raise _not_ported("the dense window layout (packed=False)")
        self.device = get_device(device)
        self.cfg = cfg
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_batch = max_batch
        self.max_pages = max_pages_per_seq or \
            (cfg.max_seq_len + page_size - 1) // page_size
        dtype = dtype or cfg.dtype
        self.compute_dtype = _DTYPES[dtype] if isinstance(dtype, str) \
            else dtype
        dev, cd = self.device, self.compute_dtype
        L, H, D = cfg.num_layers, cfg.num_heads, cfg.head_dim
        sd = state_dict

        def stack(fmt, dtype):
            return torch.stack([sd[fmt.format(i)] for i in range(L)]).to(
                dev, dtype)

        # matmul weights and biases in the compute dtype (the JAX decoder
        # casts them at each use: `x @ w.astype(x.dtype)`); LayerNorm
        # affine in f32, as `_ln` promotes it. The qkv weight keeps the
        # JAX decoder's head-major column order: [L, h, 3*H*D] is the
        # same memory as its [L, h, 3, H, D].
        self.weights = {
            "ln1_w": stack("blocks.{}.ln1.weight", torch.float32),
            "ln1_b": stack("blocks.{}.ln1.bias", torch.float32),
            "qkv_w": stack("blocks.{}.qkv.weight", cd),
            "qkv_b": stack("blocks.{}.qkv.bias", cd),
            "proj_w": stack("blocks.{}.proj.weight", cd),
            "proj_b": stack("blocks.{}.proj.bias", cd),
            "ln2_w": stack("blocks.{}.ln2.weight", torch.float32),
            "ln2_b": stack("blocks.{}.ln2.bias", torch.float32),
            "fc1_w": stack("blocks.{}.fc1.weight", cd),
            "fc1_b": stack("blocks.{}.fc1.bias", cd),
            "fc2_w": stack("blocks.{}.fc2.weight", cd),
            "fc2_b": stack("blocks.{}.fc2.bias", cd),
        }
        # embeddings stay in their stored dtype: the JAX decoder adds
        # token and position rows there and casts the sum
        self.wte = sd["wte.weight"].to(dev)
        self.wpe = sd["wpe.weight"].to(dev)
        self.ln_f_w = sd["ln_f.weight"].to(dev, torch.float32)
        self.ln_f_b = sd["ln_f.bias"].to(dev, torch.float32)
        # logits are computed in f32: `x.float() @ lm_head.float()`
        head = sd["lm_head.weight"] if "lm_head.weight" in sd \
            else sd["wte.weight"].t()
        self.lm_head = head.to(dev, torch.float32)
        self.k_pages = torch.zeros((L, num_pages, page_size, H, D),
                                   dtype=cd, device=dev)
        self.v_pages = torch.zeros_like(self.k_pages)

    # -- forward bodies ----------------------------------------------------

    def _as_i32(self, x):
        return torch.as_tensor(x, dtype=torch.int32,
                               device=self.device).contiguous()

    def _embed(self, tokens, pos):
        pos = pos.long().clamp(0, self.cfg.max_seq_len - 1)
        return (self.wte[tokens.long()] + self.wpe[pos]).to(
            self.compute_dtype)

    def _layer(self, l, x, pids, offs, attend):
        """ONE transformer layer over flat new tokens x [T, h]: write each
        token's K/V at (pids, offs), attend through `attend(q, kp, vp)`
        (dense windows or the packed stream), then residual proj + FFN.
        Per-token math is row-local, so a token's bytes do not depend on
        what else is in the batch (up to the matmul library's choice of
        algorithm for the batch size)."""
        w = self.weights
        H, D = self.cfg.num_heads, self.cfg.head_dim
        T = x.shape[0]
        y = _ln(x, w["ln1_w"][l], w["ln1_b"][l])
        qkv = _mm(y, w["qkv_w"][l], w["qkv_b"][l]).view(T, 3, H, D)
        kp, vp = self.k_pages[l], self.v_pages[l]
        _kv_set(kp, pids, offs, qkv[:, 1])
        _kv_set(vp, pids, offs, qkv[:, 2])
        attn = attend(qkv[:, 0].contiguous(), kp, vp).to(x.dtype)
        x = x + _mm(attn.reshape(T, H * D), w["proj_w"][l], w["proj_b"][l])
        y = _ln(x, w["ln2_w"][l], w["ln2_b"][l])
        h = F.gelu(_mm(y, w["fc1_w"][l], w["fc1_b"][l]), approximate="tanh")
        return x + _mm(h, w["fc2_w"][l], w["fc2_b"][l])

    def _logits(self, x):
        x = _ln(x, self.ln_f_w, self.ln_f_b)
        return x.float() @ self.lm_head

    def _forward_tokens(self, tokens, lens, table, pids, offs):
        """Shared single-position forward over all slots: embed `tokens`
        at position `lens`, write K/V at (pids, offs) — callers route
        frozen slots' pids to scratch — and attend over each slot's pages
        (the dense kernel form, W=1). Returns logits [S, V]."""
        x = self._embed(tokens, lens)

        def attend(q, kp, vp):
            return rpa.ragged_paged_attention(q[:, None], kp, vp, table,
                                              lens)[:, 0]

        for l in range(self.cfg.num_layers):
            x = self._layer(l, x, pids, offs, attend)
        return self._logits(x)

    def _slot_pids(self, table, lens):
        # clamped: a frozen slot's lens may point past its table row; the
        # caller routes such writes to scratch
        col = (lens.long() // self.page_size).clamp(max=table.shape[1] - 1)
        return table.gather(1, col[:, None])[:, 0]

    def _decode_step(self, tokens, lens, table):
        """tokens [S], lens [S] (position of the incoming token), table
        [S, max_pages] -> (next [S] int32, logits [S, V])."""
        pids = self._slot_pids(table, lens)
        logits = self._forward_tokens(tokens, lens, table, pids,
                                      lens % self.page_size)
        return logits.argmax(-1).to(torch.int32), logits

    def _decode_multi_step(self, tokens, lens, table, done, remaining, eos,
                           k):
        """K fused decode ticks; each tick's token feeds the next on the
        device. `done` [S] freezes a slot from tick 0; a slot also freezes
        after emitting `eos` (-1: none) or after `remaining` tokens.
        Frozen slots' lens stop advancing and their K/V writes route to
        the scratch page. Returns (block [k, S], done_before [k, S],
        tokens, lens, done, remaining)."""
        scratch = self.num_pages - 1
        block, before = [], []
        for _ in range(k):
            pids = torch.where(done, scratch, self._slot_pids(table, lens))
            logits = self._forward_tokens(tokens, lens, table, pids,
                                          lens % self.page_size)
            nxt = logits.argmax(-1).to(torch.int32)
            nxt = torch.where(done, tokens, nxt)
            rem = torch.where(done, remaining, remaining - 1)
            new_done = done | (nxt == eos) | (rem <= 0)
            lens = torch.where(done, lens, lens + 1)
            block.append(nxt)
            before.append(done)
            tokens, done, remaining = nxt, new_done, rem
        return (torch.stack(block), torch.stack(before), tokens, lens, done,
                remaining)

    def _packed_forward(self, ptok, pos, rows, write_ok, table, last_idx,
                        live):
        """The shared PACKED forward: consume the flat token stream `ptok`
        [T] (token t = table row `rows[t]` at position `pos[t]`), write
        real tokens' K/V (`write_ok` False routes to scratch: padded tail,
        frozen rows, table overflow) and attend each token over its own
        row's pages. `last_idx` [S] indexes each row's last stream token,
        whose hidden state prices the row's logits (masked by `live`).
        Returns next [S] int32 (greedy)."""
        ps, MP = self.page_size, table.shape[1]
        x = self._embed(ptok, pos)
        col = (pos.long() // ps).clamp(max=MP - 1)
        pids = table[rows.long(), col]
        pids = torch.where(write_ok, pids, self.num_pages - 1)
        offs = pos % ps

        def attend(q, kp, vp):
            return rpa.ragged_paged_attention_packed(q, kp, vp, table, rows,
                                                     pos)

        for l in range(self.cfg.num_layers):
            x = self._layer(l, x, pids, offs, attend)
        last = x[last_idx.long().clamp(0, x.shape[0] - 1)]       # [S, h]
        last = torch.where(live[:, None], last, 0.0)
        return self._logits(last).argmax(-1).to(torch.int32)

    def _packed_multi_step(self, tokens, lens, table, done, remaining, eos,
                           pend, pend_n, w, k, t):
        """K MIXED ticks over the PACKED [t] token stream: a tick's stream
        concatenates every live row's new tokens (decode rows ONE token,
        prefilling rows their next min(pend_n, w) suffix tokens, frozen
        rows nothing). The layout (cumsum + searchsorted over per-row
        token counts) is built on the device each tick from the carry,
        with fixed-size tensors only, so the loop never waits for the
        card. A prefilling row emits nothing until the tick that consumes
        its last suffix token, which also yields its first generated
        token. Returns the RaggedMultiOut fields (tokens_block [k, S],
        emitted [k, S], real [k], finals...)."""
        S, P = pend.shape
        MP, ps = table.shape[1], self.page_size
        dev = self.device
        ti = torch.arange(t, device=dev)
        shift = torch.arange(P, device=dev) + w
        shift_ok = shift < P
        shift_idx = shift.clamp(max=P - 1).expand(S, P)
        block, emitted, real = [], [], []
        for _ in range(k):
            is_pf = pend_n > 0
            nl = torch.where(done, 0, torch.where(
                is_pf, pend_n.clamp(max=w), 1)).to(torch.int32)
            csum = torch.cumsum(nl, 0, dtype=torch.int32)
            total = csum[-1]
            starts = csum - nl
            rows = torch.searchsorted(csum, ti.to(torch.int32), right=True
                                      ).clamp(0, S - 1)
            within = ti - starts[rows]
            valid = ti < total
            pos = (lens[rows] + within).to(torch.int32)
            ptok = torch.where(
                is_pf[rows], pend[rows, within.clamp(0, P - 1)],
                tokens[rows])
            ptok = torch.where(valid, ptok, 0)
            write_ok = valid & ~done[rows] & (pos < MP * ps)
            last_idx = (csum - 1).clamp(0, t - 1)
            live = ~done & (nl > 0)
            nxt = self._packed_forward(ptok, pos, rows.to(torch.int32),
                                       write_ok, table, last_idx, live)
            emit = ~done & (pend_n <= w)
            nxt = torch.where(emit, nxt, tokens)
            rem = torch.where(emit, remaining - 1, remaining)
            new_done = done | (emit & ((nxt == eos) | (rem <= 0)))
            lens = torch.where(done, lens, lens + nl)
            # shift each row's suffix by w; over-shift past pend_n clears
            pend = torch.where(shift_ok, pend.gather(1, shift_idx), 0)
            pend_n = (pend_n - w).clamp(min=0)
            block.append(nxt)
            emitted.append(emit)
            real.append(total)
            tokens, done, remaining = nxt, new_done, rem
        return (torch.stack(block), torch.stack(emitted), torch.stack(real),
                tokens, lens, done, remaining, pend, pend_n)

    # -- host-side API -----------------------------------------------------

    def prefill(self, ids, page_ids):
        """Run one prompt through the model, writing KV into `page_ids`;
        returns the next token (greedy)."""
        return self.prefill_batch([(ids, page_ids)])[0]

    def prefill_batch(self, requests):
        """Prefill several prompts in full. requests: [(ids, page_ids),
        ...]; returns the first generated token per request (in order).
        A thin wrapper over the packed chunked prefill at start=0."""
        return self.prefill_suffix_batch(
            [(ids, 0, pages) for ids, pages in requests])

    def prefill_suffix_batch(self, requests, packed=None):
        """Chunked prefill over page-table rows. requests: [(suffix_ids,
        start, pages), ...] — `pages` is the sequence's page list in
        block order, `start` the already-cached prefix length (0: the
        suffix IS the prompt). Each group of up to max_batch requests
        runs as ONE flat [total_tokens] stream, bucketed to a power of
        two. Returns the first generated token per request (in
        order)."""
        if packed is False:
            raise _not_ported("the dense window prefill (packed=False)")
        return self._prefill_packed_batch(requests)

    def _prefill_packed_batch(self, requests):
        """PACKED prefill dispatch: the layout (flat tokens, per-token row
        ids and positions) is built on the host, where all lengths are
        known, and sent to the device in one go per group."""
        results = [None] * len(requests)
        S, MP, ps = self.max_batch, self.max_pages, self.page_size
        todo = list(enumerate(requests))
        while todo:
            chunk, todo = todo[:S], todo[S:]
            t = pow2_at_least(sum(len(np.asarray(ids).reshape(-1))
                                  for _, (ids, _, _) in chunk))
            ptok = np.zeros(t, np.int32)
            pos = np.zeros(t, np.int32)
            rows = np.zeros(t, np.int32)
            ok = np.zeros(t, bool)
            last_idx = np.zeros(S, np.int32)
            live = np.zeros(S, bool)
            tbl = np.full((S, MP), self.num_pages - 1, np.int32)
            cur = 0
            for r, (_, (ids, start, pages)) in enumerate(chunk):
                ids = np.asarray(ids, np.int32).reshape(-1)
                n = len(ids)
                ptok[cur:cur + n] = ids
                pos[cur:cur + n] = int(start) + np.arange(n)
                rows[cur:cur + n] = r
                ok[cur:cur + n] = pos[cur:cur + n] < MP * ps
                last_idx[r] = max(cur + n - 1, 0)
                live[r] = n > 0
                m = min(len(pages), MP)
                tbl[r, :m] = pages[:m]       # rest stays on scratch
                cur += n
            nxt = self._packed_forward(
                self._as_i32(ptok), self._as_i32(pos), self._as_i32(rows),
                torch.as_tensor(ok, device=self.device), self._as_i32(tbl),
                self._as_i32(last_idx),
                torch.as_tensor(live, device=self.device)).tolist()
            for r, (i, _) in enumerate(chunk):
                results[i] = nxt[r]
        return results

    def decode(self, tokens, lens, table):
        """One decode step for all slots (greedy). Returns next [S] int32
        on the device."""
        nxt, _ = self._decode_step(self._as_i32(tokens), self._as_i32(lens),
                                   self._as_i32(table))
        return nxt

    def decode_multi(self, tokens, lens, table, k, done=None,
                     remaining=None, eos=None):
        """Run `k` decode ticks device-resident: the tokens each tick
        emits feed the next without a host sync (see
        `_decode_multi_step`). Inputs and outputs may stay on the device.
        Returns a MultiDecodeOut."""
        k, S = int(k), self.max_batch
        if done is None:
            done = np.zeros(S, bool)
        if remaining is None:
            remaining = np.full(S, _NO_LIMIT, np.int32)
        out = self._decode_multi_step(
            self._as_i32(tokens), self._as_i32(lens), self._as_i32(table),
            torch.as_tensor(done, dtype=torch.bool, device=self.device),
            self._as_i32(remaining), -1 if eos is None else int(eos), k)
        return MultiDecodeOut(*out)

    @property
    def pend_capacity(self):
        """Static width of the ragged horizon's device-resident prompt
        suffix buffer: the pool's per-sequence token capacity."""
        return self.max_pages * self.page_size

    def ragged_multi(self, tokens, lens, table, k, w, pend, pend_n,
                     done=None, remaining=None, eos=None, packed=None,
                     t_tokens=None):
        """Run `k` MIXED ragged ticks device-resident: decode rows and
        prefill-chunk rows serve together, up to w suffix tokens per
        prefilling slot per tick, as the flat [t_tokens] packed stream.
        `t_tokens` must cover the largest per-tick total (default: the
        dense-equivalent S*w bound). `pend` [S, P] / `pend_n` [S] are the
        carried prompt suffixes (P = `pend_capacity`). Returns a
        RaggedMultiOut."""
        if packed is False:
            raise _not_ported("the dense ragged window twin (packed=False)")
        k, w, S = int(k), int(w), self.max_batch
        if done is None:
            done = np.zeros(S, bool)
        if remaining is None:
            remaining = np.full(S, _NO_LIMIT, np.int32)
        if t_tokens is None:
            t_tokens = pow2_at_least(S * max(w, 1))
        t = max(int(t_tokens), 1)
        if t < S:
            # every live slot owns at least one stream share; a bucket
            # below S could silently drop rows' tokens
            raise ValueError(
                f"t_tokens {t} < max_batch {S}: the packed bucket must "
                "cover at least one token per slot")
        out = self._packed_multi_step(
            self._as_i32(tokens), self._as_i32(lens), self._as_i32(table),
            torch.as_tensor(done, dtype=torch.bool, device=self.device),
            self._as_i32(remaining), -1 if eos is None else int(eos),
            self._as_i32(pend), self._as_i32(pend_n), w, k, t)
        return RaggedMultiOut(*out)

    # -- byte model --------------------------------------------------------

    @property
    def kv_token_bytes(self):
        """KV bytes ONE token costs per layer (K and V together)."""
        return pool_token_bytes(self.cfg,
                                itemsize=self.k_pages.element_size())

    def kv_token_bytes_by_layer(self):
        """Per-LAYER KV bytes one token costs (every layer stores the same
        width today)."""
        return [self.kv_token_bytes] * self.cfg.num_layers

    @property
    def kv_page_bytes(self):
        """KV bytes one page holds across all layers (K and V)."""
        return int(self.cfg.num_layers * self.page_size *
                   self.kv_token_bytes)

    def step_hbm_bytes(self, avg_ctx=None, batch=None):
        """HBM bytes ONE decode tick moves: every weight byte (priced at 2
        bytes per parameter) plus each slot's KV prefix at `avg_ctx`
        (default: half the model's max sequence) — the numerator of the
        decode tick roofline the scheduler prices K and w from."""
        cfg = self.cfg
        if avg_ctx is None:
            avg_ctx = max(cfg.max_seq_len // 2, 1)
        if batch is None:
            batch = self.max_batch
        return int(cfg.num_params() * 2 +
                   batch * avg_ctx * sum(self.kv_token_bytes_by_layer()))
