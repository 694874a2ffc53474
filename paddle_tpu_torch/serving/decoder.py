"""Paged-KV GPT decode executor over page pools (counterpart of
`paddle_tpu/serving/decoder.py`): stacked weights, the per-tick decode,
the fused multi-tick decode, the ragged horizon and the chunked prefill
in both layouts (the packed token stream, the default, and the dense
window twin, `packed=False`), and the speculative verify window.

JAX compiles each of these into one program and threads the KV pools
through them functionally (`donate_argnums` lets XLA reuse the
buffers). PyTorch runs eagerly and has no counterpart of donation, so
the port writes the pools IN PLACE (`_kv_set`): the pools never exist
twice. The multi-tick horizons are Python loops of device ops on
fixed-size tensors — no `.item()`, no boolean-mask indexing, no branch
on a device value — so a horizon enqueues without waiting for the card;
the engine fetches results at block boundaries only.

Every attention call goes through `ops.ragged_paged_attention`; with
`quant="w4a16"` every qkv/proj/fc1/fc2 product through `ops.w4_matmul`,
with `quant="a8w8"` through `ops.a8w8_matmul` (the row quantize and the
int8 GEMM): the hand-written CUDA kernels on the card, their plain
versions on the CPU. Ported: float32/bfloat16, int8 (`kv_quant="int8"`,
per-token scales) and int4 (`kv_quant="int4"`, nibbles with per-group
scales) pools, int4 weights (`quant="w4a16"`), int8 weights with dynamic
int8 activations (`quant="a8w8"`), greedy and sampled decoding
(`temperature`, `top_k`, `top_p`, `seed`: the JAX `mask_logits` and a
threefry draw bit-equal to `jax.random`, keyed by (seed, request id,
position) on every path, so a request's tokens do not depend on the
schedule), the packed layout and the dense window layout (one layer body,
`_layer`, under both: the dense windows run it on their flattened
[n * W] tokens and attend through the kernel's dense form), the verify
window with the acceptance rule of speculative decoding (`verify`,
`_spec_accept`), multi-LoRA (`attach_adapters`: per-token adapter ids on
every path, the delta added right after the qkv product by
`ops.lora_delta`, the hand-written CUDA kernel on the card), one device. A
quantized pool is a (pages,
scales) tuple per K and V; `_kv_set` quantizes each token from its own
values as it writes it (plain PyTorch, as the JAX decoder's jnp), so
stored bytes depend only on (request, position).

The page primitives the prefix cache and the host KV tier run on are
ported too: `copy_page` (copy-on-write, scale planes included),
`fetch_page_payloads` / `mount_page_payloads` (one gather + D2H, and
one H2D + `index_copy_`, per pool leaf per wave or span), `pool_state` /
`load_pool_state` and `cache_fingerprint`. They are plain indexing on
the decoder's stream, as the JAX decoder's are XLA ops.
"""
import collections
import hashlib
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as prng
from ..device import div_const, get_device
from ..models.generation import mask_logits
from ..ops import a8w8_matmul as a8
from ..ops import lora_delta as lora
from ..ops import ragged_paged_attention as rpa
from ..ops import w4_matmul as w4
from ..quantization import quantize_weight

__all__ = ["PagedGPTDecoder", "MultiDecodeOut", "RaggedMultiOut",
           "pow2_at_least", "pool_token_bytes", "INT4_GROUP"]

# decode_multi's result bundle (device tensors): a caller feeds
# tokens/lens/done/remaining into the next horizon and fetches
# tokens_block/done_before only at sync points; logits_block [k, S, V]
# is None unless asked for (speculation judges the draft's rows)
MultiDecodeOut = collections.namedtuple(
    "MultiDecodeOut", ["tokens_block", "done_before", "tokens", "lens",
                       "done", "remaining", "logits_block"])

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
        f"{what} is not ported to paddle_tpu_torch yet (the port serves "
        "float32/bfloat16/int8/int4 pools and W4A16 and A8W8 weights, "
        "greedy or sampled, packed or dense, with LoRA adapters, on one "
        "device; later slices add it)")


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


def _at(v, l):
    """Layer l of a stacked tensor or of a (payload, scales) tuple."""
    return tuple(x[l] for x in v) if isinstance(v, tuple) else v[l]


def _mm(x, w, b, quant=None):
    """x [..., in] @ w [in, out] + b, in x's dtype. The decoder's weight
    mode picks the product: under "w4a16" w is the int4 (packed, scale)
    pair (`ops.w4_matmul`); under "a8w8" the int8 (q [out, in], f32
    scale [out]) pair, run as dynamic per-row int8 activations times int8
    weights with the JAX decoder's epilogue, (acc * sx) * sw + b in f32
    with b from its stored dtype (`ops.a8w8_matmul`)."""
    if quant == "w4a16":
        return w4.w4_matmul(x, w[0], w[1], x.shape[-1]) + b
    if quant == "a8w8":
        return a8.a8w8_linear(x, w[0], w[1], b, a8.DECODER)
    return x @ w + b


def _quantize_kv(val):
    """Write-time per-token int8 quantization of K (or V) vectors (the
    JAX `_quantize_kv`): one symmetric scale per token from its own
    [H, D] amax, scale = max(amax / 127, 1e-8). val [..., H, D] ->
    (int8 [..., H, D], f32 scale [...])."""
    v32 = val.float()
    amax = v32.abs().amax(dim=(-2, -1))
    scale = torch.clamp_min(div_const(amax, 127.0), 1e-8)
    q = torch.clamp(torch.round(v32 / scale[..., None, None]), -127,
                    127).to(torch.int8)
    return q, scale


# int4 KV quantization group: one f32 scale per GROUP of flattened
# head*dim elements (the JAX `INT4_GROUP`)
INT4_GROUP = 32


def _pack_int4(q):
    """int4 values (int8 in [-8, 7], even last dim) -> uint8 nibble pairs:
    element 2i in the LOW nibble of byte i, 2i+1 in the high."""
    lo = q[..., 0::2].to(torch.uint8) & 0xF
    hi = q[..., 1::2].to(torch.uint8) & 0xF
    return lo | (hi << 4)


def _unpack_int4(packed):
    """Inverse of `_pack_int4`: uint8 nibble pairs -> int8 values in
    [-8, 7], last dim doubled."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (packed.shape[-1] * 2,))


def _quantize_kv_int4(val, group=INT4_GROUP):
    """Write-time int4 KV quantization with per-group scales (the JAX
    `_quantize_kv_int4`): the token's [H, D] vector flattens to H*D
    elements, zero-padded to whole groups; each group shares one scale
    max(amax / 7, 1e-8); values clip to [-7, 7] and pack two a byte (one
    spare zero nibble for an odd count). val [..., H, D] -> (uint8
    [..., ceil(G*group / 2)], f32 scales [..., G])."""
    v32 = val.float()
    hd = v32.shape[-2] * v32.shape[-1]
    group = min(int(group), hd)
    flat = v32.reshape(v32.shape[:-2] + (hd,))
    n_groups = (hd + group - 1) // group
    pad = n_groups * group - hd
    if pad:
        flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (pad,))],
                         dim=-1)
    g = flat.reshape(flat.shape[:-1] + (n_groups, group))
    scale = torch.clamp_min(div_const(g.abs().amax(-1), 7.0), 1e-8)
    q = torch.clamp(torch.round(g / scale[..., None]), -7, 7).to(
        torch.int8).reshape(flat.shape)
    if q.shape[-1] % 2:
        q = torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)
    return _pack_int4(q), scale


def _dequantize_kv_int4(packed, scale, heads_shape, group=INT4_GROUP):
    """Inverse of `_quantize_kv_int4` up to quantization error: unpack,
    multiply each group by its scale, reshape to [..., H, D]."""
    q = _unpack_int4(packed).float()
    hd = int(heads_shape[0]) * int(heads_shape[1])
    group = min(int(group), hd)
    n_groups = scale.shape[-1]
    q = q[..., :n_groups * group]             # drop the pack-parity pad
    g = q.reshape(q.shape[:-1] + (n_groups, group)) * scale[..., None]
    flat = g.reshape(q.shape[:-1] + (n_groups * group,))[..., :hd]
    return flat.reshape(q.shape[:-1] + tuple(heads_shape))


def pool_token_bytes(cfg, kv_quant=None, itemsize=2):
    """KV bytes one context token costs PER LAYER under a pool layout (K
    and V together): `itemsize` bytes an element unquantized; int8 one
    byte an element plus one f32 scale a token; int4 the stored nibbles
    (ceil-padded to whole groups and an even count) plus one f32 scale a
    group — the byte model behind `kv_token_bytes` and `step_hbm_bytes`.
    An unknown `kv_quant` raises."""
    if kv_quant not in (None, "int8", "int4"):
        raise ValueError(
            f"kv_quant must be None, 'int8' or 'int4', got {kv_quant!r} "
            "(an unquantized pool is kv_quant=None priced at `itemsize` "
            "bytes/elem — there is no 'bf16' spelling)")
    hd = cfg.num_heads * cfg.head_dim
    if kv_quant == "int4":
        group = min(INT4_GROUP, hd)
        n_groups = (hd + group - 1) // group
        per_tensor = (n_groups * group + 1) // 2 + 4 * n_groups
    elif kv_quant == "int8":
        per_tensor = hd + 4
    else:
        per_tensor = hd * itemsize
    return int(2 * per_tensor)


def _spec_accept(p_rows, q_rows, drafts, rng):
    """Rejection-sampling acceptance for ONE slot (Leviathan et al.; the
    JAX `_spec_accept`, the same numpy draws): p_rows [n+1, V] target
    probs — row j is the target's conditional AFTER the tokens preceding
    draft j (row 0 judges drafts[0]), q_rows [n, V] draft probs, drafts
    [n] proposed tokens. Accept draft j with prob min(1, p_j(d)/q_j(d));
    on rejection emit a sample from norm(max(p_j - q_j, 0)); if every
    draft is accepted emit a fresh sample from the last target row. The
    emitted tokens are distributed EXACTLY as target-only sampling.
    Returns (n_accepted, final_token)."""
    n = len(drafts)
    for j in range(n):
        d = int(drafts[j])
        q = q_rows[j, d]
        p = p_rows[j, d]
        if q <= 0.0 or rng.random() >= min(1.0, p / q):
            resid = np.maximum(p_rows[j] - q_rows[j], 0.0)
            tot = resid.sum()
            if tot <= 1e-12:       # p==q everywhere: any target sample
                resid, tot = p_rows[j], p_rows[j].sum()
            return j, int(rng.choice(len(resid), p=resid / tot))
    row = p_rows[n]
    return n, int(rng.choice(len(row), p=row / row.sum()))


def _sample_tokens(logits, sampling, keys):
    """Per-slot next token (the JAX `_sample_tokens`): greedy argmax, or
    one categorical draw a row from the `sampling` (temperature, top_k,
    top_p) mask under that row's key (keys [S, 2], see
    `PagedGPTDecoder._pos_keys`). int32."""
    if sampling is None:
        return logits.argmax(-1).to(torch.int32)
    temperature, top_k, top_p = sampling
    masked = mask_logits(logits, temperature, top_k, top_p)
    return prng.categorical(keys, masked).to(torch.int32)


def _kv_set(pool, pids, offs, val):
    """Write `val` [..., H, D] at (pids, offs) of ONE layer's page pool,
    in place — the single KV write primitive of every serving path
    (scratch routing is the caller's pids). A quantized (pages, scales)
    pool quantizes each token from its own values and stores payload and
    scales together: int8 pages per token (`_quantize_kv`), uint8 (int4)
    pages per group (`_quantize_kv_int4`)."""
    idx = (pids.long(), offs.long())
    if isinstance(pool, tuple):
        pages, scales = pool
        quantize = _quantize_kv_int4 if pages.dtype == torch.uint8 \
            else _quantize_kv
        q, s = quantize(val)
        pages[idx] = q
        scales[idx] = s
        return
    pool[idx] = val.to(pool.dtype)


class PagedGPTDecoder:
    """Stacked-weight GPT decode executor over paged KV pools.

    `state_dict` holds the JAX `GPT`'s keys in Paddle's [in, out] Linear
    layout (`models.init_state_dict`, or `models.state_dict_from_numpy`
    of a JAX model). The last page of the pool (`num_pages - 1`) is the
    reserved scratch page that absorbs every write of a padded, frozen
    or inactive position. `kv_quant` ("int8" | "int4") quantizes the KV
    pool; `quant="w4a16"` stores the qkv/proj/fc1/fc2 weights as int4,
    `quant="a8w8"` as int8 with int8 activations (`lm_head` stays
    unquantized, as in the JAX decoder)."""

    def __init__(self, cfg, state_dict, num_pages=128, page_size=16,
                 max_batch=8, max_pages_per_seq=None, quant=None,
                 kv_quant=None, dtype=None, temperature=0.0, top_k=0,
                 top_p=1.0, seed=0, mesh=None, packed=True, device=None):
        if quant not in (None, "a8w8", "w4a16"):
            raise ValueError(f"quant must be None, 'a8w8' or 'w4a16', got "
                             f"{quant!r}")
        if kv_quant not in (None, "int8", "int4"):
            raise ValueError(f"kv_quant must be None, 'int8' or 'int4', "
                             f"got {kv_quant!r}")
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (mesh=)")
        self.device = get_device(device)
        # the ragged horizon's and the chunked prefill's default layout:
        # the packed token stream, or the dense [n, W] window twin
        self.packed = bool(packed)
        # multi-LoRA: stacked low-rank adapter banks over the shared base
        # weights (`attach_adapters`). None = no adapters: every forward
        # then runs exactly the pre-tenancy launches
        self.lora = None
        self.n_adapters = 0
        self._adapter_salts = [b""]
        self.cfg = cfg
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_batch = max_batch
        self.max_pages = max_pages_per_seq or \
            (cfg.max_seq_len + page_size - 1) // page_size
        self.quant = quant
        self.kv_quant = kv_quant
        # temperature 0 = greedy (the reference decode convention)
        self.sampling = None if not temperature else \
            (float(temperature), int(top_k), float(top_p))
        self.seed = int(seed)
        self._base_key = prng.PRNGKey(self.seed, device=self.device)
        dtype = dtype or cfg.dtype
        self.compute_dtype = _DTYPES[dtype] if isinstance(dtype, str) \
            else dtype
        dev, cd = self.device, self.compute_dtype
        L, H, D = cfg.num_layers, cfg.num_heads, cfg.head_dim
        sd = state_dict

        def stack(fmt, dtype=None):
            """The L layers' tensors stacked on the device, in `dtype`
            (None: their stored dtype)."""
            v = torch.stack([sd[fmt.format(i)] for i in range(L)])
            return v.to(dev, dtype or v.dtype)

        def linear(name):
            """Stacked [L, in, out] weight in the compute dtype (the JAX
            decoder casts at each use: `x @ w.astype(x.dtype)`); under
            w4a16 the stacked (packed, scale) int4 pair, under a8w8 the
            stacked (int8 [L, out, in], f32 scale [L, out]) pair, stored
            transposed (K-contiguous) for the int8 kernel's B operand. Both
            quantize once on the device from the state dict's own values
            taken to f32 (what the JAX `quantize_weight` sees; a
            compute-dtype copy would move the scales); the qkv weight's
            [h, 3*H*D] is the JAX decoder's head-major flattening."""
            if quant is None:
                return stack(f"blocks.{{}}.{name}.weight", cd)
            w32 = (sd[f"blocks.{i}.{name}.weight"].to(dev, torch.float32)
                   for i in range(L))
            if quant == "w4a16":
                per_layer = [w4.quantize_w4(w) for w in w32]
            else:
                per_layer = [(q.t().contiguous(), s.reshape(-1)) for q, s in
                             (quantize_weight(w, axis=0) for w in w32)]
            return tuple(torch.stack(part) for part in zip(*per_layer))

        # biases in the compute dtype, or under a8w8 in their stored dtype
        # (its epilogue adds them in f32, as the JAX decoder adds `b`
        # uncast); LayerNorm affine in f32, as `_ln` promotes it. The qkv
        # weight keeps the JAX decoder's head-major column order: [L, h,
        # 3*H*D] is the same memory as its [L, h, 3, H, D].
        bias_dtype = None if quant == "a8w8" else cd
        self.weights = {
            "ln1_w": stack("blocks.{}.ln1.weight", torch.float32),
            "ln1_b": stack("blocks.{}.ln1.bias", torch.float32),
            "qkv_w": linear("qkv"),
            "qkv_b": stack("blocks.{}.qkv.bias", bias_dtype),
            "proj_w": linear("proj"),
            "proj_b": stack("blocks.{}.proj.bias", bias_dtype),
            "ln2_w": stack("blocks.{}.ln2.weight", torch.float32),
            "ln2_b": stack("blocks.{}.ln2.bias", torch.float32),
            "fc1_w": linear("fc1"),
            "fc1_b": stack("blocks.{}.fc1.bias", bias_dtype),
            "fc2_w": linear("fc2"),
            "fc2_b": stack("blocks.{}.fc2.bias", bias_dtype),
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
        self.k_pages = self._new_pool(L, num_pages, page_size, H, D)
        self.v_pages = self._new_pool(L, num_pages, page_size, H, D)
        # engines serving over this pool: `load_pool_state` refuses while
        # one of them holds pages
        self._engines = weakref.WeakSet()
        # copies between host and card, one a pool leaf: the tier's
        # spills (D2H) and restores (H2D)
        self.transfers = {"d2h": 0, "h2d": 0}
        # (event, pinned staging buffer) of restores the card may not
        # have copied yet: the buffer lives until its event has passed
        self._h2d_pending = []

    def _new_pool(self, L, P, ps, H, D):
        """One zeroed K (or V) pool: [L, P, ps, H, D] in the compute
        dtype; int8 pages + per-token f32 scales [L, P, ps]; or int4
        nibble pages [L, P, ps, PB] + per-group f32 scales [L, P, ps, G]
        (H*D packed two a byte, padded to whole groups)."""
        dev = self.device
        if self.kv_quant == "int4":
            hd = H * D
            grp = min(INT4_GROUP, hd)
            G = (hd + grp - 1) // grp
            PB = (G * grp + 1) // 2
            return (torch.zeros((L, P, ps, PB), dtype=torch.uint8,
                                device=dev),
                    torch.zeros((L, P, ps, G), device=dev))
        if self.kv_quant == "int8":
            return (torch.zeros((L, P, ps, H, D), dtype=torch.int8,
                                device=dev),
                    torch.zeros((L, P, ps), device=dev))
        return torch.zeros((L, P, ps, H, D), dtype=self.compute_dtype,
                           device=dev)

    # -- forward bodies ----------------------------------------------------

    def _as_i32(self, x):
        return torch.as_tensor(x, dtype=torch.int32,
                               device=self.device).contiguous()

    def _embed(self, tokens, pos):
        pos = pos.long().clamp(0, self.cfg.max_seq_len - 1)
        return (self.wte[tokens.long()] + self.wpe[pos]).to(
            self.compute_dtype)

    def _layer(self, l, x, pids, offs, attend, aids=None):
        """ONE transformer layer over flat new tokens x [T, h]: write each
        token's K/V at (pids, offs), attend through `attend(q, kp, vp)`
        (dense windows or the packed stream), then residual proj + FFN.
        `aids` [T] (a bank attached; None otherwise) adds each token's
        adapter delta right after the qkv product (`ops.lora_delta`).
        Per-token math is row-local, so a token's bytes do not depend on
        what else is in the batch (up to the matmul library's choice of
        algorithm for the batch size)."""
        w = {k: _at(v, l) for k, v in self.weights.items()}
        H, D = self.cfg.num_heads, self.cfg.head_dim
        T = x.shape[0]
        y = _ln(x, w["ln1_w"], w["ln1_b"])
        quant = self.quant
        qkv = _mm(y, w["qkv_w"], w["qkv_b"], quant)
        if aids is not None:
            lora.lora_delta_(qkv, y, self.lora["lora_A"][l],
                             self.lora["lora_B"][l], aids)
        qkv = qkv.view(T, 3, H, D)
        kp, vp = _at(self.k_pages, l), _at(self.v_pages, l)
        _kv_set(kp, pids, offs, qkv[:, 1])
        _kv_set(vp, pids, offs, qkv[:, 2])
        attn = attend(qkv[:, 0].contiguous(), kp, vp).to(x.dtype)
        x = x + _mm(attn.reshape(T, H * D), w["proj_w"], w["proj_b"],
                    quant)
        y = _ln(x, w["ln2_w"], w["ln2_b"])
        h = F.gelu(_mm(y, w["fc1_w"], w["fc1_b"], quant), approximate="tanh")
        return x + _mm(h, w["fc2_w"], w["fc2_b"], quant)

    def _logits(self, x):
        x = _ln(x, self.ln_f_w, self.ln_f_b)
        return x.float() @ self.lm_head

    def _forward_tokens(self, tokens, lens, table, pids, offs, aids=None):
        """Shared single-position forward over all slots: embed `tokens`
        at position `lens`, write K/V at (pids, offs) — callers route
        frozen slots' pids to scratch — and attend over each slot's pages
        (the dense kernel form, W=1); `aids` [S] the slots' adapters.
        Returns logits [S, V]."""
        x = self._embed(tokens, lens)

        def attend(q, kp, vp):
            return rpa.ragged_paged_attention(q[:, None], kp, vp, table,
                                              lens)[:, 0]

        for l in range(self.cfg.num_layers):
            x = self._layer(l, x, pids, offs, attend, aids)
        return self._logits(x)

    def _slot_pids(self, table, lens):
        # clamped: a frozen slot's lens may point past its table row; the
        # caller routes such writes to scratch
        col = (lens.long() // self.page_size).clamp(max=table.shape[1] - 1)
        return table.gather(1, col[:, None])[:, 0]

    def _pos_keys(self, kids, pos):
        """Per-slot keys fold_in(fold_in(PRNGKey(seed), kid), pos) [S, 2]
        (the JAX `_pos_keys`): a draw depends only on the decoder's seed,
        the request (`kids`: the engine passes request ids) and the
        position of the token being consumed — nothing of the schedule."""
        return prng.fold_in(prng.fold_in(self._base_key, kids), pos)

    def _pick(self, logits, kids, pos):
        keys = (self._pos_keys(kids, pos) if self.sampling is not None
                else None)
        return _sample_tokens(logits, self.sampling, keys)

    def _probs_of(self, logits):
        """Softmax over the decoder's sampling mask (`mask_logits`: the
        distribution its sampled tokens are drawn from; the plain softmax
        on a greedy decoder), fetched to the host as f32 numpy — the rows
        speculative acceptance judges."""
        lg = logits.float()
        if self.sampling:
            lg = mask_logits(lg, *self.sampling)
        return torch.softmax(lg, dim=-1).cpu().numpy()

    def _decode_step(self, tokens, lens, table, kids=None, aids=None):
        """tokens [S], lens [S] (position of the incoming token), table
        [S, max_pages], kids [S] (sampling key ids, default the slot
        index), aids [S] (adapter ids, a bank attached) -> (next [S]
        int32, logits [S, V])."""
        kids = self._kids(kids)
        pids = self._slot_pids(table, lens)
        logits = self._forward_tokens(tokens, lens, table, pids,
                                      lens % self.page_size, aids)
        return self._pick(logits, kids, lens), logits

    def _decode_multi_step(self, tokens, lens, table, kids, done, remaining,
                           eos, k, return_logits=False, aids=None):
        """K fused decode ticks; each tick's token feeds the next on the
        device, tick j drawing with the (seed, kid, lens + j) keys the
        per-tick loop uses. `done` [S] freezes a slot from tick 0; a slot
        also freezes after emitting `eos` (-1: none) or after `remaining`
        tokens. Frozen slots' lens stop advancing and their K/V writes
        route to the scratch page. Returns (block [k, S], done_before
        [k, S], tokens, lens, done, remaining, logits [k, S, V] or
        None)."""
        scratch = self.num_pages - 1
        block, before, tick_logits = [], [], []
        for _ in range(k):
            pids = torch.where(done, scratch, self._slot_pids(table, lens))
            logits = self._forward_tokens(tokens, lens, table, pids,
                                          lens % self.page_size, aids)
            nxt = self._pick(logits, kids, lens)
            nxt = torch.where(done, tokens, nxt)
            rem = torch.where(done, remaining, remaining - 1)
            new_done = done | (nxt == eos) | (rem <= 0)
            lens = torch.where(done, lens, lens + 1)
            block.append(nxt)
            before.append(done)
            if return_logits:
                tick_logits.append(logits)
            tokens, done, remaining = nxt, new_done, rem
        return (torch.stack(block), torch.stack(before), tokens, lens, done,
                remaining,
                torch.stack(tick_logits) if return_logits else None)

    def _packed_forward(self, ptok, pos, rows, write_ok, table, last_idx,
                        sample_pos, kids, live, aids=None):
        """The shared PACKED forward: consume the flat token stream `ptok`
        [T] (token t = table row `rows[t]` at position `pos[t]`), write
        real tokens' K/V (`write_ok` False routes to scratch: padded tail,
        frozen rows, table overflow) and attend each token over its own
        row's pages. `last_idx` [S] indexes each row's last stream token,
        whose hidden state prices the row's logits (masked by `live`);
        `sample_pos` [S] is the row's sampling position (true_len - 1),
        `kids` [S] its key id and `aids` [S] its adapter (each token wears
        its row's: `aids[rows]`). Returns next [S] int32."""
        ps, MP = self.page_size, table.shape[1]
        x = self._embed(ptok, pos)
        col = (pos.long() // ps).clamp(max=MP - 1)
        pids = table[rows.long(), col]
        pids = torch.where(write_ok, pids, self.num_pages - 1)
        offs = pos % ps

        def attend(q, kp, vp):
            return rpa.ragged_paged_attention_packed(q, kp, vp, table, rows,
                                                     pos)

        tok_aids = None if aids is None else aids[rows.long()].contiguous()
        for l in range(self.cfg.num_layers):
            x = self._layer(l, x, pids, offs, attend, tok_aids)
        last = x[last_idx.long().clamp(0, x.shape[0] - 1)]       # [S, h]
        last = torch.where(live[:, None], last, 0.0)
        return self._pick(self._logits(last), kids, sample_pos)

    def _packed_multi_step(self, tokens, lens, table, kids, done, remaining,
                           eos, pend, pend_n, w, k, t, aids=None):
        """K MIXED ticks over the PACKED [t] token stream: a tick's stream
        concatenates every live row's new tokens (decode rows ONE token,
        prefilling rows their next min(pend_n, w) suffix tokens, frozen
        rows nothing). The layout (cumsum + searchsorted over per-row
        token counts) is built on the device each tick from the carry,
        with fixed-size tensors only, so the loop never waits for the
        card. A prefilling row emits nothing until the tick that consumes
        its last suffix token, which also yields its first generated
        token; it draws with the (seed, kid, true_len - 1) key the
        per-tick loop uses there. Returns the RaggedMultiOut fields
        (tokens_block [k, S], emitted [k, S], real [k], finals...)."""
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
                                       write_ok, table, last_idx,
                                       lens + nl - 1, kids, live, aids)
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

    def _windowed_forward(self, ids, pos, write_ok, table, aids=None):
        """The dense WINDOW forward, one body for every dense path (the
        JAX `_windowed_layer`: the verify window, the dense prefill and
        each tick of the dense ragged twin). ids / pos [n, W]: row i's
        window at positions pos[i, 0] + arange(W); K/V is written where
        `write_ok` holds and routed to the scratch page elsewhere (padded
        tail, frozen rows, table overflow); each window attends over its
        own row's pages through the kernel's dense form (q [n, W, H, D],
        start pos[:, 0]). The layers run `_layer` on the flattened
        [n * W] tokens, so a position computes what the packed stream
        computes for it; every window token of row i wears row i's adapter
        (`aids` [n]). Returns the final hidden states [n, W, h]."""
        n, W = ids.shape
        ps, MP = self.page_size, table.shape[1]
        H, D = self.cfg.num_heads, self.cfg.head_dim
        x = self._embed(ids, pos).reshape(n * W, -1)
        pids = table.gather(1, (pos.long() // ps).clamp(max=MP - 1))
        pids = torch.where(write_ok, pids, self.num_pages - 1).reshape(-1)
        offs = (pos % ps).reshape(-1)
        start = pos[:, 0].contiguous()

        def attend(q, kp, vp):
            return rpa.ragged_paged_attention(
                q.view(n, W, H, D), kp, vp, table, start).reshape(
                    n * W, H, D)

        tok_aids = None if aids is None else \
            aids[:, None].expand(n, W).reshape(-1).contiguous()
        for l in range(self.cfg.num_layers):
            x = self._layer(l, x, pids, offs, attend, tok_aids)
        return x.view(n, W, -1)

    def _window_pos(self, start, W):
        return start[:, None] + torch.arange(W, dtype=torch.int32,
                                             device=self.device)

    def _ragged_forward(self, ids, start, true_len, table, kids,
                        frozen=None, aids=None):
        """The dense RAGGED chunk forward (the JAX `_ragged_forward`):
        each row's [W]-wide window of new tokens at positions
        start..true_len-1 (zero-padded past it), attending over the row's
        paged prefix. K/V of padded positions, table overflow and
        `frozen` rows goes to the scratch page. Returns the next token
        [n], sampled at position true_len - 1 with the (seed, kid,
        position) key."""
        n, W = ids.shape
        pos = self._window_pos(start, W)
        ok = (pos < true_len[:, None]) & (pos < table.shape[1] *
                                          self.page_size)
        if frozen is not None:
            ok = ok & ~frozen[:, None]
        x = self._windowed_forward(ids, pos, ok, table, aids)
        col = (true_len - 1 - start).clamp(0, W - 1).long()
        last = x[torch.arange(n, device=self.device), col]       # [n, h]
        return self._pick(self._logits(last), kids, true_len - 1)

    def _verify_step(self, tokens, lens, table):
        """Speculative verify: tokens [S, W] (the last accepted token and
        the draft's proposals) consumed in ONE forward — K/V written at
        positions lens..lens+W-1 (past the table's capacity: scratch),
        causal attention over the paged prefix. Rejected positions need
        no cleanup: lens is the source of truth and stale entries are
        overwritten. Returns (argmax [S, W] int32, f32 logits [S, W,
        V])."""
        S, W = tokens.shape
        pos = self._window_pos(lens, W)
        x = self._windowed_forward(
            tokens, pos, pos < table.shape[1] * self.page_size, table)
        logits = self._logits(x.reshape(S * W, -1)).view(S, W, -1)
        return logits.argmax(-1).to(torch.int32), logits

    def _ragged_multi_step(self, tokens, lens, table, kids, done, remaining,
                           eos, pend, pend_n, w, k, aids=None):
        """K MIXED ticks in the DENSE [S, w] window layout (the packed
        stream's A/B twin, the JAX `_ragged_multi_step`): a prefilling
        row's window is its next min(pend_n, w) suffix tokens, a decode
        row's its one token (zero-padded to w), a frozen row's writes go
        to scratch. Emission, keys and the carry follow
        `_packed_multi_step` exactly. Returns the RaggedMultiOut
        fields."""
        S, P = pend.shape
        dev = self.device
        pad = torch.zeros((S, max(w - 1, 0)), dtype=torch.int32, device=dev)
        shift = torch.arange(P, device=dev) + w
        shift_ok = shift < P
        shift_idx = shift.clamp(max=P - 1).expand(S, P)
        block, emitted, real = [], [], []
        for _ in range(k):
            is_pf = pend_n > 0
            new_len = torch.where(is_pf, pend_n.clamp(max=w), 1).to(
                torch.int32)
            window = torch.cat([tokens[:, None], pad], dim=1)
            ids = torch.where(is_pf[:, None], pend[:, :w], window)
            nxt = self._ragged_forward(ids, lens, lens + new_len, table,
                                       kids, frozen=done, aids=aids)
            emit = ~done & (pend_n <= w)
            nxt = torch.where(emit, nxt, tokens)
            rem = torch.where(emit, remaining - 1, remaining)
            new_done = done | (emit & ((nxt == eos) | (rem <= 0)))
            real.append(torch.where(done, 0, new_len).sum().to(torch.int32))
            lens = torch.where(done, lens, lens + new_len)
            pend = torch.where(shift_ok, pend.gather(1, shift_idx), 0)
            pend_n = (pend_n - w).clamp(min=0)
            block.append(nxt)
            emitted.append(emit)
            tokens, done, remaining = nxt, new_done, rem
        return (torch.stack(block), torch.stack(emitted), torch.stack(real),
                tokens, lens, done, remaining, pend, pend_n)

    # -- host-side API -----------------------------------------------------

    def prefill(self, ids, page_ids, kid=None):
        """Run one prompt through the model, writing KV into `page_ids`;
        returns the next token (greedy or sampled)."""
        return self.prefill_batch([(ids, page_ids)],
                                  kids=None if kid is None else [kid])[0]

    def prefill_batch(self, requests, kids=None):
        """Prefill several prompts in full. requests: [(ids, page_ids),
        ...]; returns the first generated token per request (in order).
        `kids`: the requests' sampling key ids (default: their index in
        this call; the engine passes request ids). A thin wrapper over
        the packed chunked prefill at start=0."""
        return self.prefill_suffix_batch(
            [(ids, 0, pages) for ids, pages in requests], kids=kids)

    def prefill_suffix_batch(self, requests, kids=None, packed=None,
                             aids=None):
        """Chunked prefill over page-table rows. requests: [(suffix_ids,
        start, pages), ...] — `pages` is the sequence's page list in
        block order, `start` the already-cached prefix length (0: the
        suffix IS the prompt). PACKED (`packed=None`: the decoder's
        flag): each group of up to max_batch requests runs as ONE flat
        [total_tokens] stream, bucketed to a power of two; `packed=False`
        runs the dense window twin (`_prefill_dense_batch`), whose first
        tokens are the same. `aids`: the requests' adapter ids (a bank
        attached; default all base). Returns the first generated token per
        request (in order)."""
        if packed is None:
            packed = self.packed
        if packed:
            return self._prefill_packed_batch(requests, kids=kids, aids=aids)
        return self._prefill_dense_batch(requests, kids=kids, aids=aids)

    def _prefill_dense_batch(self, requests, kids=None, aids=None):
        """DENSE prefill dispatch (the JAX `_prefill_suffix_step` path):
        requests group by window width W (4 doubled to cover the suffix),
        each group in chunks of nb rows (a power of two up to max_batch),
        one `_ragged_forward` of [nb, W] windows a chunk. A request
        samples at (kid, start + len - 1)."""
        results = [None] * len(requests)
        if kids is None:
            kids = list(range(len(requests)))
        if aids is None:
            aids = [0] * len(requests)
        MP = self.max_pages
        groups = {}
        for i, (ids, start, pages) in enumerate(requests):
            ids = np.asarray(ids, np.int32).reshape(-1)
            W = 4
            while W < len(ids):
                W *= 2
            groups.setdefault(W, []).append((i, ids, int(start), pages))
        for W, group in groups.items():
            while group:
                nb = 1
                while nb * 2 <= len(group) and nb * 2 <= self.max_batch:
                    nb *= 2
                chunk, group = group[:nb], group[nb:]
                pad = np.zeros((nb, W), np.int32)
                st = np.zeros(nb, np.int32)
                tl = np.ones(nb, np.int32)
                tbl = np.full((nb, MP), self.num_pages - 1, np.int32)
                kd = np.zeros(nb, np.int32)
                ad = np.zeros(nb, np.int32)
                for r, (i, ids, start, pages) in enumerate(chunk):
                    pad[r, :len(ids)] = ids
                    st[r] = start
                    tl[r] = start + len(ids)
                    m = min(len(pages), MP)
                    tbl[r, :m] = pages[:m]     # rest stays on scratch
                    kd[r] = kids[i]
                    ad[r] = aids[i]
                nxt = self._ragged_forward(
                    self._as_i32(pad), self._as_i32(st), self._as_i32(tl),
                    self._as_i32(tbl), self._kids(kd),
                    aids=self._aids(ad)).tolist()
                for r, (i, _, _, _) in enumerate(chunk):
                    results[i] = nxt[r]
        return results

    def _prefill_packed_batch(self, requests, kids=None, aids=None):
        """PACKED prefill dispatch: the layout (flat tokens, per-token row
        ids and positions) is built on the host, where all lengths are
        known, and sent to the device in one go per group. A request
        samples at (kid, start + len - 1)."""
        results = [None] * len(requests)
        if kids is None:
            kids = list(range(len(requests)))
        if aids is None:
            aids = [0] * len(requests)
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
            spos = np.zeros(S, np.int32)
            kd = np.zeros(S, np.int32)
            ad = np.zeros(S, np.int32)
            live = np.zeros(S, bool)
            tbl = np.full((S, MP), self.num_pages - 1, np.int32)
            cur = 0
            for r, (i, (ids, start, pages)) in enumerate(chunk):
                ids = np.asarray(ids, np.int32).reshape(-1)
                n = len(ids)
                ptok[cur:cur + n] = ids
                pos[cur:cur + n] = int(start) + np.arange(n)
                rows[cur:cur + n] = r
                ok[cur:cur + n] = pos[cur:cur + n] < MP * ps
                last_idx[r] = max(cur + n - 1, 0)
                spos[r] = int(start) + n - 1
                kd[r] = kids[i]
                ad[r] = aids[i]
                live[r] = n > 0
                m = min(len(pages), MP)
                tbl[r, :m] = pages[:m]       # rest stays on scratch
                cur += n
            nxt = self._packed_forward(
                self._as_i32(ptok), self._as_i32(pos), self._as_i32(rows),
                torch.as_tensor(ok, device=self.device), self._as_i32(tbl),
                self._as_i32(last_idx), self._as_i32(spos),
                self._kids(kd),
                torch.as_tensor(live, device=self.device),
                aids=self._aids(ad)).tolist()
            for r, (i, _) in enumerate(chunk):
                results[i] = nxt[r]
        return results

    def _kids(self, kids):
        """Sampling key ids (array or tensor) on the device, default the
        slot index; None on a greedy decoder, which reads no key (so no
        copy to the device)."""
        if self.sampling is None:
            return None
        if kids is None:
            kids = np.arange(self.max_batch, dtype=np.int32)
        return self._as_i32(kids)

    def _aids(self, aids):
        """Adapter ids on the device (numpy, list or tensor; default all
        base), or None when no bank is attached — the forwards then run
        no adapter launch at all. Host ids outside the bank raise here,
        before a launch (the kernel skips rows it cannot index)."""
        if self.lora is None:
            return None
        if aids is None:
            aids = np.zeros(self.max_batch, np.int32)
        if not isinstance(aids, torch.Tensor):
            aids = np.asarray(aids, np.int32)
            if aids.size and (aids.min() < 0 or
                              aids.max() > self.n_adapters):
                raise ValueError(
                    f"adapter ids {sorted(set(aids.tolist()))} outside the "
                    f"attached bank's 0 (base) .. {self.n_adapters}")
        return self._as_i32(aids)

    def decode(self, tokens, lens, table, kids=None, aids=None):
        """One decode step for all slots (greedy or sampled; `kids` the
        slots' key ids, default the slot index — the engine passes
        request ids; `aids` [S] the slots' LoRA adapters when a bank is
        attached, `attach_adapters`). Returns next [S] int32 on the
        device."""
        nxt, _ = self._decode_step(self._as_i32(tokens), self._as_i32(lens),
                                   self._as_i32(table), kids,
                                   aids=self._aids(aids))
        return nxt

    def decode_multi(self, tokens, lens, table, k, kids=None, done=None,
                     remaining=None, eos=None, return_logits=False,
                     aids=None):
        """Run `k` decode ticks device-resident: the tokens each tick
        emits feed the next without a host sync (see
        `_decode_multi_step`). Inputs and outputs may stay on the device.
        `aids` [S]: per-slot adapters (a bank attached). Returns a
        MultiDecodeOut; its `logits_block` [k, S, V] is None unless
        `return_logits` (speculation judges the draft's rows)."""
        k, S = int(k), self.max_batch
        if done is None:
            done = np.zeros(S, bool)
        if remaining is None:
            remaining = np.full(S, _NO_LIMIT, np.int32)
        out = self._decode_multi_step(
            self._as_i32(tokens), self._as_i32(lens), self._as_i32(table),
            self._kids(kids),
            torch.as_tensor(done, dtype=torch.bool, device=self.device),
            self._as_i32(remaining), -1 if eos is None else int(eos), k,
            return_logits=bool(return_logits), aids=self._aids(aids))
        return MultiDecodeOut(*out)

    def verify(self, tokens, lens, table, return_probs=False):
        """Batched speculative verify (see `_verify_step`): the target's
        greedy choice after every window position, [S, W] int32 numpy;
        with `return_probs` also the [S, W, V] f32 distributions
        (`_probs_of`) acceptance compares with the draft's."""
        nxt, logits = self._verify_step(self._as_i32(tokens),
                                        self._as_i32(lens),
                                        self._as_i32(table))
        if return_probs:
            return nxt.cpu().numpy(), self._probs_of(logits)
        return nxt.cpu().numpy()

    @property
    def pend_capacity(self):
        """Static width of the ragged horizon's device-resident prompt
        suffix buffer: the pool's per-sequence token capacity."""
        return self.max_pages * self.page_size

    def ragged_multi(self, tokens, lens, table, k, w, pend, pend_n,
                     kids=None, done=None, remaining=None, eos=None,
                     packed=None, t_tokens=None, aids=None):
        """Run `k` MIXED ragged ticks device-resident: decode rows and
        prefill-chunk rows serve together, up to w suffix tokens per
        prefilling slot per tick. PACKED (`packed=None`: the decoder's
        flag): the flat [t_tokens] token stream; `t_tokens` must cover
        the largest per-tick total (default: the dense-equivalent S*w
        bound). `packed=False`: the dense [S, w] window twin
        (`_ragged_multi_step`), the same streams. `pend` [S, P] /
        `pend_n` [S] are the carried prompt suffixes (P =
        `pend_capacity`); `aids` [S] the slots' adapters (a bank
        attached). Returns a RaggedMultiOut."""
        k, w, S = int(k), int(w), self.max_batch
        if packed is None:
            packed = self.packed
        if done is None:
            done = np.zeros(S, bool)
        if remaining is None:
            remaining = np.full(S, _NO_LIMIT, np.int32)
        carry = (self._as_i32(tokens), self._as_i32(lens),
                 self._as_i32(table), self._kids(kids),
                 torch.as_tensor(done, dtype=torch.bool, device=self.device),
                 self._as_i32(remaining), -1 if eos is None else int(eos),
                 self._as_i32(pend), self._as_i32(pend_n), w, k)
        aids = self._aids(aids)
        if not packed:
            return RaggedMultiOut(*self._ragged_multi_step(*carry,
                                                           aids=aids))
        if t_tokens is None:
            t_tokens = pow2_at_least(S * max(w, 1))
        t = max(int(t_tokens), 1)
        if t < S:
            # every live slot owns at least one stream share; a bucket
            # below S could silently drop rows' tokens
            raise ValueError(
                f"t_tokens {t} < max_batch {S}: the packed bucket must "
                "cover at least one token per slot")
        return RaggedMultiOut(*self._packed_multi_step(*carry, t, aids=aids))

    # -- pages: copy-on-write, host tier, persistence -----------------------

    def _leaves(self):
        """(part, leaf index, tensor) of every pool leaf: K and V, and the
        scale planes of a quantized pool."""
        for part, pool in (("k", self.k_pages), ("v", self.v_pages)):
            for i, leaf in enumerate(pool if isinstance(pool, tuple)
                                     else (pool,)):
                yield part, i, leaf

    def copy_page(self, src, dst):
        """Device-side page copy (K and V, every layer, every pool leaf):
        the engine's copy-on-write primitive. An int8 pool's [L, P, ps]
        and an int4 pool's [L, P, ps, G] scale planes travel with the page
        bytes; a copy that left them behind would dequantize the private
        page with stale scales."""
        for _, _, leaf in self._leaves():
            leaf[:, int(dst)] = leaf[:, int(src)]

    def fetch_page_payload(self, page):
        """D2H copy of ONE page's bytes across every layer (the host
        tier's spill primitive): {"k": (leaves...), "v": (...)}, each leaf
        the pool leaf at the page ([L, ps, ...]). `mount_page_payload` is
        its lossless inverse."""
        return self.fetch_page_payloads([page])[0]

    def fetch_page_payloads(self, pages):
        """D2H copy of a whole eviction wave: each pool leaf is gathered
        at all `pages` on the card ([L, n, ps, ...], one `index_select`)
        and copied to host memory in one transfer (pinned when the pool is
        on the card), then split into per-page payload views. The copy is
        synchronous and ordered on the decoder's stream after every
        horizon already dispatched, so it reads the pages' final bytes."""
        idx = torch.as_tensor([int(p) for p in pages], dtype=torch.long,
                              device=self.device)
        pin = self.device.type == "cuda"
        host = {"k": [], "v": []}
        for part, _, leaf in self._leaves():
            g = leaf.index_select(1, idx)
            buf = torch.empty(g.shape, dtype=g.dtype, pin_memory=pin)
            buf.copy_(g)
            self.transfers["d2h"] += 1
            host[part].append(buf)
        return [{part: tuple(buf[:, i] for buf in host[part])
                 for part in ("k", "v")} for i in range(len(pages))]

    def mount_page_payload(self, page, payload):
        """H2D restore of one spilled page (`fetch_page_payload`'s
        inverse)."""
        self.mount_page_payloads([page], [payload])

    def mount_page_payloads(self, pages, payloads):
        """H2D restore of a whole span: per pool leaf, the payloads are
        stacked into one staging buffer ([L, n, ps, ...], pinned when the
        pool is on the card), copied to the card in one asynchronous
        transfer and scattered into the n pages with one `index_copy_`,
        all on the decoder's stream, so every later horizon reads the
        restored bytes. The staging buffer is kept until the card has
        copied it."""
        self._h2d_pending = [(ev, buf) for ev, buf in self._h2d_pending
                             if not ev.query()]
        idx = torch.as_tensor([int(p) for p in pages], dtype=torch.long,
                              device=self.device)
        pin = self.device.type == "cuda"
        for part, i, leaf in self._leaves():
            srcs = [torch.as_tensor(p[part][i]) for p in payloads]
            buf = torch.empty((leaf.shape[0], len(srcs)) + leaf.shape[2:],
                              dtype=leaf.dtype, pin_memory=pin)
            torch.stack(srcs, dim=1, out=buf)
            leaf.index_copy_(1, idx, buf.to(self.device, non_blocking=True))
            self.transfers["h2d"] += 1
            if pin:
                ev = torch.cuda.Event()
                ev.record()
                self._h2d_pending.append((ev, buf))

    def pool_state(self):
        """Checkpointable KV-pool state: the page tensors (and the scale
        planes of a quantized pool) plus the quant config that wrote
        them. `load_pool_state` refuses a mismatched config."""
        return {"kv_quant": self.kv_quant or "",
                "k_pages": self.k_pages, "v_pages": self.v_pages}

    def load_pool_state(self, state):
        """Copy a `pool_state()` snapshot (tensors or numpy arrays) into
        this decoder's own pool tensors — never aliasing the caller's
        memory. The quant config, leaf dtypes and shapes must match this
        pool exactly, and no engine over this decoder may hold pages:
        swapping the bytes under a slot table or a cache entry (live or
        parked) would orphan its ledger (`PrefixCache.load` rebuilds the
        decoder + cache pair instead)."""
        for eng in list(self._engines):
            held = sum(len(p) for p in getattr(eng, "_slot_pages", ()))
            cache = getattr(eng, "cache", None)
            tracked = cache.n_pages if cache is not None else 0
            if held or tracked:
                raise RuntimeError(
                    f"cannot load pool state: a live "
                    f"{type(eng).__name__} holds {held} slot page(s) "
                    f"and its prefix cache tracks {tracked} page(s) "
                    "over this pool — swapping the page bytes now "
                    "would orphan its ledger (a parked entry's next "
                    "hit would mount checkpoint bytes under the old "
                    "chain key); drain the engine and rebuild the "
                    "decoder+cache pair (PrefixCache.load) instead")
        quant = state.get("kv_quant", "") or None
        if quant != self.kv_quant:
            raise ValueError(
                f"KV pool quant config mismatch: this decoder stores "
                f"{self.kv_quant or 'unquantized'} pages but the "
                f"checkpointed pool was written {quant or 'unquantized'} "
                "— reinterpreting the bytes would decode garbage tokens; "
                f"rebuild the decoder with kv_quant={quant!r} or "
                "re-prefill from tokens")
        for name in ("k_pages", "v_pages"):
            have = getattr(self, name)
            have = have if isinstance(have, tuple) else (have,)
            want = state[name] if isinstance(state[name], tuple) \
                else (state[name],)
            want = tuple(torch.as_tensor(w) for w in want)
            if len(have) != len(want) or any(
                    h.shape != w.shape or h.dtype != w.dtype
                    for h, w in zip(have, want)):
                raise ValueError(
                    f"KV pool state mismatch on {name}: expected "
                    f"{[(tuple(h.shape), str(h.dtype)) for h in have]}, "
                    f"got {[(tuple(w.shape), str(w.dtype)) for w in want]}")
            for h, w in zip(have, want):
                h.copy_(w)

    # -- multi-LoRA ----------------------------------------------------------

    def attach_adapters(self, adapters, alpha=None):
        """Attach stacked low-rank (LoRA) adapter banks for multi-LoRA
        serving (the JAX `attach_adapters`): `adapters` is a list of
        per-adapter (A, B) pairs (numpy or tensors) with A [L, h, r] and
        B [L, r, 3, H, D] (or [L, r, 3*H*D]) — the low-rank qkv delta of
        one fine-tuned variant over the SHARED base weights. Adapter id 0
        is the base model (an exact all-zero bank); caller adapters are
        ids 1..n. Mixed ranks zero-pad to the max (zero rows and columns
        add exact 0.0). `alpha` scales every delta by alpha/r, folded into
        B here (default: alpha == r, scale 1). The bank lives on the
        decoder's device as A [L, n+1, h, R] and B [L, n+1, R, 3*H*D] in
        f32; each layer's delta reads it in place by adapter id
        (`ops.lora_delta`). Per-adapter `adapter_salt`s — blake2b content
        hashes, byte-equal to the JAX decoder's — keep prefix-cache pages
        from aliasing across variants; `cache_fingerprint` keeps reading
        the base weights only."""
        cfg = self.cfg
        L, h = cfg.num_layers, cfg.hidden_size
        hd3 = 3 * cfg.num_heads * cfg.head_dim

        def host(x):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().float().numpy()
            return np.asarray(x, np.float32)
        ranks, pairs = [], []
        for a, b in adapters:
            a = host(a)
            b = host(b).reshape(L, a.shape[-1], hd3)
            if a.shape != (L, h, a.shape[-1]):
                raise ValueError(
                    f"adapter A must be [num_layers, hidden, r], got "
                    f"{a.shape}")
            if a.shape[-1] > lora.MAX_RANK:
                raise ValueError(f"adapter rank {a.shape[-1]} > "
                                 f"{lora.MAX_RANK}")
            ranks.append(a.shape[-1])
            pairs.append((a, b))
        R = max(ranks) if ranks else 1
        n = len(pairs)
        A = np.zeros((L, n + 1, h, R), np.float32)
        B = np.zeros((L, n + 1, R, hd3), np.float32)
        salts = [b""]
        for i, ((a, b), r) in enumerate(zip(pairs, ranks), start=1):
            scale = (float(alpha) / r) if alpha is not None else 1.0
            A[:, i, :, :r] = a
            B[:, i, :r, :] = b * scale
            # CONTENT hash, not content sums: two structurally related
            # fine-tunes (a row permutation) can share every sum, and
            # colliding salts would alias their cache pages
            dig = hashlib.blake2b(digest_size=16)
            dig.update(np.float32(scale).tobytes())
            dig.update(a.tobytes())
            dig.update(b.tobytes())
            salts.append(dig.digest())
        self.lora = {"lora_A": torch.from_numpy(A).to(self.device),
                     "lora_B": torch.from_numpy(B).to(self.device)}
        self.n_adapters = n
        self._adapter_salts = salts
        return self

    def adapter_salt(self, aid):
        """Prefix-cache key salt of adapter `aid` (b"" for the base model,
        id 0): KV bytes written under an adapter depend on its bank, so
        chain keys fold it in or pages would alias across variants."""
        return self._adapter_salts[int(aid)]

    def cache_fingerprint(self):
        """Identity of this decoder's KV bytes, the prefix cache's root-key
        salt: architecture, page size, pool dtype, quant modes and one
        exact content probe per weight tensor — not temperature or seed,
        which the KV bytes do not depend on. A probe is the sum, modulo
        2^64, of each element's bit pattern (as an integer) times an odd
        multiplier 2i + 1 of its index i: integer arithmetic on the card,
        so the same in any order, process or device, and changed by any
        change of any one element (an odd multiplier is invertible modulo
        2^64)."""
        cfg = self.cfg

        def probe(v):
            if isinstance(v, tuple):     # int4 or int8 (payload, scale)
                return tuple(probe(x) for x in v)
            bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[v.element_size()]
            flat = v.detach().contiguous().reshape(-1).view(bits)
            total = torch.zeros((), dtype=torch.int64, device=v.device)
            step = 1 << 24                       # bounds the int64 temps
            for lo in range(0, flat.numel(), step):
                x = flat[lo:lo + step].to(torch.int64)
                m = torch.arange(lo, lo + x.numel(), dtype=torch.int64,
                                 device=v.device) * 2 + 1
                total += (x * m).sum()
            return total

        tensors = [self.weights[k] for k in sorted(self.weights)] + [
            self.wte, self.wpe, self.lm_head, self.ln_f_w, self.ln_f_b]
        sums = []
        for p in (probe(t) for t in tensors):
            sums.extend(p if isinstance(p, tuple) else (p,))
        values = torch.stack(sums).tolist()      # one sync for all probes
        digest = hashlib.blake2b(repr(values).encode(),
                                 digest_size=16).hexdigest()
        pool_leaf = self.k_pages[0] if isinstance(self.k_pages, tuple) \
            else self.k_pages
        parts = (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                 cfg.head_dim, cfg.vocab_size, cfg.max_seq_len,
                 self.page_size, str(pool_leaf.dtype), self.quant or "",
                 self.kv_quant or "", digest)
        return repr(parts).encode()

    # -- byte model --------------------------------------------------------

    @property
    def _pool_itemsize(self):
        """Bytes one stored K (or V) element costs in the pool."""
        leaf = self.k_pages[0] if isinstance(self.k_pages, tuple) \
            else self.k_pages
        return leaf.element_size()

    @property
    def kv_token_bytes(self):
        """KV bytes ONE token costs per layer (K and V together, scale
        planes included for a quantized pool)."""
        return pool_token_bytes(self.cfg, kv_quant=self.kv_quant,
                                itemsize=self._pool_itemsize)

    def kv_token_bytes_by_layer(self):
        """Per-LAYER KV bytes one token costs (every layer stores the same
        width today)."""
        return [self.kv_token_bytes] * self.cfg.num_layers

    @property
    def kv_page_bytes(self):
        """KV bytes one page holds across all layers (K and V, scale
        planes included)."""
        return int(self.cfg.num_layers * self.page_size *
                   self.kv_token_bytes)

    def step_hbm_bytes(self, avg_ctx=None, batch=None, kv_quant="pool"):
        """HBM bytes ONE decode tick moves: every weight byte (2 a
        parameter; 1 for the int8 linears under a8w8, 0.5 for the int4
        linears under w4a16) plus each slot's
        KV prefix at `avg_ctx` (default: half the model's max sequence) —
        the numerator of the decode tick roofline the scheduler prices K
        and w from. `kv_quant` prices another pool layout for a what-if
        (None prices the compute dtype's width); "pool" is the live
        pool's."""
        cfg = self.cfg
        n = cfg.num_params()
        per = {"a8w8": 1.0, "w4a16": 0.5}.get(self.quant)
        if per is not None:
            h, f = cfg.hidden_size, cfg.ffn_hidden
            lin = cfg.num_layers * (4 * h * h + 2 * h * f)
            w_bytes = lin * per + (n - lin) * 2
        else:
            w_bytes = n * 2
        if avg_ctx is None:
            avg_ctx = max(cfg.max_seq_len // 2, 1)
        if batch is None:
            batch = self.max_batch
        if kv_quant == "pool":
            return int(w_bytes +
                       batch * avg_ctx * sum(self.kv_token_bytes_by_layer()))
        # an unquantized what-if prices the compute dtype's width, not the
        # live pool's leaf (1 byte on an int8 pool)
        itemsize = self._pool_itemsize if self.kv_quant is None \
            else self.compute_dtype.itemsize
        tok_bytes = pool_token_bytes(cfg, kv_quant=kv_quant,
                                     itemsize=itemsize)
        return int(w_bytes + batch * cfg.num_layers * avg_ctx * tok_bytes)
