"""The port's quantized serving (paddle_tpu_torch: int8 and int4 KV pools,
int4 W4A16 weights) against the JAX package, compared in this order:

1. the KV quantizers and the nibble packing on IDENTICAL inputs: bytes
   and scales exactly equal;
2. the ragged attention's plain version on IDENTICAL quantized pools
   against the JAX `_ragged_ref` and the Pallas kernel in interpret mode:
   f32 within atol 1e-5 (both accumulate in f32; only summation order
   differs), over tables with scratch and -1 entries, int4 groups that
   cross head boundaries, a ragged tail group and a single odd group;
   and inside the port bit-identical across W=1, a W=16 window and a
   shuffled packed stream;
3. the decoder on gpt_tiny f32 with the weights of one JAX `GPT`: the
   pools hold the same bytes as the JAX decoder's after a packed prefill
   and a decode tick, and the decode logits agree within atol 1e-4.
   K/V reach the quantizers from two frameworks' matmuls, which differ by
   f32 ulps, so a stored byte may flip by one step near a rounding
   boundary (an int8 step is amax/127 of the token, an int4 step amax/7 of
   the group) and move the logits by a fraction of that step. On these
   weights and prompts no byte flips — the test checks the payloads first,
   so a flip shows as such — and the f32 tolerance of
   `test_torch_serving.py` stands;
4. greedy streams equal to the JAX engine's, and inside the port the
   ragged packed engine equals the per-tick engine token for token.

Plus the perplexity gate of the JAX package's `tests/test_kv_quant.py`: an
int8 or int4 pool moves the mean teacher-forced NLL of a 257-token greedy
stream by at most 0.05 nats, and the byte model (`pool_token_bytes`,
`kv_token_bytes`, `step_hbm_bytes`) prices what the JAX decoder prices.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import GPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops import ragged_paged_attention as jrpa
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import PagedGPTDecoder as JaxDecoder
from paddle_tpu.serving import decoder as jdec
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      PagedGPTDecoder)
from paddle_tpu_torch.serving import decoder as tdec


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this module runs: the suite
    runs in several worker processes beside XLA's thread pools, and
    PyTorch's default of a thread per core then oversubscribes the CPU
    many times over. Results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROMPTS = [[3, 141, 59], [897, 11, 4, 18, 200, 7], [31],
           list(range(100, 140)), [5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9]]
MAX_NEW = 6
MODES = [{"kv_quant": "int8"}, {"kv_quant": "int4"}, {"quant": "w4a16"}]
MODE_IDS = ["int8", "int4", "w4a16"]


# ------------------------------------------------ 1. quantizers, exact

# [..., H, D] shapes: whole groups; H*D = 48, a ragged tail group; H*D = 7,
# one odd group (G = 1) and a spare nibble
KV_SHAPES = [(5, 4, 32), (4, 3, 16), (2, 1, 7)]


def _kv(seed, shape):
    v = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3
    v[0] = 0.0                     # an all-zero token takes the 1e-8 floor
    return v


@pytest.mark.parametrize("shape", KV_SHAPES)
def test_kv_quantizers_equal_jax(shape):
    v = _kv(sum(shape), shape)
    for jq, tq in ((jdec._quantize_kv, tdec._quantize_kv),
                   (jdec._quantize_kv_int4, tdec._quantize_kv_int4)):
        jp, js = jq(jnp.asarray(v))
        tp, ts = tq(torch.from_numpy(v))
        assert tp.dtype == (torch.int8 if jq is jdec._quantize_kv
                            else torch.uint8) and ts.dtype == torch.float32
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    packed, scales = tdec._quantize_kv_int4(torch.from_numpy(v))
    np.testing.assert_array_equal(
        tdec._unpack_int4(packed).numpy(),
        np.asarray(jdec._unpack_int4(jnp.asarray(packed.numpy()))))
    want = jdec._dequantize_kv_int4(jnp.asarray(packed.numpy()),
                                    jnp.asarray(scales.numpy()), shape[1:])
    got = tdec._dequantize_kv_int4(packed, scales, shape[1:])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_int4_equals_jax():
    q = np.random.RandomState(3).randint(-8, 8, (6, 10)).astype(np.int8)
    np.testing.assert_array_equal(
        tdec._pack_int4(torch.from_numpy(q)).numpy(),
        np.asarray(jdec._pack_int4(jnp.asarray(q))))


# ------------------------------------- 2. ragged attention over quantized

P, PS, MP = 12, 4, 5


def _pools(seed, mode, H, D):
    """The same quantized K/V pools for both packages: random f32 values
    quantized by the JAX quantizer, handed over as numpy bytes."""
    rng = np.random.RandomState(seed)
    quantize = jdec._quantize_kv_int4 if mode == "int4" \
        else jdec._quantize_kv
    out = []
    for _ in range(2):
        pages, scales = quantize(jnp.asarray(
            rng.randn(P, PS, H, D).astype(np.float32)))
        out.append(((pages, scales),
                    (torch.from_numpy(np.array(pages)),
                     torch.from_numpy(np.array(scales)))))
    return out


def _table(rng, n):
    table = rng.randint(0, P - 1, (n, MP)).astype(np.int32)
    table[0, -1] = P - 1                    # unused tail -> scratch
    table[-1, -2:] = -1                     # -1 entries clamp to page 0
    return table


# (mode, H, D, W): int8 decode rows and a 3-wide chunk; int4 with a group
# spanning two heads (D 16 < 32); int4 with 3 heads x 16 (a ragged tail
# group); int4 with H*D = 7 (G = 1)
POOL_CASES = [("int8", 2, 16, 1), ("int8", 2, 16, 3), ("int4", 2, 16, 1),
              ("int4", 3, 16, 3), ("int4", 1, 7, 1)]


@pytest.mark.parametrize("mode,H,D,W", POOL_CASES)
def test_plain_matches_jax_over_quantized_pools(mode, H, D, W):
    (jk, tk), (jv, tv) = _pools(W + H + D, mode, H, D)
    rng = np.random.RandomState(W)
    n = 3
    q = rng.randn(n, W, H, D).astype(np.float32)
    table = _table(rng, n)
    start = rng.randint(0, MP * PS - W, n).astype(np.int32)
    start[0] = 0
    before = rpa.plain_launches
    got = rpa.ragged_paged_attention(torch.from_numpy(q), tk, tv,
                                     torch.from_numpy(table),
                                     torch.from_numpy(start))
    assert rpa.plain_launches == before + 1
    args = (jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(start))
    for use_kernel in (False, True):
        want = jrpa.ragged_paged_attention(*args, use_kernel=use_kernel,
                                           interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
    # packed: one row's 3-token chunk, two decode tokens, a row id past
    # the table (clamped into it, as the JAX gather clamps)
    qt = rng.randn(5, H, D).astype(np.float32)
    rows = np.asarray([1, 1, 1, 0, 7], np.int32)
    pos = np.asarray([5, 6, 7, 0, 13], np.int32)
    got = rpa.ragged_paged_attention_packed(
        torch.from_numpy(qt), tk, tv, torch.from_numpy(table),
        torch.from_numpy(rows), torch.from_numpy(pos))
    want = jrpa.ragged_paged_attention_packed(
        jnp.asarray(qt), jk, jv, jnp.asarray(table),
        jnp.asarray(np.minimum(rows, n - 1)), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_plain_bit_identical_across_windows_and_packing(mode):
    """Inside the port, a query's output is the same bits alone (W=1),
    inside a W=16 window and inside a shuffled packed stream."""
    H, D, n, W = 2, 16, 3, 16
    (_, tk), (_, tv) = _pools(5, mode, H, D)
    rng = np.random.RandomState(6)
    q = torch.from_numpy(rng.randn(n, W, H, D).astype(np.float32))
    table = torch.from_numpy(_table(rng, n))
    start = torch.tensor([0, 2, 3], dtype=torch.int32)
    got = rpa.ragged_paged_attention(q, tk, tv, table, start)
    alone = torch.cat([rpa.ragged_paged_attention(
        q[:, j:j + 1].contiguous(), tk, tv, table, start + j)
        for j in range(W)], dim=1)
    rows = torch.arange(n).repeat_interleave(W).int()
    pos = (start[:, None] + torch.arange(W)).reshape(-1).int()
    perm = torch.from_numpy(rng.permutation(n * W))
    packed = rpa.ragged_paged_attention_packed(
        q.reshape(n * W, H, D)[perm], tk, tv, table, rows[perm], pos[perm])
    unperm = torch.empty_like(packed)
    unperm[perm] = packed
    assert torch.equal(alone, got)
    assert torch.equal(unperm.reshape(n, W, H, D), got)


@pytest.mark.parametrize("bad,err", [
    ("mixed", TypeError),           # a quantized K pool with a plain V pool
    ("scale_dtype", TypeError),     # bf16 scales
    ("payload", TypeError),         # int16 payload
    ("groups", ValueError),         # int4 scales of the wrong group count
])
def test_kernel_operand_checks_quantized(bad, err):
    """The CUDA wrapper checks quantized pools before any launch."""
    H, D = 2, 32
    q = torch.zeros(3, 1, H, D)
    table = torch.zeros(3, MP, dtype=torch.int32)
    start = torch.zeros(3, dtype=torch.int32)
    if bad == "groups":
        pool = (torch.zeros(P, PS, H * D // 2, dtype=torch.uint8),
                torch.zeros(P, PS, 3))
    else:
        pages = torch.zeros(P, PS, H, D, dtype=torch.int16
                            if bad == "payload" else torch.int8)
        pool = (pages, torch.zeros(P, PS, dtype=torch.bfloat16
                                   if bad == "scale_dtype" else
                                   torch.float32))
    vpool = torch.zeros(P, PS, H, D) if bad == "mixed" else pool
    with pytest.raises(err):
        rpa._launch(q, pool, vpool, table, None, start, 0.1)


# ---------------------------------------------------- 3-4. the decoder

@pytest.fixture(scope="module")
def models():
    """One JAX gpt_tiny, its numpy state dict carried into the port, and
    the JAX per-tick engine's greedy streams for each quantized mode."""
    paddle.seed(7)
    jcfg = jax_gpt_tiny(max_seq_len=128, dtype="float32", remat=False)
    jmodel = GPT(jcfg)
    jmodel.eval()
    np_state = {k: np.asarray(v._value)
                for k, v in jmodel.state_dict().items()}
    return {"jmodel": jmodel,
            "cfg": gpt_tiny(max_seq_len=128, dtype="float32"),
            "sd": state_dict_from_numpy(np_state, device="cpu")}


def _decoder(m, **kw):
    kw = {"num_pages": 32, "page_size": 16, "max_batch": 2, **kw}
    return PagedGPTDecoder(m["cfg"], m["sd"], device="cpu", **kw)


def _streams(eng):
    rids = [eng.submit(p) for p in PROMPTS]
    out = eng.run()
    return [out[r] for r in rids]


def _leaves(pool):
    return pool if isinstance(pool, tuple) else (pool,)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_decoder_matches_jax_decoder(models, mode):
    """Packed prefill then one decode tick: first tokens equal, pool
    payloads byte-equal and scales within f32 rounding, logits within
    1e-4 (module docstring); the JAX engine's greedy streams equal."""
    prompts = [PROMPTS[1], PROMPTS[3]]
    pages = [[0, 1], [2, 3, 4]]
    jd = JaxDecoder(models["jmodel"], num_pages=32, page_size=16,
                    max_batch=2, **mode)
    jfirst = jd.prefill_batch(list(zip(prompts, pages)))
    table = np.full((2, jd.max_pages), jd.num_pages - 1, np.int32)
    for s, pg in enumerate(pages):
        table[s, :len(pg)] = pg
    lens = np.asarray([len(p) for p in prompts], np.int32)
    _, jlogits, jd.k_pages, jd.v_pages = jd._decode(
        jd._w(), jd.k_pages, jd.v_pages, jnp.asarray(jfirst, jnp.int32),
        jnp.asarray(lens), jnp.asarray(table),
        jnp.asarray(np.arange(2, dtype=np.int32)))
    dec = _decoder(models, **mode)
    first = dec.prefill_batch(list(zip(prompts, pages)))
    nxt, logits = dec._decode_step(dec._as_i32(first), dec._as_i32(lens),
                                   dec._as_i32(table))
    assert first == jfirst
    for jpool, tpool in ((jd.k_pages, dec.k_pages),
                         (jd.v_pages, dec.v_pages)):
        (jp, *js), (tp, *ts) = _leaves(jpool), _leaves(tpool)
        if "kv_quant" in mode:
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
            np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]),
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                       atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    assert nxt.tolist() == np.asarray(jlogits).argmax(-1).tolist()

    jeng = JaxEngine(JaxDecoder(models["jmodel"], num_pages=32,
                                page_size=16, max_batch=2, **mode),
                     max_new_tokens=MAX_NEW, k_max=1)
    rids = [jeng.submit(np.asarray(p, np.int32)) for p in PROMPTS]
    jout = jeng.run()
    eng = ContinuousBatchingEngine(_decoder(models, **mode),
                                   max_new_tokens=MAX_NEW)
    assert eng.ragged and eng.k_max > 1
    assert _streams(eng) == [jout[r] for r in rids]
    assert len(eng._free) == eng.d.num_pages - 1        # every page back


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_ragged_engine_equals_per_tick_engine(models, mode):
    """Inside the port: the ragged packed engine with 8-token prompt
    chunks and an EOS that freezes a slot mid-horizon equals the per-tick
    engine token for token over the quantized pool / weights."""
    free = ContinuousBatchingEngine(_decoder(models, **mode),
                                    max_new_tokens=MAX_NEW, k_max=1)
    eos = _streams(free)[3][2]
    per_tick = ContinuousBatchingEngine(_decoder(models, **mode),
                                        eos_token_id=eos,
                                        max_new_tokens=MAX_NEW, k_max=1)
    ragged = ContinuousBatchingEngine(_decoder(models, **mode),
                                      eos_token_id=eos,
                                      max_new_tokens=MAX_NEW, k_max=4,
                                      chunk_tokens=8)
    want = _streams(per_tick)
    assert any(s[-1] == eos and len(s) < MAX_NEW for s in want)
    assert _streams(ragged) == want
    assert ragged.stats.prefill_chunks > len(PROMPTS)   # multi-chunk


def _mean_nll(dec, prompt, stream):
    """Mean NLL of the 256 transitions stream[j] -> stream[j+1],
    teacher-forced: prompt + stream run as one packed forward (each token
    attends causally over the K/V written so far), so every position's
    logits come from one pass."""
    ids = list(prompt) + list(stream[:-1])
    n, ps = len(ids), dec.page_size
    table = torch.full((1, dec.max_pages), dec.num_pages - 1,
                       dtype=torch.int32)
    table[0, :(n + ps - 1) // ps] = torch.arange((n + ps - 1) // ps)
    pos = torch.arange(n, dtype=torch.int32)
    rows = torch.zeros(n, dtype=torch.int32)
    pids = table[0, pos.long() // ps]
    x = dec._embed(torch.tensor(ids, dtype=torch.int32), pos)

    def attend(q, kp, vp):
        return rpa.ragged_paged_attention_packed(q, kp, vp, table, rows, pos)

    for layer in range(dec.cfg.num_layers):
        x = dec._layer(layer, x, pids, pos % ps, attend)
    logits = dec._logits(x[len(prompt):])
    targets = torch.tensor(stream[1:], dtype=torch.long)
    nll = -torch.log_softmax(logits, -1)[torch.arange(len(targets)),
                                         targets]
    return float(nll.mean())


def test_quantized_pool_perplexity_delta_bounded(models):
    """The JAX package's accuracy gate for quantized pools on the port:
    greedy-decode 257 tokens with the unquantized engine, teacher-force
    the same stream through an int8-pool and an int4-pool decoder; each
    moves the mean NLL by at most 0.05 nats. (The JAX package sets no
    such bound for int4 weights; `test_decoder_matches_jax_decoder` holds
    the w4a16 decoder to the JAX one.)"""
    paddle.seed(7)
    jmodel = GPT(jax_gpt_tiny(max_seq_len=320, dtype="float32",
                              remat=False))
    sd = state_dict_from_numpy({k: np.asarray(v._value) for k, v in
                                jmodel.state_dict().items()}, device="cpu")
    cfg = gpt_tiny(max_seq_len=320, dtype="float32")
    prompt = [3, 141, 59, 26, 535]

    def decoder(**kw):
        return PagedGPTDecoder(cfg, sd, num_pages=24, page_size=16,
                               max_batch=1, device="cpu", **kw)

    eng = ContinuousBatchingEngine(decoder(), max_new_tokens=257, k_max=8)
    rid = eng.submit(prompt)
    stream = eng.run()[rid]
    assert len(stream) == 257
    base = _mean_nll(decoder(), prompt, stream)
    for mode in MODES[:2]:
        delta = abs(_mean_nll(decoder(**mode), prompt, stream) - base)
        assert delta <= 0.05, (mode, delta)


@pytest.mark.parametrize("mode", [{}] + MODES, ids=["plain"] + MODE_IDS)
def test_byte_model_equals_jax(models, mode):
    """kv_token_bytes, kv_page_bytes, step_hbm_bytes (the live pool and
    each what-if layout) equal the JAX decoder's; an unknown layout
    raises in both."""
    jd = JaxDecoder(models["jmodel"], num_pages=16, page_size=16,
                    max_batch=2, **mode)
    dec = _decoder(models, num_pages=16, **mode)
    assert dec.kv_token_bytes == jd.kv_token_bytes
    assert dec.kv_page_bytes == jd.kv_page_bytes
    for what_if in ("pool", None, "int8", "int4"):
        assert dec.step_hbm_bytes(avg_ctx=64, kv_quant=what_if) == \
            jd.step_hbm_bytes(avg_ctx=64, kv_quant=what_if)
    eng = ContinuousBatchingEngine(dec, max_new_tokens=4)
    assert eng.stats.kv_bytes_per_token == \
        dec.cfg.num_layers * dec.kv_token_bytes
    for quant in (None, "int8", "int4"):
        assert tdec.pool_token_bytes(dec.cfg, kv_quant=quant) == \
            jdec.pool_token_bytes(dec.cfg, kv_quant=quant)
    with pytest.raises(ValueError, match="kv_quant"):
        tdec.pool_token_bytes(dec.cfg, kv_quant="bf16")
    with pytest.raises(ValueError, match="kv_quant"):
        dec.step_hbm_bytes(avg_ctx=64, kv_quant="bf16")
