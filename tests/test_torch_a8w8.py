"""The port's int8 x int8 linear (paddle_tpu_torch.ops.a8w8_matmul) and
its a8w8 serving decoder against the JAX package.

1. `quantize_rows` gives the bytes and scales of the JAX decoder's
   activation quantize (`_mm` / `_mm_heads`: the f32 row absmax over 127,
   floored at 1e-8, a true division, round half to even) and of
   `QuantizedLinearA8W8`'s static scale, exactly: zero rows, rows that
   reach +-127, exact halves, f32 and bf16 x.
2. `a8w8_matmul` in the decoder's order, (acc * sx) * sw + b, against the
   JAX `_mm` and `_mm_heads`, and in `QuantizedLinearA8W8`'s order, acc *
   (sw * sx) + b, against the JAX layer. The int32 products are equal (both
   exact); XLA on the CPU may contract the epilogue's last multiply and add
   into one FMA, which the port (and its kernel) never does, so an f32
   element may differ by 2 ulp of max(|acc sx sw|, |b|, |y|), and a bf16
   element, cast last, by one bf16 ulp of |y| on top.
3. The a8w8 `PagedGPTDecoder` on gpt_tiny f32 with one JAX `GPT`'s weights:
   its stacked int8 weights equal the JAX decoder's, a packed prefill's
   first tokens and the next decode tick's logits agree within atol 1e-4
   (K/V and activations reach the row quantize from two frameworks' f32
   matmuls, whose last bits differ, so an int8 activation could move by one
   step near a rounding boundary; on these weights none does at 1e-4),
   and the greedy streams equal the JAX engine's on the packed ragged,
   per-tick, dense window and prefix-cached engines; the byte model prices
   a8w8 as JAX does, and the fingerprint sees the int8 pair.
4. On a card (skipped here) both kernels equal the plain versions bit for
   bit, and a row's bits do not depend on T.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import quantization as jq
from paddle_tpu.models import GPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import PagedGPTDecoder as JaxDecoder
from paddle_tpu.serving import decoder as jdec
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.ops import a8w8_matmul as a8
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      PagedGPTDecoder)


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(seed, T, K):
    """Rows with a zero row, one whose absmax is an exact multiple of 127
    (every element lands on the grid, the extremes on +-127), and exact
    halves of a step."""
    x = np.random.RandomState(seed).randn(T, K).astype(np.float32)
    if T > 2:
        x[1] = 0.0
        x[2] = np.arange(K, dtype=np.float32) % 255 - 127
        x[2, :4] = [127.0, -127.0, 0.5, -2.5]
    return x


def _jax_quantize_rows(x):
    """The JAX decoder's activation quantize (decoder.py `_mm`)."""
    sx = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1,
                 keepdims=True) / 127.0
    sx = jnp.maximum(sx, 1e-8)
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) / sx), -127,
                  127).astype(jnp.int8)
    return np.asarray(xq), np.asarray(sx)[:, 0]


def _jx(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _tx(x, dtype):
    return torch.from_numpy(np.array(x)).to(getattr(torch, dtype))


# ---------------------------------------------------- 1. the quantizer

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,K", [(16, 64), (5, 33), (1, 8)])
def test_quantize_rows_equals_jax(T, K, dtype):
    x = _rows(T * K, T, K)
    q, s = a8.quantize_rows(_tx(x, dtype))
    jqx, js = _jax_quantize_rows(_jx(x, dtype))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jqx)
    np.testing.assert_array_equal(s.numpy(), js)
    if T > 2:
        assert (q[1] == 0).all() and q[2].abs().max() == 127
    # a static scale: QuantizedLinearA8W8's quantize (quantization.py)
    act = np.float32(np.abs(x).max() / 200.0)       # saturates some
    qs, ss = a8.quantize_rows(_tx(x, dtype), torch.tensor(act))
    want = jnp.clip(jnp.round(_jx(x, dtype).astype(jnp.float32) / act),
                    -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(qs.numpy(), np.asarray(want))
    assert float(ss) == act and (qs.abs() == 127).any()


# ------------------------------------------------ 2. the int8 product

def _ulp32(v):
    v = np.maximum(np.abs(v), np.float32(2.0 ** -126)).astype(np.float32)
    return np.spacing(v).astype(np.float32)


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _check_epilogue(got, want, prod, b, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    mag = np.maximum(np.maximum(np.abs(prod), np.abs(b)), np.abs(want))
    tol = 2 * _ulp32(mag)
    if dtype == "bfloat16":
        tol = tol + _bf16_ulp(want)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _weights(seed, K, N, bias_dtype="float32"):
    rng = np.random.RandomState(seed)
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    b = rng.randn(N).astype(np.float32)
    if bias_dtype == "bfloat16":
        b = np.asarray(jnp.asarray(b).astype(jnp.bfloat16).astype(
            jnp.float32))
    qw, sw = jq.quantize_weight(jnp.asarray(w), axis=0)
    return np.asarray(qw), np.asarray(sw), b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,K,N", [(16, 64, 96), (3, 33, 50), (40, 128, 8)])
def test_decoder_order_matches_jax_mm(S, K, N, dtype):
    """`_mm` (bias in its stored dtype: f32, or bf16 as the bf16
    decoder stores it) and `_mm_heads` ([h, 3, H, D] head-major)."""
    x = _rows(S + K, S, K)
    for bias_dtype in ("float32", "bfloat16"):
        qw, sw, b = _weights(K * N, K, N, bias_dtype)
        jb = _jx(b, bias_dtype)
        want = jdec._mm(_jx(x, dtype), (jnp.asarray(qw), jnp.asarray(sw[0])),
                        jb, "a8w8")
        got = a8.a8w8_linear(_tx(x, dtype), _tx(qw.T, "int8"),
                             _tx(sw[0], "float32"), _tx(b, bias_dtype),
                             a8.DECODER)
        assert got.dtype == getattr(torch, dtype)
        xq, sx = _jax_quantize_rows(_jx(x, dtype))
        prod = (xq.astype(np.int64) @ qw.astype(np.int64)).astype(
            np.float32) * sx[:, None] * sw
        _check_epilogue(got, want, prod, b, dtype)
    if N % 6 == 0:                   # qkv: [h, 3, H, D] with H*D = N / 3
        H = 2
        D = N // 3 // H
        qh = jnp.asarray(qw).reshape(K, 3, H, D)
        want = jdec._mm_heads(_jx(x, dtype), (qh, jnp.asarray(sw).reshape(
            3, H, D)), jnp.asarray(b).reshape(3, H, D), "a8w8")
        got = a8.a8w8_linear(_tx(x, dtype), _tx(qw.T, "int8"),
                             _tx(sw[0], "float32"), _tx(b, "float32"),
                             a8.DECODER)
        _check_epilogue(got, np.asarray(want).reshape(S, N), prod, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_ptq_order_matches_jax_quantized_linear_a8w8(dtype, bias):
    """The second epilogue order on a static scale, leading dims kept,
    against the JAX layer on the same Linear weights."""
    paddle.seed(3)
    lin = paddle.nn.Linear(48, 40, bias_attr=None if bias else False)
    if dtype == "bfloat16":
        lin.to(dtype="bfloat16")
    x = np.random.RandomState(3).randn(2, 5, 48).astype(np.float32)
    act = float(np.abs(x).max() / 127.0)
    want = jq.QuantizedLinearA8W8(lin, act)(
        paddle.to_tensor(x).astype(dtype))
    w = np.asarray(lin.weight._value.astype(jnp.float32))
    qw, sw = jq.quantize_weight(jnp.asarray(w), axis=0)
    b = None if not bias else _tx(np.asarray(lin.bias._value.astype(
        jnp.float32)), dtype)
    got = a8.a8w8_linear(_tx(x, dtype), _tx(np.asarray(qw).T, "int8"),
                         _tx(np.asarray(sw)[0], "float32"), b, a8.PTQ,
                         sx=torch.tensor(act))
    assert got.shape == (2, 5, 40) and got.dtype == getattr(torch, dtype)
    bb = np.zeros(40, np.float32) if b is None else b.float().numpy()
    _check_epilogue(got.reshape(10, 40), np.asarray(
        want._value).reshape(10, 40), np.zeros((10, 40), np.float32), bb,
        dtype)


def test_plain_product_is_exact_and_row_local():
    """The float64 product equals an int64 one at the largest magnitudes,
    and a row's output is the same alone and inside a longer call."""
    rng = np.random.RandomState(0)
    xq = torch.from_numpy(rng.choice([-127, 127], (20, 4096)).astype(np.int8))
    wt = torch.from_numpy(rng.choice([-127, 127], (24, 4096)).astype(np.int8))
    acc = a8.a8w8_matmul(xq, torch.ones(20), wt, torch.ones(24))
    exact = (xq.long() @ wt.long().t()).float()
    assert torch.equal(acc, exact)
    sx, sw = torch.rand(20) + 0.5, torch.rand(24) + 0.5
    for order in (a8.DECODER, a8.PTQ):
        b = torch.randn(24)
        full = a8.a8w8_matmul(xq, sx, wt, sw, b, order)
        for rows in (slice(0, 1), slice(3, 17)):
            part = a8.a8w8_matmul(xq[rows], sx[rows], wt, sw, b, order)
            assert torch.equal(part, full[rows])


@pytest.mark.parametrize("bad,err", [
    ("x_dtype", TypeError), ("w_dtype", TypeError), ("shape", ValueError),
    ("sx", ValueError), ("bias", ValueError), ("noncontig", ValueError)])
def test_kernel_operand_checks(bad, err):
    """The CUDA wrappers refuse operands the kernels do not take before
    any launch (here with CPU tensors, so nothing is built)."""
    xq = torch.zeros((4, 32), dtype=torch.int8)
    wt = torch.zeros((8, 32), dtype=torch.int8)
    sx, sw, b = torch.ones(4), torch.ones(8), torch.zeros(8)
    if bad == "x_dtype":
        with pytest.raises(err):
            a8._launch_quantize(torch.zeros((4, 32), dtype=torch.float64),
                                None)
        return
    kw = {"xq": xq, "sx": sx, "wt": wt, "sw": sw, "b": b}
    if bad == "w_dtype":
        kw["wt"] = wt.float()
    elif bad == "shape":
        kw["wt"] = torch.zeros((8, 31), dtype=torch.int8)
    elif bad == "sx":
        kw["sx"] = torch.ones(3)
    elif bad == "bias":
        kw["b"] = torch.zeros(7)
    else:
        kw["wt"] = torch.zeros((32, 8), dtype=torch.int8).t()
    with pytest.raises(err):
        a8._launch_gemm(kw["xq"], kw["sx"], kw["wt"], kw["sw"], kw["b"],
                        a8.DECODER, torch.float32)


# -------------------------------------------------------- 3. the decoder

PROMPTS = [[3, 141, 59], [897, 11, 4, 18, 200, 7], [31],
           list(range(100, 140)), [5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9]]
# a shared 32-token prefix (two pages) for the cached engine
SHARED = list(range(200, 232))
CACHED = [SHARED + [7, 8, 9], SHARED + [11], SHARED + [12, 13]]
MAX_NEW = 6


@pytest.fixture(scope="module")
def models():
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
    kw = {"num_pages": 32, "page_size": 16, "max_batch": 2,
          "quant": "a8w8", **kw}
    return PagedGPTDecoder(m["cfg"], m["sd"], device="cpu", **kw)


def _jax_decoder(m, **kw):
    return JaxDecoder(m["jmodel"], num_pages=32, page_size=16, max_batch=2,
                      quant="a8w8", **kw)


def _streams(eng, prompts):
    rids = [eng.submit(p) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def _jax_streams(m, prompts, **kw):
    jeng = JaxEngine(_jax_decoder(m), max_new_tokens=MAX_NEW, k_max=1,
                     **kw)
    rids = [jeng.submit(np.asarray(p, np.int32)) for p in prompts]
    out = jeng.run()
    return [out[r] for r in rids]


def test_decoder_matches_jax_decoder(models):
    """Weights byte-equal to the JAX decoder's (stored [L, out, in]);
    prefill first tokens equal; one decode tick's logits within 1e-4."""
    jd = _jax_decoder(models)
    dec = _decoder(models)
    for key in ("qkv_w", "proj_w", "fc1_w", "fc2_w"):
        jqw, jsw = (np.asarray(v) for v in jd.weights[key])
        L = jqw.shape[0]
        tq, ts = dec.weights[key]
        np.testing.assert_array_equal(
            tq.transpose(1, 2).numpy(), jqw.reshape(L, jqw.shape[1], -1))
        np.testing.assert_array_equal(ts.numpy(), jsw.reshape(L, -1))
    prompts = [PROMPTS[1], PROMPTS[3]]
    pages = [[0, 1], [2, 3, 4]]
    jfirst = jd.prefill_batch(list(zip(prompts, pages)))
    table = np.full((2, jd.max_pages), jd.num_pages - 1, np.int32)
    for s, pg in enumerate(pages):
        table[s, :len(pg)] = pg
    lens = np.asarray([len(p) for p in prompts], np.int32)
    _, jlogits, jd.k_pages, jd.v_pages = jd._decode(
        jd._w(), jd.k_pages, jd.v_pages, jnp.asarray(jfirst, jnp.int32),
        jnp.asarray(lens), jnp.asarray(table),
        jnp.asarray(np.arange(2, dtype=np.int32)))
    first = dec.prefill_batch(list(zip(prompts, pages)))
    nxt, logits = dec._decode_step(dec._as_i32(first), dec._as_i32(lens),
                                   dec._as_i32(table))
    assert first == jfirst
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    assert nxt.tolist() == np.asarray(jlogits).argmax(-1).tolist()


@pytest.mark.parametrize("engine", [
    {}, {"k_max": 1}, {"k_max": 4, "chunk_tokens": 8},
    {"dense": True, "k_max": 4, "chunk_tokens": 8}],
    ids=["packed", "per_tick", "chunked", "dense"])
def test_streams_equal_jax_engine(models, engine):
    """Greedy streams equal the JAX per-tick engine's under a8w8 on the
    packed ragged, per-tick and dense-window layouts."""
    engine = dict(engine)
    dec = _decoder(models, packed=not engine.pop("dense", False))
    eng = ContinuousBatchingEngine(dec, max_new_tokens=MAX_NEW, **engine)
    assert _streams(eng, PROMPTS) == _jax_streams(models, PROMPTS)
    assert len(eng._free) == dec.num_pages - 1          # every page back


def test_cached_streams_equal_jax_engine(models):
    """Prefix-cached admission (the shared two pages mounted, only the
    suffix prefilled) serves the JAX engine's streams, with hits."""
    eng = ContinuousBatchingEngine(_decoder(models), max_new_tokens=MAX_NEW,
                                   prefix_cache=True)
    got = _streams(eng, CACHED[:1]) + _streams(eng, CACHED[1:])
    assert eng.stats.prefix_hits > 0
    assert got == _jax_streams(models, CACHED)


def test_a8w8_quantized_decode_runs(models):
    """The JAX package's `test_a8w8_quantized_decode_runs` on the port,
    with the JAX engine's tokens."""
    dec = _decoder(models, max_batch=1)
    eng = ContinuousBatchingEngine(dec, max_new_tokens=4)
    rid = eng.submit(np.asarray([3, 141, 59], np.int32))
    toks = eng.run()[rid]
    assert len(toks) == 4
    assert all(0 <= t < models["cfg"].vocab_size for t in toks)
    jeng = JaxEngine(JaxDecoder(models["jmodel"], num_pages=32,
                                page_size=16, max_batch=1, quant="a8w8"),
                     max_new_tokens=4)
    jrid = jeng.submit(np.asarray([3, 141, 59], np.int32))
    assert toks == jeng.run()[jrid]


def test_byte_model_and_fingerprint(models):
    """step_hbm_bytes prices the int8 linears at a byte a parameter as
    the JAX decoder does; the fingerprint changes with any int8 weight
    byte and any scale, and with the quant mode."""
    jd = _jax_decoder(models)
    dec = _decoder(models)
    for what_if in ("pool", None, "int8", "int4"):
        assert dec.step_hbm_bytes(avg_ctx=64, kv_quant=what_if) == \
            jd.step_hbm_bytes(avg_ctx=64, kv_quant=what_if)
    assert dec.step_hbm_bytes(avg_ctx=64) < \
        _decoder(models, quant=None).step_hbm_bytes(avg_ctx=64)
    base = dec.cache_fingerprint()
    assert base != _decoder(models, quant=None).cache_fingerprint()
    q, s = dec.weights["fc1_w"]
    q[1, 2, 3] += 1
    assert dec.cache_fingerprint() != base
    q[1, 2, 3] -= 1
    assert dec.cache_fingerprint() == base
    s[0, 5] *= 2
    assert dec.cache_fingerprint() != base


# ------------------------------------------------------ 4. on a card

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_kernels_equal_plain(cuda, dtype):
    gen = torch.Generator(device="cpu").manual_seed(0)
    for T, K, N in ((16, 2048, 6144), (1, 64, 33), (300, 96, 130),
                    (17, 40, 24)):
        x = torch.randn((T, K), generator=gen).to(cuda, dtype)
        x[0] = 0
        wt = torch.randint(-127, 128, (N, K), generator=gen,
                           dtype=torch.int8).to(cuda)
        sw = (torch.rand(N, generator=gen) * 1e-3).to(cuda)
        b = torch.randn(N, generator=gen).to(cuda, dtype)
        xq, sx = a8.quantize_rows(x)
        pq, psx = a8._quantize_rows_ref(x)
        assert torch.equal(xq, pq) and torch.equal(sx, psx)
        for order in (a8.DECODER, a8.PTQ):
            got = a8.a8w8_matmul(xq, sx, wt, sw, b, order, dtype)
            want = a8._a8w8_ref(xq, sx, wt, sw, b, order, dtype)
            assert torch.equal(got, want)
            first = a8.a8w8_matmul(xq[:1].contiguous(), sx[:1].contiguous(),
                                   wt, sw, b, order, dtype)
            assert torch.equal(first, got[:1])


def test_cuda_quantizers_divide_as_on_the_cpu(cuda):
    """On the card the plain quantizers divide as the CPU (and JAX) do:
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, one ulp off for some amax, which moved scales and bytes of
    `quantize_weight`, the KV quantizers and the row quantize's plain
    version before `device.div_const`."""
    from paddle_tpu_torch.ops import w4_matmul as w4
    from paddle_tpu_torch.quantization import quantize_weight
    from paddle_tpu_torch.serving import decoder as tdec
    gen = torch.Generator(device="cpu").manual_seed(0)
    w = torch.randn((2048, 2048), generator=gen) * 0.02
    for bits in (8, 4):
        for a, b in zip(quantize_weight(w, bits=bits),
                        quantize_weight(w.to(cuda), bits=bits)):
            assert torch.equal(a, b.cpu())
    for a, b in zip(w4.quantize_w4(w), w4.quantize_w4(w.to(cuda))):
        assert torch.equal(a, b.cpu())
    kv = torch.randn((64, 16, 128), generator=gen)
    for fn in (tdec._quantize_kv, tdec._quantize_kv_int4):
        for a, b in zip(fn(kv), fn(kv.to(cuda))):
            assert torch.equal(a, b.cpu())
    for a, b in zip(a8._quantize_rows_ref(w), a8._quantize_rows_ref(
            w.to(cuda))):
        assert torch.equal(a, b.cpu())
