"""Speculative decoding in the port (`SpeculativeEngine`, the decoder's
`verify` window, `decode_multi(return_logits=True)`, `_spec_accept`)
against the JAX package on `gpt_tiny` f32, the weights of JAX `GPT`s
carried across by `state_dict_from_numpy`: verify logits, acceptance
decisions on the same generator, greedy streams with a perfect and a
weak draft, sampled streams, page reclamation on both pools, and the
engine's refusals.

Tolerances: verify logits within atol 1e-5 of JAX's (the same f32
weights; the frameworks sum matmuls in different orders, ~1e-6 relative
a layer); streams and decisions equal. A sampled acceptance decision
whose margin |u - min(1, p/q)| is within TIE_TOL is a tie: the port and
JAX may decide it differently from probabilities ~1e-6 apart, and the
test then reports the tie instead of failing.
"""
import copy
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving.engine as jax_engine_module
import paddle_tpu_torch.serving.engine as engine_module
from paddle_tpu.models import GPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import PagedGPTDecoder as JaxDecoder
from paddle_tpu.serving import SpeculativeEngine as JaxSpec
from paddle_tpu.serving import _spec_accept as jax_spec_accept
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      PagedGPTDecoder, SpeculativeEngine,
                                      _spec_accept)

TIE_TOL = 1e-4
PROMPTS = [[3, 141, 59, 26, 535], [897, 11, 4, 18, 200, 7], [31]]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this module runs (the suite
    runs in several worker processes); results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(seed):
    paddle.seed(seed)
    m = GPT(jax_gpt_tiny(max_seq_len=128, dtype="float32", remat=False))
    m.eval()
    return m


@pytest.fixture(scope="module")
def models():
    """The target (seed 7) and an unrelated weak draft (seed 123), each a
    JAX gpt_tiny with the port's tensors of its weights."""
    out = {"cfg": gpt_tiny(max_seq_len=128, dtype="float32")}
    for name, seed in (("target", 7), ("weak", 123)):
        jm = _jax_model(seed)
        out[name] = (jm, state_dict_from_numpy(
            {k: np.asarray(v._value) for k, v in jm.state_dict().items()},
            device="cpu"))
    return out


def _dec(m, which="target", max_batch=2, **kw):
    return PagedGPTDecoder(m["cfg"], m[which][1], num_pages=32,
                           page_size=16, max_batch=max_batch, device="cpu",
                           **kw)


def _jdec(m, which="target", max_batch=2, **kw):
    return JaxDecoder(m[which][0], num_pages=32, page_size=16,
                      max_batch=max_batch, **kw)


def _run(eng, prompts):
    rids = [eng.submit(np.asarray(p, np.int32)) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def test_verify_logits_equal_jax(models):
    """After the same prefill, one W = 5 verify window: the port's f32
    logits within 1e-5 of the JAX `_verify_step`'s, argmax equal, and
    `verify(return_probs=True)` the softmax of those logits."""
    prompts = [PROMPTS[1], PROMPTS[0]]
    pages = [[0, 1], [2, 3]]
    dec, jdec = _dec(models), _jdec(models)
    assert dec.prefill_batch(list(zip(prompts, pages))) == \
        jdec.prefill_batch(list(zip(prompts, pages)))
    table = np.full((2, dec.max_pages), dec.num_pages - 1, np.int32)
    for s, pg in enumerate(pages):
        table[s, :len(pg)] = pg
    lens = np.asarray([len(p) for p in prompts], np.int32)
    window = np.asarray([[7, 100, 3, 900, 12], [5, 5, 1, 2, 3]], np.int32)
    jout, jlogits, _, _ = jdec._verify_step(
        jdec._w(), jdec.k_pages, jdec.v_pages, jnp.asarray(window),
        jnp.asarray(lens), jnp.asarray(table))
    out, logits = dec._verify_step(dec._as_i32(window), dec._as_i32(lens),
                                   dec._as_i32(table))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    assert out.tolist() == np.asarray(jout).tolist()
    got, probs = dec.verify(window, lens, table, return_probs=True)
    assert got.tolist() == out.tolist()
    np.testing.assert_allclose(probs, torch.softmax(logits, -1).numpy(),
                               atol=1e-7, rtol=0)


def test_spec_accept_equal_decisions():
    """`_spec_accept` is JAX's decision for decision on the same
    generator: random p / q rows, drafts, a q of 0 and p == q rows."""
    rng = np.random.default_rng(0)
    for case in range(200):
        n, V = int(rng.integers(0, 4)), int(rng.integers(2, 9))
        p = rng.dirichlet(np.ones(V), n + 1)
        q = rng.dirichlet(np.ones(V), n)
        if case % 7 == 0 and n:
            q[0] = p[0]                        # p == q: residual empty
        drafts = rng.integers(0, V, n)
        if case % 5 == 0 and n:
            q[0, drafts[0]] = 0.0              # q of 0 rejects
        a = _spec_accept(p, q, drafts, np.random.default_rng(case))
        b = jax_spec_accept(p, q, drafts, np.random.default_rng(case))
        assert a == b, case


def test_speculative_greedy_streams(models):
    """Greedy speculation is exact: with a perfect draft (the target's
    own weights, k 4) and a weak one (k 3), the streams equal the port's
    packed ragged engine's and JAX's `SpeculativeEngine`'s, with the
    same target calls; both pools get every page back."""
    plain = _run(ContinuousBatchingEngine(_dec(models), max_new_tokens=12),
                 PROMPTS)
    for draft, k in (("target", 4), ("weak", 3)):
        eng = SpeculativeEngine(_dec(models), _dec(models, draft),
                                max_new_tokens=12, k=k)
        jeng = JaxSpec(_jdec(models), _jdec(models, draft),
                       max_new_tokens=12, k=k)
        got = _run(eng, PROMPTS)
        assert got == plain == _run(jeng, PROMPTS), draft
        assert eng.target_calls == jeng.target_calls
        assert len(eng._free) == eng.d.num_pages - 1
        assert len(eng._draft_free) == eng.draft.num_pages - 1
        if draft == "target":
            # every proposal accepted: ceil((n-1)/k) verify rounds a slot
            assert eng.target_calls <= 2 * ((12 - 1 + 3) // 4 + 1)


def _tapped(module, monkeypatch):
    """Record every acceptance call of an engine module: the drafts, the
    decision and, replayed on a copy of its generator, the margin
    |u - min(1, p/q)| of each uniform draw it made."""
    calls = []
    fn = module._spec_accept

    def tap(p_rows, q_rows, drafts, rng):
        replay = copy.deepcopy(rng)
        out = fn(p_rows, q_rows, drafts, rng)
        margins = []
        for j in range(min(out[0] + 1, len(drafts))):
            d = int(drafts[j])
            if q_rows[j, d] > 0:
                ratio = min(1.0, p_rows[j, d] / q_rows[j, d])
                margins.append(abs(replay.random() - ratio))
        calls.append((out, min(margins, default=1.0)))
        return out

    monkeypatch.setattr(module, "_spec_accept", tap)
    return calls


@pytest.mark.parametrize("seed", [3, 5])
def test_sampled_speculative_streams_equal_jax(models, monkeypatch, seed):
    """Sampled speculation (temperature 0.9, top_k 40, a weak draft
    seeded seed + 1): the port's decisions and streams equal JAX's, where
    a differing decision may only be a tie (reported); two runs are
    equal; at temperature 1e-4 the streams are the greedy ones."""
    def run(temperature, jax=False):
        kw = dict(max_batch=1, temperature=temperature, top_k=40)
        make = _jdec if jax else _dec
        eng = (JaxSpec if jax else SpeculativeEngine)(
            make(models, seed=seed, **kw),
            make(models, "weak", seed=seed + 1, **kw),
            max_new_tokens=10, k=3)
        return _run(eng, PROMPTS[:2])

    port_calls = _tapped(engine_module, monkeypatch)
    got = run(0.9)
    jax_calls = _tapped(jax_engine_module, monkeypatch)
    want = run(0.9, jax=True)
    ties = [i for i, (a, b) in enumerate(zip(port_calls, jax_calls))
            if a[0] != b[0]]
    for i in ties:
        assert port_calls[i][1] <= TIE_TOL, (i, port_calls[i], jax_calls[i])
        warnings.warn(f"seed {seed}: acceptance call {i} is a tie "
                      f"(margin {port_calls[i][1]:.2e})")
    if not ties:
        assert got == want
    assert run(0.9) == got
    greedy = _run(ContinuousBatchingEngine(_dec(models, max_batch=1),
                                           max_new_tokens=10), PROMPTS[:2])
    assert run(1e-4) == greedy


def test_draft_ticks_match_per_tick_decode(models):
    """The draft's proposal chain, `decode_multi(return_logits=True)`,
    equals k sequential `decode` ticks on a twin decoder (sampled: same
    keys), and its logits block is [k, S, V]."""
    def fresh():
        dec = _dec(models, temperature=0.7, seed=5)
        eng = ContinuousBatchingEngine(dec, max_new_tokens=40, k_max=1)
        eng.submit([3, 141, 59, 26])
        eng.submit([897, 11, 4])
        eng.step()
        return dec, eng
    dec_a, eng_a = fresh()
    dec_b, eng_b = fresh()
    table = eng_a._table(eng_a._slot_pages, dec_a)
    out = dec_a.decode_multi(eng_a._tokens, eng_a._lens, table, 4,
                             return_logits=True)
    tokens, lens = eng_b._tokens.copy(), eng_b._lens.copy()
    seq = []
    for _ in range(4):
        tokens = dec_b.decode(tokens, lens, table).numpy()
        seq.append(tokens.copy())
        lens = lens + 1
    assert out.tokens_block.numpy().tolist() == np.stack(seq).tolist()
    assert tuple(out.logits_block.shape) == (4, 2, models["cfg"].vocab_size)
    assert dec_a.decode_multi(eng_a._tokens, eng_a._lens, table,
                              1).logits_block is None


def test_refusals(models):
    """Different sampling configs, a mismatched max_batch or page_size,
    quantized pools (int8, int4), a LoRA bank and an oversized request
    are refused, as by JAX's engine."""
    def refused(target, draft, match):
        with pytest.raises(ValueError, match=match):
            SpeculativeEngine(target, draft)

    refused(_dec(models, temperature=0.9), _dec(models), "SAME sampling")
    refused(_dec(models), _dec(models, max_batch=1), "max_batch")
    refused(_dec(models), PagedGPTDecoder(
        models["cfg"], models["target"][1], num_pages=32, page_size=8,
        max_batch=2, device="cpu"), "page_size")
    for quant in ("int8", "int4"):
        refused(_dec(models, kv_quant=quant), _dec(models), "quantized")
        refused(_dec(models), _dec(models, kv_quant=quant), "quantized")
    banked = _dec(models)
    banked.lora = object()
    refused(banked, _dec(models), "LoRA")
    eng = SpeculativeEngine(_dec(models), _dec(models), max_new_tokens=100,
                            k=4)
    with pytest.raises(ValueError, match="speculation margin"):
        eng.submit(list(range(30)))
    with pytest.raises(ValueError, match="at least one token"):
        eng.submit([])
    assert eng.stats.requests == 0
