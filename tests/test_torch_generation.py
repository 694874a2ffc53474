"""KV-cache generation in the port (`GPT.init_cache` / `forward(ids,
cache, pos)`, `models.generation`: greedy, top-k / top-p sampling, beam
search) against the JAX package's `GPT` and `models.generation` — the
cases of the JAX `test_generation.py` and `test_beam_search.py`, held
against the JAX functions on the same weights. f32, CPU.

Tolerances, each with its reason:
  * cached against full forward: 1e-4 (the JAX test's; the cached path
    is plain f32 attention over the buffer, the full one the flash
    kernel's plain version: the same math summed in other orders), and
    against the JAX cached logits 1e-4.
  * tokens (greedy, sampled, beam): equal. The draw is the port's
    threefry, bit-equal to jax.random; the logits agree to ~1e-6, far
    from the gaps between the winning scores here.
  * beam scores: 1e-5 against JAX (sums of f32 log-softmax terms).
  * `mask_logits`: equal, except rows whose cumulative top-p sum lands
    within f32 rounding of top_p, where XLA (f32, its own summation
    order) and the port (float64) may keep a boundary entry more or
    less. On these inputs that happens only with top-p alone over the
    50304-token vocabulary: 4 of 256 rows at top_p 0.95 and 18 of 256
    at 0.99, one entry each (none with top_k 50 first, none at
    V 1024 or 128). The test allows at most 1 row in 10 and checks that
    each such row differs in one entry, whose JAX cumulative sum lies
    within 2e-5 of top_p.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
from paddle_tpu.models import GPT as JaxGPT
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.models import (GPT, GPTConfig, gpt_tiny,
                                     state_dict_from_numpy)
from paddle_tpu_torch.models import generation as gen

SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=64, dtype="float32", remat=False)


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


def _pair(jcfg, cfg, seed):
    paddle.seed(seed)
    jm = JaxGPT(jcfg)
    jm.eval()
    m = GPT(cfg, device="cpu")
    m.load_state_dict(state_dict_from_numpy(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()},
        device="cpu"))
    m.eval()
    return jm, m


@pytest.fixture(scope="module")
def small():
    return _pair(JaxGPTConfig(**SMALL), GPTConfig(**SMALL), 0)


@pytest.fixture(scope="module")
def tiny():
    """The JAX beam-search tests' model: gpt_tiny, 96 positions, f32."""
    kw = dict(max_seq_len=96, dtype="float32", remat=False)
    return _pair(jax_gpt_tiny(**kw), gpt_tiny(**kw), 11)


def test_cached_forward_matches_full(small):
    jm, m = small
    ids = np.random.RandomState(0).randint(0, 128, (2, 10))
    with torch.no_grad():
        full = m(torch.from_numpy(ids))
        cache = m.init_cache(2, 16)
        assert cache[0][0].shape == (2, 16, 4, 16)
        cached, cache = m(torch.from_numpy(ids), cache=cache, pos=0)
        np.testing.assert_allclose(cached.numpy(), full.numpy(), atol=1e-4,
                                   rtol=0)
        jcache = jm.init_cache(2, 16)
        jcached, jcache = jm(paddle.to_tensor(ids.astype("int32")),
                             cache=jcache, pos=0)
        np.testing.assert_allclose(cached.numpy(), jcached.numpy(),
                                   atol=1e-4, rtol=0)
        # one incremental step == the full forward on the extended ids
        nxt = np.array([[5], [7]])
        ext = m(torch.from_numpy(np.concatenate([ids, nxt], 1)))
        step, _ = m(torch.from_numpy(nxt), cache=cache, pos=10)
    np.testing.assert_allclose(step.numpy()[:, 0], ext.numpy()[:, -1],
                               atol=1e-4, rtol=0)


def test_greedy_generation_matches_jax(small):
    jm, m = small
    ids = np.random.RandomState(1).randint(0, 128, (2, 8)).astype("int32")
    out = gen.generate(m, ids, max_new_tokens=6, temperature=0.0)
    assert out.shape == (2, 14)
    want = jgen.generate(jm, ids, max_new_tokens=6, temperature=0.0)
    assert np.array_equal(out.numpy(), np.asarray(want._value))
    assert torch.equal(out, gen.generate(m, ids, max_new_tokens=6,
                                         temperature=0.0))
    one = gen.generate(m, ids, max_new_tokens=1, temperature=0.0)
    assert torch.equal(one, out[:, :9])


@pytest.mark.parametrize("kw", [
    dict(temperature=0.8, top_k=10, seed=3),
    dict(temperature=0.9, top_p=0.8, seed=5),
    dict(temperature=0.7, top_k=50, top_p=0.95, seed=2),
    dict(temperature=1.0, seed=1),
    dict(temperature=1.2, top_p=0.9, seed=4, eos_token_id=17),
    dict(temperature=0.8, top_k=10, seed=6, max_new_tokens=1),
], ids=["top_k", "top_p", "top_k+top_p", "plain", "eos", "one_token"])
def test_sampled_generation_matches_jax(tiny, kw):
    jm, m = tiny
    kw = {"max_new_tokens": 12, **kw}
    prompt = np.asarray([[5, 77, 123, 9], [400, 2, 31, 8]], np.int32)
    out = gen.generate(m, prompt, **kw)
    want = jgen.generate(jm, prompt, **kw)
    assert np.array_equal(out.numpy(), np.asarray(want._value))


MASK_CASES = [(1024, 3.0, 0.8, 0, 0.95), (1024, 3.0, 1.0, 50, 0.9),
              (1024, 3.0, 1.3, 0, 0.99), (50304, 2.0, 0.8, 0, 0.95),
              (50304, 2.0, 0.8, 50, 0.95), (50304, 2.0, 1.3, 0, 0.99),
              (128, 1.0, 0.7, 0, 0.5)]


@pytest.mark.parametrize("V,scale,t,k,p", MASK_CASES)
def test_mask_logits_matches_jax(V, scale, t, k, p):
    rng = np.random.RandomState(V + int(100 * p) + k)
    logits = (rng.randn(256, V) * scale).astype(np.float32)
    want = np.asarray(jgen.mask_logits(jnp.asarray(logits), t, k, p))
    got = gen.mask_logits(torch.from_numpy(logits), t, k, p).numpy()
    rows = np.flatnonzero((got != want).any(-1))
    # at most 1 row in 10 parts, only at the boundary (see the docstring)
    assert len(rows) <= len(logits) // 10, len(rows)
    if len(rows):
        assert p < 1.0 and not k
        srt = -np.sort(-(logits[rows] / np.float32(t)), -1)
        cum = np.asarray(jnp.cumsum(jax.nn.softmax(jnp.asarray(srt), -1),
                                    -1))
        for i, r in enumerate(rows):
            assert int((got[r] != want[r]).sum()) == 1, r
            kept_g = int((got[r] > -1e29).sum())
            kept_w = int((want[r] > -1e29).sum())
            lo, hi = sorted((kept_g, kept_w))
            assert np.all(np.abs(cum[i, lo - 1:hi] - p) < 2e-5), r
    if k:
        assert np.all((got > -1e29).sum(-1) <= k)


def test_beam1_equals_greedy(tiny):
    jm, m = tiny
    prompt = np.asarray([[5, 77, 123, 9]], np.int32)
    greedy = gen.generate(m, prompt, max_new_tokens=8, temperature=0.0)
    beam1, scores = gen.beam_search(m, prompt, max_new_tokens=8,
                                    num_beams=1)
    assert torch.equal(greedy, beam1) and scores.shape == (1,)


@pytest.mark.parametrize("K,T,eos", [(4, 10, False), (3, 6, False),
                                     (3, 8, True)])
def test_beam_search_matches_jax(tiny, K, T, eos):
    jm, m = tiny
    prompt = np.asarray([[5, 77, 123, 9], [400, 2, 31, 8]], np.int32)
    eos_id = None
    if eos:
        # an EOS that the search meets early: the greedy 2nd token
        g = gen.generate(m, prompt, max_new_tokens=T, temperature=0.0)
        eos_id = int(g[0, prompt.shape[1] + 1])
    out, scores = gen.beam_search(m, prompt, max_new_tokens=T, num_beams=K,
                                  eos_token_id=eos_id)
    jout, jscores = jgen.beam_search(jm, prompt, max_new_tokens=T,
                                     num_beams=K, eos_token_id=eos_id)
    assert np.array_equal(out.numpy(), np.asarray(jout._value))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores._value),
                               atol=1e-5, rtol=0)
    if eos:
        row = out[0, prompt.shape[1]:].tolist()
        assert eos_id in row
        i = row.index(eos_id)
        assert all(t == eos_id for t in row[i:])     # frozen, then padded
    via_generate = gen.generate(m, prompt, max_new_tokens=T, num_beams=K,
                                temperature=0.0, eos_token_id=eos_id)
    assert torch.equal(via_generate, out)


def test_beam_refuses_sampling_options(tiny):
    _, m = tiny
    for kw in ({"top_k": 5}, {"temperature": 0.0, "top_k": 50},
               {"temperature": 0.7}, {"top_p": 0.5}):
        with pytest.raises(ValueError, match="beam search"):
            gen.generate(m, np.asarray([[1, 2]], np.int32), num_beams=2,
                         **kw)
    with pytest.raises(ValueError, match="max_seq_len"):
        gen.generate(m, np.zeros((1, 90), np.int32), max_new_tokens=8)
    # and the public models namespace exports it, as JAX's does
    from paddle_tpu_torch.models import beam_search
    assert beam_search is gen.beam_search


def test_top_k_breaks_ties_by_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0]])
    v, i = gen._top_k(x, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert i.tolist() == np.asarray(ji).tolist() == [[1, 2, 4, 5]]
    assert v.tolist() == np.asarray(jv).tolist()
