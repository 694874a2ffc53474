"""The dense window layout and the dispatch-separate loop in the port
(`PagedGPTDecoder(packed=False)` / `prefill_suffix_batch(packed=False)`
/ `ragged_multi(packed=False)`, one layer body `_windowed_forward` over
the kernel's dense form; `ContinuousBatchingEngine(ragged=False,
k_max > 1)` with `serve_schedule()`) against the packed layout, the
per-tick engine and the JAX package on `gpt_tiny` f32, the weights of
one JAX `GPT` carried across by `state_dict_from_numpy`.

Tolerance: none — first tokens, streams and schedules are equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import PagedGPTDecoder as JaxDecoder
from paddle_tpu.serving import PrefixCache as JaxCache
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      PagedGPTDecoder, PrefixCache)

SAMPLING = dict(temperature=0.8, top_k=40, seed=11)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this module runs (the suite
    runs in several worker processes); results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """One JAX gpt_tiny and the port's tensors of its weights."""
    paddle.seed(7)
    jmodel = GPT(jax_gpt_tiny(max_seq_len=128, dtype="float32",
                              remat=False))
    jmodel.eval()
    np_state = {k: np.asarray(v._value)
                for k, v in jmodel.state_dict().items()}
    return {"jmodel": jmodel,
            "cfg": gpt_tiny(max_seq_len=128, dtype="float32"),
            "sd": state_dict_from_numpy(np_state, device="cpu")}


def _decoder(m, max_batch=2, **kw):
    return PagedGPTDecoder(m["cfg"], m["sd"], num_pages=48, page_size=16,
                           max_batch=max_batch, device="cpu", **kw)


def _jax_decoder(m, max_batch=2, **kw):
    return JaxDecoder(m["jmodel"], num_pages=48, page_size=16,
                      max_batch=max_batch, **kw)


def _streams(eng, prompts):
    rids = [eng.submit(np.asarray(p, np.int32)) for p in prompts]
    out = eng.run()
    assert len(eng._free) + (eng.cache.n_parked if eng.cache else 0) == \
        eng.d.num_pages - 1, "page leak"
    return [out[r] for r in rids]


def _churn(seed, V):
    rng = np.random.RandomState(700 + seed)
    prompts = [list(rng.randint(0, V, rng.randint(1, 40)).astype(int))
               for _ in range(4)]
    return prompts, int(rng.randint(0, V)), int(rng.randint(3, 14))


def test_dense_prefill_first_tokens(models):
    """Mixed suffix lengths (5, 17 and 2 tokens: three window widths) and
    a suffix at start 16 over a prefilled prefix page: the dense prefill's
    first tokens equal the packed prefill's and JAX's in both layouts,
    and every dense window goes through the kernel's dense form."""
    pre = list(range(40, 56))
    reqs = [(list(range(1, 6)), 0, [0]), (list(range(1, 18)), 0, [1, 2]),
            (list(range(1, 3)), 0, [3]), (list(range(60, 70)), 16, [4, 5])]
    got = {}
    for name, make in (("port", _decoder), ("jax", _jax_decoder)):
        for packed in (True, False):
            dec = make(models, max_batch=4)
            dec.prefill_suffix_batch([(pre, 0, [4])], packed=packed)
            before = rpa.plain_launches
            got[name, packed] = dec.prefill_suffix_batch(
                reqs, kids=[0, 1, 2, 3], packed=packed)
            if name == "port" and not packed:
                # widths 8, 32, 4 and 16: four windows a layer
                assert rpa.plain_launches - before == \
                    4 * models["cfg"].num_layers
    assert len(set(map(tuple, got.values()))) == 1, got
    dense = _decoder(models, packed=False)
    assert not dense.packed
    assert dense.prefill_batch([(reqs[1][0], [0, 1])]) == \
        [got["port", True][1]]


@pytest.mark.parametrize("seed", range(2))
def test_dense_ragged_twin_streams(models, seed):
    """Under churn (sampled, an EOS, chunked prompts, more requests than
    slots), with the prefix cache off and on, the dense twin's streams
    equal the packed engine's, the per-tick engine's and the JAX dense
    twin's; the real work is the same and the dense layout pads at least
    as much."""
    prompts, eos, max_new = _churn(seed, models["cfg"].vocab_size)
    base = _streams(ContinuousBatchingEngine(
        _decoder(models, **SAMPLING), eos_token_id=eos,
        max_new_tokens=max_new, k_max=1), prompts)
    for cache in (None, True):
        eng = {}
        for packed in (True, False):
            eng[packed] = ContinuousBatchingEngine(
                _decoder(models, **SAMPLING), eos_token_id=eos,
                max_new_tokens=max_new, k_max=4, chunk_tokens=8,
                packed=packed, prefix_cache=cache)
            assert _streams(eng[packed], prompts) == base, (cache, packed)
        assert not eng[False].packed and eng[True].packed
        d, p = eng[False].stats, eng[True].stats
        assert d.tokens_dispatched - d.tokens_padded == \
            p.tokens_dispatched - p.tokens_padded
        assert p.pad_fraction <= d.pad_fraction
    jdec = _jax_decoder(models, **SAMPLING)
    jeng = JaxEngine(jdec, eos_token_id=eos, max_new_tokens=max_new,
                     k_max=4, chunk_tokens=8, packed=False)
    assert _streams(jeng, prompts) == base


@pytest.mark.parametrize("k_max", [2, 4])
def test_dispatch_separate_streams(models, k_max):
    """`ragged=False` with k_max > 1 (blocking prefill at admission, then
    decode-only horizons; an EOS that freezes slots mid-horizon, more
    requests than slots; the prefix cache off and on): the streams equal
    the per-tick engine's and JAX's `ragged=False` engine's."""
    prompts, eos, max_new = _churn(k_max, models["cfg"].vocab_size)
    base = _streams(ContinuousBatchingEngine(
        _decoder(models, **SAMPLING), eos_token_id=eos,
        max_new_tokens=max_new, k_max=1), prompts)
    for cache in (None, True):
        eng = ContinuousBatchingEngine(
            _decoder(models, **SAMPLING), eos_token_id=eos,
            max_new_tokens=max_new, k_max=k_max, ragged=False,
            prefix_cache=cache)
        assert not eng.ragged and eng.scheduler is None
        assert _streams(eng, prompts) == base, cache
        assert eng.stats.prefill_syncs > 0
    jeng = JaxEngine(_jax_decoder(models, **SAMPLING), eos_token_id=eos,
                     max_new_tokens=max_new, k_max=k_max, ragged=False)
    assert _streams(jeng, prompts) == base


@pytest.mark.parametrize("eng_kw", [
    dict(k_max=4, ragged=False), dict(k_max=4, chunk_tokens=8),
    dict(k_max=4, chunk_tokens=8, packed=False)],
    ids=["dispatch_separate", "packed", "dense"])
def test_serve_schedule_equals_jax(models, eng_kw):
    """`serve_schedule()`: the same event kinds and row mix as the JAX
    engine's — a prefill_sync a blocking admission with the decode slots
    it stalled, a horizon a ragged dispatch with k, w, t_tokens and its
    decode and prefill rows — on a prompt that arrives while another
    decodes. The prefix cache rides the packed case."""
    prompts = [[3, 141, 59], list(range(1, 40)), [7, 8], [9] * 20]
    kw = dict(eng_kw, max_new_tokens=10)
    cache = "chunk_tokens" in eng_kw and eng_kw.get("packed") is None

    def serve(eng):
        """The first prompt alone; the rest arrive at its first sync."""
        rids = [eng.submit(np.asarray(prompts[0], np.int32))]

        def arrive(e):
            if len(rids) == 1:
                rids.extend(e.submit(np.asarray(p, np.int32))
                            for p in prompts[1:])
        out = eng.run(on_sync=arrive)
        return [out[r] for r in rids]

    dec = _decoder(models)
    eng = ContinuousBatchingEngine(
        dec, prefix_cache=PrefixCache(16, salt=dec.cache_fingerprint())
        if cache else None, **kw)
    jdec = _jax_decoder(models)
    jeng = JaxEngine(jdec, prefix_cache=JaxCache(
        16, salt=jdec.cache_fingerprint()) if cache else None, **kw)
    assert serve(eng) == serve(jeng)
    assert eng.serve_schedule() == jeng.serve_schedule()
    kinds = {ev["kind"] for ev in eng.serve_schedule()}
    if eng_kw.get("ragged") is False:
        assert kinds == {"prefill_sync"}
        assert any(ev["decode_active"] > 0 for ev in eng.serve_schedule())
        assert eng.stats.prefill_stall_syncs > 0
    else:
        assert kinds == {"horizon"}
        assert any(ev["prefill_rows"] and ev["decode_rows"]
                   for ev in eng.serve_schedule())
