"""The port's prefix cache (paddle_tpu_torch.serving.prefix_cache and the
engine's content-addressed admission) against the JAX package on
`gpt_tiny` f32, with the weights of one JAX `GPT` carried across through
`state_dict_from_numpy`: chain keys bit-equal to JAX's, the same
insert/mount/release/evict sequences giving the same return values and
ledgers, cached admission and copy-on-write on the per-tick and ragged
paths against the JAX engine's golden streams, cache on/off byte
identity under churn, eviction under pressure, a refcount fuzz with a
clean page audit, the audit itself against the JAX audit on planted
defects, and streams, `ServeStats` prefix counters and page ledgers
equal to the JAX engine's on the same traffic.

Tolerance: none — tokens, keys, ledgers and counters are equal. The
port's f32 logits agree with JAX's to ~1e-6 on these streams
(tests/test_torch_serving.py), far from the greedy and sampled margins
they decide.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.analysis import memory as jax_memory
from paddle_tpu.models import GPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import PagedGPTDecoder as JaxDecoder
from paddle_tpu.serving import PrefixCache as JaxPrefixCache
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      PagedGPTDecoder, PrefixCache)
from paddle_tpu_torch.serving.page_audit import (audit_kv_scale_planes,
                                                 audit_page_ledger)

SAMPLING = dict(temperature=0.8, top_k=40, seed=11)
BASE = list(range(1, 33))                    # two full 16-token blocks


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this module runs (the suite's
    workers share the CPU with XLA's thread pools); results do not
    depend on it."""
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


def _decoder(m, num_pages=32, **kw):
    return PagedGPTDecoder(m["cfg"], m["sd"], num_pages=num_pages,
                           page_size=16, max_batch=2, device="cpu", **kw)


def _engine(m, capacity=None, num_pages=32, max_new=6, k_max=1,
            dec_kw=None, **eng_kw):
    dec = _decoder(m, num_pages=num_pages, **(dec_kw or {}))
    cache = PrefixCache(16, salt=dec.cache_fingerprint(), capacity=capacity)
    return dec, ContinuousBatchingEngine(dec, max_new_tokens=max_new,
                                         k_max=k_max, prefix_cache=cache,
                                         **eng_kw)


def _jax_engine(m, cache=True, num_pages=32, max_new=6, k_max=1,
                dec_kw=None, **eng_kw):
    dec = JaxDecoder(m["jmodel"], num_pages=num_pages, page_size=16,
                     max_batch=2, **(dec_kw or {}))
    if cache:
        eng_kw["prefix_cache"] = JaxPrefixCache(
            16, salt=dec.cache_fingerprint())
    return JaxEngine(dec, max_new_tokens=max_new, k_max=k_max, **eng_kw)


def _serve(eng, waves):
    """Submit each wave of prompts and drain it; streams in submit
    order."""
    rids, res = [], {}
    for wave in waves:
        rids += [eng.submit(np.asarray(p, np.int32)) for p in wave]
        res = eng.run()
    return [res[r] for r in rids]


def _jax_golden(m, prompts, max_new=6):
    """The JAX per-tick engine's greedy streams, no cache, one request at
    a time: each prompt's isolated golden decode."""
    eng = _jax_engine(m, cache=False, num_pages=40, max_new=max_new)
    return _serve(eng, [[p] for p in prompts])


def _pages_balanced(eng):
    """After a drain every allocatable page is free or parked in the
    cache, and the ledger audits clean."""
    assert eng.audit_pages() == [], \
        "\n".join(str(f) for f in eng.audit_pages())
    return len(eng._free) + eng.cache.n_parked == eng.d.num_pages - 1


# ------------------------------------------------------------------ unit


@pytest.mark.parametrize("page_size", [4, 16])
def test_block_keys_bit_equal_to_jax(page_size):
    """Chain keys of the same tokens under the same salts (decoder salt
    and per-request extra salt) are the JAX package's, byte for byte."""
    rng = np.random.RandomState(page_size)
    for salt, extra in ((b"", b""), (b"m1", b""), (b"fp", b"adapter")):
        ours, theirs = PrefixCache(page_size, salt=salt), \
            JaxPrefixCache(page_size, salt=salt)
        for n in (0, page_size - 1, page_size, 5 * page_size + 3):
            toks = rng.randint(0, 50304, n).tolist()
            assert ours.block_keys(toks, extra_salt=extra) == \
                theirs.block_keys(toks, extra_salt=extra)
    # a tensor of tokens hashes as its values
    toks = rng.randint(0, 1024, 3 * page_size)
    assert PrefixCache(page_size).block_keys(torch.as_tensor(toks)) == \
        JaxPrefixCache(page_size).block_keys(toks)


def _apply(cache, op, args):
    try:
        return ("ok", getattr(cache, op)(*args))
    except (RuntimeError, KeyError) as e:
        return ("raised", type(e).__name__)


@pytest.mark.parametrize("seed", range(3))
def test_cache_operations_equal_jax(seed):
    """The same random insert/mount/release/evict/match sequence over
    chained keys gives the same return values, refcounts, LRU order and
    `ledger()` in both packages — double releases and evictions included
    (each raises the same error in both)."""
    rng = np.random.RandomState(100 + seed)
    ours, theirs = PrefixCache(4, salt=b"s", capacity=12), \
        JaxPrefixCache(4, salt=b"s", capacity=12)
    chains = [ours.block_keys(rng.randint(0, 9, 16).tolist())
              for _ in range(4)]
    chains.append(chains[0][:2] + ours.block_keys(
        rng.randint(0, 9, 16).tolist())[2:])
    next_page = [0]
    for step in range(200):
        kind = rng.randint(0, 6)
        chain = chains[rng.randint(0, len(chains))]
        j = int(rng.randint(0, len(chain)))
        if kind == 0:
            next_page[0] += 1
            op = ("insert", (chain[j], next_page[0],
                             chain[j - 1] if j else None))
        elif kind == 1:
            n = len(ours.match(chain))
            op = ("mount", (chain[:n],))
        elif kind == 2:
            pages = ours.pages()
            if not pages:
                continue
            op = ("release_page", (pages[rng.randint(0, len(pages))],))
        elif kind == 3:
            op = ("evict", (int(rng.randint(1, 4)), chain[:j]))
        elif kind == 4:
            op = ("match", (chain,))
        else:
            op = ("evictable", (chain[:j],))
        got, want = _apply(ours, *op), _apply(theirs, *op)
        if op[0] == "evict" and got[0] == "ok":
            got, want = ("ok", sorted(got[1])), ("ok", sorted(want[1]))
        assert got == want, (step, op[0])
        assert ours.ledger() == theirs.ledger(), step
        assert list(ours._lru) == list(theirs._lru), step
        assert (ours.n_pages, ours.n_parked) == \
            (theirs.n_pages, theirs.n_parked)


def test_refcount_park_evict_and_cascade():
    c = PrefixCache(4, salt=b"s")
    k = c.block_keys(list(range(12)))                # 3 chained blocks
    assert c.match(k) == []
    c.insert(k[0], 10)
    c.insert(k[1], 11, parent=k[0])
    c.insert(k[2], 12, parent=k[1])
    assert c.match(k) == [10, 11, 12]
    c.mount(k)
    assert c.refs_of_page(11) == 2
    for p in (10, 11, 12):
        c.release_page(p)
        c.release_page(p)
    assert c.n_parked == 3 and c.evictable() == 3
    with pytest.raises(RuntimeError, match="double release"):
        c.release_page(10)
    assert sorted(c.evict(1)) == [10, 11, 12]       # the cascade
    assert c.n_pages == 0 and c.match(k) == []
    # capacity 0 refuses every insert
    z = PrefixCache(4, salt=b"s", capacity=0)
    assert z.insert(k[0], 3) is False and z.match(k) == []


# ---------------------------------------------------------------- engine


@pytest.mark.parametrize("k_max", [1, 4])
def test_cached_admission_matches_jax_golden(models, k_max):
    """Requests sharing a block-aligned prefix: the later ones mount the
    cached pages and prefill only their suffix (start 32) — on the
    per-tick path and through the ragged horizon — and still emit the JAX
    engine's golden greedy streams."""
    prompts = [BASE + [44, 45, 46], BASE + [61, 62], BASE[:16] + [7, 8]]
    golden = _jax_golden(models, prompts)
    dec, eng = _engine(models, k_max=k_max)
    assert _serve(eng, [[p] for p in prompts]) == golden
    s = eng.stats
    assert s.prefix_hits == 3 and s.prefix_tokens_saved == 48
    assert s.prefix_bytes_saved == 48 * dec.kv_page_bytes // 16
    assert s.prefill_chunk_tokens == (0 if k_max == 1 else
                                      35 + (34 - 32) + (18 - 16))
    assert _pages_balanced(eng)


@pytest.mark.parametrize("k_max", [1, 4])
@pytest.mark.parametrize("seed", range(3))
def test_cache_on_off_byte_identical_under_churn(models, seed, k_max):
    """Cache on and off (capacity 0) emit byte-identical streams under
    admission churn: more requests than slots, shared prefixes at 0, 1 or
    2 blocks, EOS retirement, sampled decoding, per-tick and ragged
    horizons, two waves (the second hits pages the first published); and
    both pools take back every page."""
    rng = np.random.RandomState(200 + seed)
    V = models["cfg"].vocab_size
    templates = [list(rng.randint(0, V, 32).astype(int)) for _ in range(2)]
    prompts = [templates[0] + [1, 2]]
    for _ in range(3):
        t = templates[int(rng.randint(0, 2))]
        cut = int(rng.choice([0, 16, 32]))
        suffix = list(rng.randint(0, V, rng.randint(1, 8)).astype(int))
        prompts.append(t[:cut] + suffix)
    prompts.append(templates[0] + [3])
    prompts.append(list(templates[1]))          # a full-prompt hit
    eos = int(rng.randint(0, V))
    max_new = int(rng.randint(3, 12))
    outs = {}
    for label, capacity in (("on", None), ("off", 0)):
        _, eng = _engine(models, capacity=capacity, num_pages=48,
                         max_new=max_new, k_max=k_max,
                         dec_kw=dict(SAMPLING), eos_token_id=eos)
        outs[label] = _serve(eng, [prompts[:3], prompts[3:]])
        assert _pages_balanced(eng)
        if capacity is None:
            assert eng.stats.prefix_hits > 0, "workload never hit"
    assert outs["on"] == outs["off"], (seed, eos, max_new)


@pytest.mark.parametrize("k_max", [1, 4])
def test_full_prompt_hit_copy_on_write(models, k_max):
    """A prompt whose every block is cached re-consumes its last token for
    its logits: that write lands in a mounted page, so the page is copied
    first. Output golden, the original stays cached, the copy is private
    and bit-equal to its source before the rewrite; on the ragged path the
    one re-consumed token streams through the horizon as a chunk."""
    golden = _jax_golden(models, [BASE])[0]
    dec, eng = _engine(models, k_max=k_max)
    copies = []
    orig = dec.copy_page

    def spy(src, dst):
        orig(src, dst)
        copies.append((src, dst, dec.k_pages[:, dst].clone(),
                       dec.k_pages[:, src].clone()))
    dec.copy_page = spy
    assert _serve(eng, [[BASE], [BASE]]) == [golden, golden]
    s = eng.stats
    assert s.prefix_cow == 1 and len(copies) == 1
    src, dst, copied, source = copies[0]
    assert torch.equal(copied, source) and src != dst
    assert s.prefix_tokens_saved == 31          # L - 1
    assert eng.cache.n_pages == 2
    if k_max > 1:
        assert s.prefill_syncs == 0
        assert s.prefill_chunk_tokens == len(BASE) + 1
    assert _pages_balanced(eng)


def test_eviction_under_pool_pressure(models):
    """A pool too small to keep old prefixes: admission evicts parked
    refcount-0 pages (never referenced ones), streams stay golden, and
    the audit stays clean after every drain."""
    rng = np.random.RandomState(5)
    V = models["cfg"].vocab_size
    prompts = [list(rng.randint(0, V, 33).astype(int)) for _ in range(5)]
    golden = _jax_golden(models, prompts)
    _, eng = _engine(models, num_pages=11)
    for p, want in zip(prompts, golden):
        assert _serve(eng, [[p]]) == [want]
        assert eng.audit_pages() == []
    assert eng.stats.prefix_evictions > 0
    assert _pages_balanced(eng)


@pytest.mark.parametrize("k_max", [1, 4])
@pytest.mark.parametrize("seed", range(2))
def test_refcount_fuzz_every_page_freed_exactly_once(models, seed, k_max):
    """Mixed waves (full hits, shared prefixes, unrelated prompts) on a
    tight pool: after every drain the page audit is empty, and at the end
    free + parked covers the pool with every refcount back at 0."""
    rng = np.random.RandomState(300 + seed)
    V = models["cfg"].vocab_size
    base = list(rng.randint(0, V, 32).astype(int))
    _, eng = _engine(models, num_pages=20, k_max=k_max,
                     max_new=int(rng.randint(2, 6)))
    for wave in range(4):
        for _ in range(int(rng.randint(1, 4))):
            kind = rng.randint(0, 3)
            if kind == 0:
                p = base
            elif kind == 1:
                p = base[:16] + list(
                    rng.randint(0, V, rng.randint(1, 10)).astype(int))
            else:
                p = list(rng.randint(0, V, rng.randint(1, 34)).astype(int))
            eng.submit(np.asarray(p, np.int32))
        eng.run()
        assert eng.audit_pages() == [], wave
    assert _pages_balanced(eng)
    assert sum(e.refs for e in eng.cache._entries.values()) == 0


def test_same_batch_duplicate_stops_chain_publishing(models):
    """Two prompts sharing block X admitted in one batch both miss; the
    one that loses the X insert must not publish its deeper block Y under
    a parent it does not hold, and later pressure evicting X raises
    nothing."""
    X, Y = list(range(1, 17)), list(range(17, 33))
    p2 = X + Y + [41]
    _, eng = _engine(models, num_pages=16, max_new=3)
    _serve(eng, [[X + [40], p2]])
    assert len(eng.cache.match(eng.cache.block_keys(p2))) == 1
    assert eng.cache.n_pages == 1
    rng = np.random.RandomState(3)
    for _ in range(4):
        _serve(eng, [[rng.randint(0, models["cfg"].vocab_size, 33)]])
        assert eng.audit_pages() == []
    assert _pages_balanced(eng)


def test_full_hit_on_tight_pool_degrades(models):
    """A full-prompt hit on a pool with no spare page for its copy
    degrades its mounted span (its own parked hit pages become
    evictable) instead of waiting forever."""
    golden = _jax_golden(models, [BASE], max_new=4)[0]
    _, eng = _engine(models, num_pages=4, max_new=4)
    assert _serve(eng, [[BASE], [BASE]]) == [golden, golden]
    assert eng.stats.prefix_hits >= 1
    assert _pages_balanced(eng)


COUNTERS = ("prefix_hits", "prefix_misses", "prefix_cow",
            "prefix_evictions", "prefix_tokens_saved", "prefix_bytes_saved",
            "prefill_chunk_tokens", "completed", "tokens")


@pytest.mark.parametrize("k_max", [1, 4])
def test_streams_counters_and_ledger_equal_jax_engine(models, k_max):
    """The same traffic (shared prefixes, a full-prompt hit, a tight pool
    that forces evictions, sampled decoding) through the JAX engine with a
    prefix cache and through the port's: equal streams, equal
    `ServeStats` prefix counters, and equal page ledgers (the same pages
    free, held, shared and parked) after every wave."""
    rng = np.random.RandomState(17)
    V = models["cfg"].vocab_size
    tpl = list(rng.randint(0, V, 32).astype(int))
    waves = [[tpl + [5, 6], list(rng.randint(0, V, 20).astype(int)),
              tpl[:16] + [9]],
             [tpl, tpl + [7], list(rng.randint(0, V, 40).astype(int))],
             [list(rng.randint(0, V, 48).astype(int)) for _ in range(2)],
             [tpl[:16] + [1, 2, 3], tpl]]
    kw = dict(num_pages=14, max_new=5, k_max=k_max, dec_kw=dict(SAMPLING))
    jeng = _jax_engine(models, **kw)
    _, eng = _engine(models, **kw)
    for i in range(len(waves)):
        assert _serve(eng, waves[i:i + 1]) == _serve(jeng, waves[i:i + 1])
        assert eng.page_ledger() == jeng.page_ledger(), i
    for name in COUNTERS:
        assert getattr(eng.stats, name) == getattr(jeng.stats, name), name
    assert eng.stats.prefix_evictions > 0 and eng.stats.prefix_cow > 0
    assert eng.stats.summary()["prefix_hit_rate"] == \
        jeng.stats.summary()["prefix_hit_rate"]


# ----------------------------------------------------------------- audit


def _ledgers():
    """A consistent ledger and planted defects of each kind the audit
    knows."""
    ok = {"num_pages": 8, "scratch": 7, "free": [5, 6],
          "slots": {0: [0, 1], 1: [0, 2]}, "shared": {0: [0], 1: [0]},
          "cache": {0: {"refs": 2, "parked": False},
                    3: {"refs": 0, "parked": True},
                    4: {"refs": 0, "parked": True}},
          "host": {"aa" * 16: {"bytes": 64, "page": 3},
                   "bb" * 16: {"bytes": 64, "page": None}}}
    bad = []
    for mutate in (
            lambda l: l["free"].append(5),                  # double free
            lambda l: l["free"].append(7),                  # scratch free
            lambda l: l["free"].remove(6),                  # leak
            lambda l: l["free"].append(1),                  # free and held
            lambda l: l["cache"][0].update(refs=1),         # drift
            lambda l: l["cache"][3].update(refs=-1),        # underflow
            lambda l: l["shared"].update({0: [0, 1]}),      # untracked
            lambda l: l["slots"].update({1: [0, 2, 3]}),    # parked held
            lambda l: l["slots"].update({1: [0, 2, 1]}),    # aliasing
            lambda l: l["host"]["aa" * 16].update(page=5),  # twin free
            lambda l: l["host"]["aa" * 16].update(page=2)):  # stale twin
        led = copy.deepcopy(ok)
        mutate(led)
        bad.append(led)
    return ok, bad


def test_page_audit_equals_jax_audit():
    """The port's audit finds the same findings, message for message, as
    the JAX `audit_page_ledger` on a clean ledger (none) and on each
    planted defect (at least one)."""
    ok, bad = _ledgers()
    assert audit_page_ledger(ok) == [] == jax_memory.audit_page_ledger(ok)
    for led in bad:
        got = [f.message for f in audit_page_ledger(led)]
        want = [f.message for f in jax_memory.audit_page_ledger(led)]
        assert got == want and got, led


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_scale_plane_audit_equals_jax_audit(models, kv_quant):
    """A quantized pool after a cached run audits clean; zeroing a scale
    row under live bytes of a held page (what a copy that forgot the scale
    plane leaves) is found, with the JAX audit's message on the same
    arrays."""
    class Pools:                  # what the JAX audit reads of a decoder
        pass

    dec, eng = _engine(models, dec_kw=dict(kv_quant=kv_quant), k_max=4)
    _serve(eng, [[BASE + [3]], [BASE]])
    assert eng.stats.prefix_cow == 1
    assert eng.audit_pages() == []
    page = eng.cache.pages()[0]
    dec.k_pages[1][1, page, 3] = 0.0
    got = [f.message for f in eng.audit_pages()]
    jdec = Pools()
    jdec.k_pages = tuple(x.numpy() for x in dec.k_pages)
    jdec.v_pages = tuple(x.numpy() for x in dec.v_pages)
    want = [f.message for f in jax_memory.audit_kv_scale_planes(
        jdec, sorted(eng.cache.pages()))]
    assert got == want and len(got) == 1 and f"page {page}" in got[0]
    assert audit_kv_scale_planes(dec, eng.cache.pages(), chunk=1) and \
        [f.message for f in audit_kv_scale_planes(
            dec, sorted(eng.cache.pages()), chunk=1)] == want
