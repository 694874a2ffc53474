"""The port's host KV tier and cache persistence (serving/kv_tier.py,
PrefixCache.save / load, the decoder's page primitives and
`cache_fingerprint`) against the JAX package on `gpt_tiny` f32, with the
weights of one JAX `GPT` carried across through `state_dict_from_numpy`:
the tier's LRU and capacity 0, `restore_beats_recompute` against the JAX
formula on the same ChipSpec numbers, spill and restore against the JAX
engine's golden streams, tier on / off / capacity-0 byte identity under
churn on f32, int8 and int4 pools, quantized payloads with their scale
planes, a save / load round trip with the fingerprint and wrong-decoder
refusals, one D2H per pool leaf a wave and one H2D per pool leaf a span,
and `pack_array` of a bf16 tensor against the JAX `pack_array` of the same
values.

Tolerance: none — tokens, bytes, counters and decisions are equal —
except where the two packages' pool values meet (the last test): f32 K/V
within 1e-5, the two frameworks' matmuls being ~1e-6 apart.
"""
import json
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import cost_model as jax_cost
from paddle_tpu.models import GPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import PagedGPTDecoder as JaxDecoder
from paddle_tpu.serving import PrefixCache as JaxPrefixCache
from paddle_tpu.serving import restore_beats_recompute as jax_rbr
from paddle_tpu.serving.prefix_cache import pack_array as jax_pack
from paddle_tpu_torch import cost_model
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.serving import (ContinuousBatchingEngine, HostKVTier,
                                      PagedGPTDecoder, PrefixCache,
                                      restore_beats_recompute)
from paddle_tpu_torch.serving.kv_tier import payload_bytes
from paddle_tpu_torch.serving.prefix_cache import pack_array, unpack_array

SAMPLING = dict(temperature=0.8, top_k=40, seed=11)


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
    """One JAX gpt_tiny, its numpy weights and the port's tensors of
    them."""
    paddle.seed(7)
    jmodel = GPT(jax_gpt_tiny(max_seq_len=128, dtype="float32",
                              remat=False))
    jmodel.eval()
    np_state = {k: np.asarray(v._value)
                for k, v in jmodel.state_dict().items()}
    return {"jmodel": jmodel, "np": np_state,
            "cfg": gpt_tiny(max_seq_len=128, dtype="float32"),
            "sd": state_dict_from_numpy(np_state, device="cpu")}


def _decoder(m, num_pages=11, sd=None, **kw):
    return PagedGPTDecoder(m["cfg"], sd or m["sd"], num_pages=num_pages,
                           page_size=16, max_batch=2, device="cpu", **kw)


def _engine(m, tier=None, policy="auto", num_pages=11, max_new=6, k_max=1,
            capacity=None, dec_kw=None, **eng_kw):
    dec = _decoder(m, num_pages=num_pages, **(dec_kw or {}))
    cache = PrefixCache(16, salt=dec.cache_fingerprint(), capacity=capacity,
                        tier=tier)
    return dec, ContinuousBatchingEngine(dec, max_new_tokens=max_new,
                                         k_max=k_max, prefix_cache=cache,
                                         tier_policy=policy, **eng_kw)


def _serve(eng, waves):
    rids, res = [], {}
    for wave in waves:
        rids += [eng.submit(np.asarray(p, np.int32)) for p in wave]
        res = eng.run()
    return [res[r] for r in rids]


def _jax_golden(m, prompts, max_new=6):
    """The JAX per-tick engine's greedy streams, no cache, one request at
    a time."""
    dec = JaxDecoder(m["jmodel"], num_pages=40, page_size=16, max_batch=2)
    eng = JaxEngine(dec, max_new_tokens=max_new, k_max=1)
    return _serve(eng, [[p] for p in prompts])


def _pages_balanced(eng):
    assert eng.audit_pages() == [], \
        "\n".join(str(f) for f in eng.audit_pages())
    return len(eng._free) + eng.cache.n_parked == eng.d.num_pages - 1


def _prompts(seed, n, length=33, V=1024):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, V, length).astype(int)) for _ in range(n)]


def _payload(nbytes=64):
    return {"k": (torch.zeros(nbytes // 2, dtype=torch.uint8),),
            "v": (torch.zeros(nbytes // 2, dtype=torch.uint8),)}


# ------------------------------------------------------------------ unit


def test_host_tier_lru_capacity_and_eviction():
    t = HostKVTier(capacity_bytes=200)
    assert t.put(b"a", _payload(64)) and t.put(b"b", _payload(64))
    assert t.bytes_used == 128 and t.n_entries == 2
    t.touch(b"a")                        # b is now LRU
    assert t.put(b"c", _payload(128))    # evicts b to fit
    assert b"b" not in t and b"a" in t and b"c" in t
    assert t.evictions == 1 and t.bytes_used == 192
    assert not t.put(b"d", _payload(400))           # bigger than the tier
    assert t.put(b"a", _payload(64))                # re-put: no double count
    assert t.bytes_used == 192 and t.entry_bytes(b"a") == 64
    t.note_mounted(b"a", 5)
    assert t.ledger()[b"a".hex()] == {"bytes": 64, "page": 5}
    t.note_unmounted(b"a")
    assert t.ledger()[b"a".hex()]["page"] is None
    assert [k for k, _ in t.items()] == [b"c", b"a"]
    z = HostKVTier(capacity_bytes=0)                # the tier-off twin
    assert not z.put(b"a", _payload(2))
    assert z.n_entries == 0 and z.bytes_used == 0


def test_restore_beats_recompute_matches_jax_formula():
    """On the same ChipSpec numbers (the JAX package's v5e and v4
    entries, and the port's H100), the port's pricing gives the JAX
    formula's times and decisions over a grid of spans, sizes and model
    widths, shared or not."""
    for name in ("v5e", "v4"):
        jchip = jax_cost.chip_spec(name)
        chip = cost_model.ChipSpec(name, jchip.peak_flops, jchip.hbm_bw,
                                   jchip.hbm_bytes, host_bw=jchip.host_bw,
                                   host_read_bw=jchip.host_read_bw)
        for nbytes in (0, 1 << 16, 3 << 20, 3.15e6, 1 << 30):
            for shared in (False, True):
                assert cost_model.kv_restore_s(nbytes, chip=chip,
                                               shared=shared) == \
                    jax_cost.kv_restore_s(nbytes, chip=jchip, shared=shared)
            for tokens in (1, 16, 512):
                for fpt in (2e6, 2.6e9, 5.2e9):
                    assert cost_model.prefill_ttft_s(
                        tokens, fpt, chip=chip, host_sync_s=0.0) == \
                        jax_cost.prefill_ttft_s(tokens, fpt, chip=jchip,
                                                host_sync_s=0.0)
                    for shared in (False, True):
                        assert restore_beats_recompute(
                            nbytes, tokens, fpt, chip=chip,
                            shared=shared) == jax_rbr(
                            nbytes, tokens, fpt, chip=jchip, shared=shared)


def test_h100_pricing_of_a_gpt_1p3b_page():
    """The port's own chip: PCIe Gen5 x16 at 64 GB/s a direction. A bf16
    gpt_1p3b page (24 layers x 16 tokens x 8192 B) restores in ~49 us and
    recomputes in ~65 us at 65% of 989 TFLOP/s, so "auto" restores it —
    near the edge; an int8 page (half the bytes) restores clearly, and a
    tiny model's page recomputes."""
    page = 24 * 16 * 8192
    assert cost_model.H100_SXM.host_bw == 64e9
    assert cost_model.kv_restore_s(page) == pytest.approx(49.2e-6, rel=1e-3)
    assert cost_model.prefill_ttft_s(16, 2 * 1.31e9, host_sync_s=0.0) == \
        pytest.approx(65.2e-6, rel=1e-2)
    assert restore_beats_recompute(page, 16, 2 * 1.31e9)
    assert restore_beats_recompute(page // 2, 16, 2 * 1.31e9)
    assert not restore_beats_recompute(page, 16, 2 * 1.31e9 / 2)
    assert not restore_beats_recompute(2 * 16 * 2048, 16, 2e6)


@pytest.mark.parametrize("values", ["normal", "specials"])
def test_pack_array_bf16_equals_jax(values):
    """`pack_array` of a bf16 tensor gives the bytes and meta the JAX
    `pack_array` gives for the same values (an ml_dtypes bfloat16 array),
    and `unpack_array` inverts both: one persisted byte format."""
    rng = np.random.RandomState(3)
    if values == "normal":
        x = rng.standard_normal((2, 3, 16, 4)).astype(np.float32)
    else:
        x = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, 3.4e38, 1.0,
                      -2.5], np.float32).reshape(2, 4)
    t = torch.from_numpy(x).to(torch.bfloat16)
    raw, meta = pack_array(t)
    jraw, jmeta = jax_pack(x.astype(ml_dtypes.bfloat16))
    assert meta == jmeta == {"shape": list(x.shape), "dtype": "bfloat16"}
    assert raw.dtype == np.uint8 and raw.tobytes() == jraw.tobytes()
    back = unpack_array(jraw, jmeta)
    assert back.dtype == torch.bfloat16 and torch.equal(
        back.view(torch.int16), t.view(torch.int16))
    # other leaf dtypes of a pool: int8 pages, uint8 nibbles, f32 scales
    for arr in (rng.randint(-127, 128, (2, 5)).astype(np.int8),
                rng.randint(0, 256, (3, 4)).astype(np.uint8),
                rng.standard_normal((4, 2)).astype(np.float32)):
        raw, meta = pack_array(torch.from_numpy(arr))
        jraw, jmeta = jax_pack(arr)
        assert meta == jmeta and raw.tobytes() == jraw.tobytes()
        assert np.array_equal(unpack_array(raw, meta).numpy(), arr)


# ---------------------------------------------------------------- engine


@pytest.mark.parametrize("k_max", [1, 4])
def test_spill_on_eviction_and_restore_matches_golden(models, k_max):
    """Pool pressure demotes parked pages to the host tier; a later
    admission whose chain lives only on host restores it — streams stay
    the JAX engine's golden ones, the ledger (host rows included) audits
    clean throughout, and the first restored page's bytes equal its
    spilled bytes bit for bit."""
    prompts = _prompts(5, 5)
    golden = _jax_golden(models, prompts)
    tier = HostKVTier()
    dec, eng = _engine(models, tier=tier, policy="restore", k_max=k_max)
    for p, want in zip(prompts, golden):
        assert _serve(eng, [[p]]) == [want]
        assert eng.audit_pages() == []
    s = eng.stats
    assert s.tier_spills > 0 and s.host_tier_bytes > 0
    assert tier.n_entries == s.tier_spills
    assert len(eng.page_ledger()["host"]) == tier.n_entries
    assert _serve(eng, [[p] for p in prompts[:3]]) == golden[:3]
    assert s.tier_restores > 0 and s.prefix_hits >= s.tier_restores
    restored = [e for _, e in tier.items() if e.page is not None]
    assert restored
    for e in restored:              # the spilled bytes, back in a page
        now = (dec.k_pages[:, e.page], dec.v_pages[:, e.page])
        assert all(torch.equal(a, b) for a, b in
                   zip(now, e.payload["k"] + e.payload["v"]))
    assert _pages_balanced(eng)


@pytest.mark.parametrize("seed", range(3))
def test_streams_byte_identical_tier_on_off_capacity0(models, seed):
    """Tier on (restore pinned), tier off and a capacity-0 tier emit
    byte-identical streams under churn — sampled decoding, EOS
    retirement, ragged horizons (k 4 and 8), int4, f32 and int8 pools
    (seeds 0-2), evictions that spill and later waves that restore — and
    every pool takes back its pages."""
    rng = np.random.RandomState(700 + seed)
    V = models["cfg"].vocab_size
    k_max = 8 if seed == 1 else 4
    dec_kw = dict(SAMPLING)
    if seed == 2:
        dec_kw["kv_quant"] = "int8"
    elif seed == 0:
        dec_kw["kv_quant"] = "int4"
    templates = [list(rng.randint(0, V, 32).astype(int)) for _ in range(3)]
    prompts = [templates[0] + [1, 2]]
    for _ in range(4):
        t = templates[int(rng.randint(0, 3))]
        cut = int(rng.choice([0, 16, 32]))
        suffix = list(rng.randint(0, V, rng.randint(1, 8)).astype(int))
        prompts.append(t[:cut] + suffix)
    prompts += [templates[1] + [3], templates[2] + [5], templates[0] + [4]]
    prompts += [list(rng.randint(0, V, 33).astype(int)) for _ in range(3)]
    prompts += [templates[0] + [1, 2], templates[1] + [3]]
    eos = int(rng.randint(0, V))
    max_new = int(rng.randint(6, 14))
    outs, spilled, restored = {}, 0, 0
    for label, tier, policy in (("on", HostKVTier(), "restore"),
                                ("off", None, "auto"),
                                ("cap0", HostKVTier(capacity_bytes=0),
                                 "restore")):
        _, eng = _engine(models, tier=tier, policy=policy, num_pages=9,
                         max_new=max_new, k_max=k_max, dec_kw=dict(dec_kw),
                         eos_token_id=eos)
        outs[label] = _serve(eng, [prompts[0:4], prompts[4:8],
                                   prompts[8:11], prompts[11:13]])
        assert _pages_balanced(eng)
        if label == "on":
            spilled = eng.stats.tier_spills
            restored = eng.stats.tier_restores
    assert outs["on"] == outs["off"] == outs["cap0"], (seed, eos, max_new)
    assert spilled > 0 and restored > 0


def test_auto_policy_recomputes_for_tiny_model(models):
    """On the H100's pricing a gpt_tiny page recomputes faster than it
    crosses PCIe, so "auto" re-prefills host-resident spans (counted in
    tier_recomputes) and keeps the host entries, recency refreshed;
    streams stay golden."""
    prompts = _prompts(9, 5)
    tier = HostKVTier()
    dec, eng = _engine(models, tier=tier, policy="auto")
    _serve(eng, [[p] for p in prompts])
    assert eng.stats.tier_spills > 0
    spilled_keys = {k for k, _ in tier.items()}
    hit = next(p for p in prompts
               if eng.cache.block_keys(p)[0] in spilled_keys)
    assert _serve(eng, [[hit]]) == _jax_golden(models, [hit])
    s = eng.stats
    assert s.tier_recomputes > 0 and s.tier_restores == 0
    # the recomputed span's host entries are kept, not dropped
    assert all(k in tier for k in eng.cache.block_keys(hit)
               if k in spilled_keys)
    assert _pages_balanced(eng)


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_quantized_payloads_carry_scale_planes(models, kv_quant):
    """A quantized pool spills its stored bytes — the int8 pages or int4
    nibbles AND their f32 scale planes, bit-equal to the pool's at the
    time of the spill — under half the f32 spill; a restore puts both
    back, and the copy-on-write copy of a full-prompt hit moves the scale
    planes with the bytes (the scale-plane audit stays clean)."""
    def spill(dec_kw, seen):
        dec, eng = _engine(models, tier=HostKVTier(), policy="restore",
                           dec_kw=dec_kw)
        fetch = dec.fetch_page_payloads

        def spy(victims):
            before = {p: [leaf[:, p].clone() for _, _, leaf in dec._leaves()]
                      for p in victims}
            out = fetch(victims)
            seen.extend((before[p], payload)
                        for p, payload in zip(victims, out))
            return out
        dec.fetch_page_payloads = spy
        _serve(eng, [[p] for p in _prompts(5, 5)])
        assert eng.stats.tier_spills > 0
        return eng, eng.stats.host_tier_bytes / eng.stats.tier_spills

    _, full = spill(None, [])
    seen = []
    eng, quant = spill(dict(kv_quant=kv_quant), seen)
    assert quant < full / 2, (quant, full)
    for pool, payload in seen:
        leaves = payload["k"] + payload["v"]
        assert len(leaves) == 4                  # bytes + scales, K and V
        assert all(torch.equal(a, b) for a, b in zip(pool, leaves))
        assert payload_bytes(payload) == eng.d.kv_page_bytes
    _serve(eng, [[p] for p in _prompts(5, 2)])
    assert eng.stats.tier_restores > 0
    base = list(range(1, 33))
    _serve(eng, [[base], [base]])
    assert eng.stats.prefix_cow >= 1
    assert _pages_balanced(eng)


def test_restore_survives_same_admission_tier_churn(models):
    """A near-capacity tier can LRU the very entries an admission planned
    to restore while the same admission spills new ones: the plan pins
    the payloads, so the restore still reads them; streams stay equal to
    the first run's and golden."""
    prompts = _prompts(11, 6)
    page_bytes = _decoder(models).kv_page_bytes
    tier = HostKVTier(capacity_bytes=page_bytes + page_bytes // 2)
    _, eng = _engine(models, tier=tier, policy="restore")
    outs = {}
    for p in prompts + prompts[:4] + prompts[2:5]:
        out = _serve(eng, [[p]])[0]
        assert outs.setdefault(tuple(p), out) == out, "stream diverged"
        assert eng.audit_pages() == []
    assert eng.stats.tier_spills > 0 and tier.evictions > 0
    assert [outs[tuple(p)] for p in prompts] == _jax_golden(models, prompts)
    assert _pages_balanced(eng)


def test_spill_and_restore_transfers_are_batched(models):
    """A multi-page eviction wave pays ONE gather + D2H per pool leaf and
    a multi-block restored span ONE H2D per pool leaf (counted by the
    decoder), never the per-page primitive; every spilled and restored
    page is accounted by the batched calls."""
    prompts = _prompts(5, 4, length=49)
    tier = HostKVTier()
    dec, eng = _engine(models, tier=tier, policy="restore", max_new=4)
    waves, spans = [], []
    fetch, mount = dec.fetch_page_payloads, dec.mount_page_payloads
    dec.fetch_page_payloads = lambda pages: (waves.append(list(pages)),
                                             fetch(pages))[1]
    dec.mount_page_payloads = lambda pages, pl: (spans.append(list(pages)),
                                                 mount(pages, pl))[1]
    golden = _jax_golden(models, prompts + prompts[:1], max_new=4)
    assert _serve(eng, [[p] for p in prompts]) == golden[:4]
    assert max(map(len, waves)) >= 2
    assert eng.stats.tier_spills == sum(map(len, waves))
    assert dec.transfers["d2h"] == 2 * len(waves)   # K and V leaves
    assert _serve(eng, [prompts[:1]]) == golden[4:]
    assert eng.stats.tier_restores >= 2 and max(map(len, spans)) >= 2
    assert eng.stats.tier_restores == sum(map(len, spans))
    assert dec.transfers["h2d"] == 2 * len(spans)
    assert _pages_balanced(eng)


# ------------------------------------------------------------ persistence


@pytest.mark.parametrize("kv_quant", [None, "int4"])
def test_save_load_round_trip_warm_start(models, tmp_path, kv_quant):
    """save -> a fresh decoder of the same weights -> load: the loaded
    pages are bit-equal copies of the saving pool's (int4 nibbles and
    scale planes too), the warm engine hits from its first request, its
    streams equal the saving engine's, host-tier entries survive, and the
    ledger audits clean."""
    d = str(tmp_path / "cache")
    prompt = list(range(1, 33)) + [44, 45]
    kw = {"kv_quant": kv_quant} if kv_quant else {}
    dec, eng = _engine(models, tier=HostKVTier(), num_pages=32, dec_kw=kw)
    o1 = _serve(eng, [[prompt]])
    eng.cache.save(d)
    dec2 = _decoder(models, num_pages=32, **kw)
    cache2 = PrefixCache.load(d, dec2)
    keys = eng.cache.block_keys(prompt)
    assert eng.cache.match(keys) == cache2.match(keys) != []
    for (_, _, a), (_, _, b) in zip(dec._leaves(), dec2._leaves()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    eng2 = ContinuousBatchingEngine(dec2, max_new_tokens=6,
                                    prefix_cache=cache2)
    assert _serve(eng2, [[prompt]]) == o1
    assert eng2.stats.prefix_hits == 2
    assert eng2.stats.prefix_tokens_saved == 32
    assert len(eng2._free) + eng2.cache.n_parked == dec2.num_pages - 1
    assert eng2.audit_pages() == []


def test_persistence_preserves_host_tier_entries(models, tmp_path):
    """Host entries ride the save, bounds included: a loaded cache's tier
    serves restores for chains spilled before the save, and the engine's
    gauge starts at the loaded bytes."""
    d = str(tmp_path / "cache")
    prompts = _prompts(5, 5)
    tier = HostKVTier(capacity_bytes=1 << 20)
    _, eng = _engine(models, tier=tier, policy="restore", capacity=20)
    _serve(eng, [[p] for p in prompts])
    assert eng.stats.tier_spills > 0
    eng.cache.save(d)
    dec2 = _decoder(models)
    cache2 = PrefixCache.load(d, dec2)
    assert cache2.capacity == 20 and cache2.tier.capacity_bytes == 1 << 20
    assert cache2.tier.n_entries == tier.n_entries
    for (k, a), (k2, b) in zip(tier.items(), cache2.tier.items()):
        assert k == k2 and all(torch.equal(x, y) for x, y in zip(
            a.payload["k"] + a.payload["v"], b.payload["k"] + b.payload["v"]))
    eng2 = ContinuousBatchingEngine(dec2, max_new_tokens=6,
                                    prefix_cache=cache2, host_tier=True,
                                    tier_policy="restore")
    assert eng2.tier is cache2.tier
    assert eng2.stats.host_tier_bytes == cache2.tier.bytes_used > 0
    hit = next(p for p in prompts if cache2.block_keys(p)[0] in cache2.tier)
    assert _serve(eng2, [[hit]]) == _jax_golden(models, [hit])
    assert eng2.stats.tier_restores > 0
    assert eng2.audit_pages() == []
    with pytest.raises(ValueError, match="already carries"):
        ContinuousBatchingEngine(_decoder(models),
                                 prefix_cache=PrefixCache.load(
                                     d, _decoder(models)),
                                 host_tier=HostKVTier())


def test_fingerprint_and_wrong_decoder_refusals(models, tmp_path):
    """The fingerprint is equal for two decoders built from one state
    dict and changes when one weight element changes (and with the pool's
    precision); a save refuses to load onto another fingerprint, and an
    engine refuses a loaded cache with a decoder other than the one it was
    loaded onto."""
    d = str(tmp_path / "cache")
    fp = _decoder(models).cache_fingerprint()
    assert _decoder(models).cache_fingerprint() == fp
    sd = dict(models["sd"])
    w = sd["blocks.1.fc2.weight"].clone()
    w[7, 3] = torch.nextafter(w[7, 3], torch.tensor(1.0))
    sd["blocks.1.fc2.weight"] = w
    assert _decoder(models, sd=sd).cache_fingerprint() != fp
    assert _decoder(models, kv_quant="int8").cache_fingerprint() != fp
    dec, eng = _engine(models, num_pages=32)
    _serve(eng, [[list(range(1, 33))]])
    eng.cache.save(d)
    for other in (_decoder(models, num_pages=32, sd=sd),
                  _decoder(models, num_pages=32, kv_quant="int4")):
        with pytest.raises(ValueError, match="fingerprint"):
            PrefixCache.load(d, other)
    dec2 = _decoder(models, num_pages=32)
    cache2 = PrefixCache.load(d, dec2)
    with pytest.raises(ValueError, match="different decoder"):
        ContinuousBatchingEngine(_decoder(models, num_pages=32),
                                 prefix_cache=cache2)
    ContinuousBatchingEngine(dec2, prefix_cache=cache2)     # its own: fine


def test_fingerprint_equal_in_a_fresh_process(models, tmp_path):
    """The same weights give the same fingerprint in another process
    (integer probes: no order, thread or process dependence)."""
    path = tmp_path / "sd.pt"
    torch.save(models["sd"], path)
    code = (
        "import sys, torch\n"
        "from paddle_tpu_torch.models import gpt_tiny\n"
        "from paddle_tpu_torch.serving import PagedGPTDecoder\n"
        "sd = torch.load(sys.argv[1])\n"
        "dec = PagedGPTDecoder(gpt_tiny(max_seq_len=128, dtype='float32'),"
        " sd, num_pages=11, page_size=16, max_batch=2, device='cpu')\n"
        "sys.stdout.write(dec.cache_fingerprint().decode())\n")
    out = subprocess.run([sys.executable, "-c", code, str(path)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert out.encode() == _decoder(models).cache_fingerprint()


def test_save_and_load_pool_state_refuse_live_references(models):
    """save() under live requests would snapshot pages about to diverge,
    and load_pool_state under an engine holding pages (slot-held, or
    parked in its cache) would orphan its ledger: both refuse. A drained
    cache-less engine's pool loads, by copy. adapter ids other than 0
    raise."""
    dec, eng = _engine(models, num_pages=32, max_new=8)
    donor = _decoder(models, num_pages=32)
    eng.submit(np.asarray(list(range(1, 33)), np.int32))
    eng.step()
    with pytest.raises(RuntimeError, match="live-referenced"):
        eng.cache.save("/nonexistent/never-written")
    with pytest.raises(RuntimeError, match="orphan"):
        dec.load_pool_state(donor.pool_state())
    eng.run()
    with pytest.raises(RuntimeError, match="orphan"):
        dec.load_pool_state(donor.pool_state())
    dec2 = _decoder(models, num_pages=32)
    eng2 = ContinuousBatchingEngine(dec2, max_new_tokens=4)
    _serve(eng2, [[[3, 141, 59]]])
    state = donor.pool_state()
    state["k_pages"] = state["k_pages"].clone().fill_(1.5)
    dec2.load_pool_state(state)
    assert torch.equal(dec2.k_pages, state["k_pages"])
    assert dec2.k_pages.data_ptr() != state["k_pages"].data_ptr()
    with pytest.raises(ValueError, match="quant config"):
        dec2.load_pool_state({**state, "kv_quant": "int8"})
    assert dec2.adapter_salt(0) == b""
    with pytest.raises(NotImplementedError):
        dec2.adapter_salt(1)


def test_host_tier_options(models):
    """host_tier=False is "off", an EMPTY HostKVTier is "on", a tier
    needs a cache, and tier_policy is checked."""
    eng = ContinuousBatchingEngine(_decoder(models), prefix_cache=True,
                                   host_tier=False)
    assert eng.tier is None and eng.cache is not None
    ContinuousBatchingEngine(_decoder(models), host_tier=False)
    empty = HostKVTier()
    eng3 = ContinuousBatchingEngine(_decoder(models), prefix_cache=True,
                                    host_tier=empty)
    assert eng3.tier is empty and eng3.cache.tier is empty
    with pytest.raises(ValueError, match="needs a prefix_cache"):
        ContinuousBatchingEngine(_decoder(models), host_tier=True)
    with pytest.raises(ValueError, match="tier_policy"):
        ContinuousBatchingEngine(_decoder(models), prefix_cache=True,
                                 tier_policy="always")


def test_jax_and_port_snapshots_hold_the_same_pool_bytes(models, tmp_path):
    """The JAX engine and the port's serve the same prompt into the same
    pages; each package's save holds those pages under the same array
    names, shapes and dtypes (one persisted format), with values within
    1e-5 (f32 K/V of the two frameworks' matmuls, ~1e-6 apart)."""
    prompt = list(range(1, 33)) + [7]
    jd = JaxDecoder(models["jmodel"], num_pages=11, page_size=16,
                    max_batch=2)
    jeng = JaxEngine(jd, max_new_tokens=4, k_max=1,
                     prefix_cache=JaxPrefixCache(16))
    _, eng = _engine(models, max_new=4)
    assert _serve(eng, [[prompt]]) == _serve(jeng, [[prompt]])
    assert sorted(eng.cache.pages()) == sorted(jeng.cache.pages())
    jeng.cache.save(str(tmp_path / "jax"))
    eng.cache.save(str(tmp_path / "port"))
    metas = [json.load(open(tmp_path / pkg / "index.json"))["arrays"]
             for pkg in ("jax", "port")]
    assert metas[0] == metas[1]
    a = np.load(tmp_path / "jax" / "kv_pool.npz")
    b = np.load(tmp_path / "port" / "kv_pool.npz")
    assert sorted(a.files) == sorted(b.files) == sorted(metas[0])
    pages = sorted(eng.cache.pages())
    for name in a.files:
        x, y = (unpack_array(f[name], metas[0][name]) for f in (a, b))
        np.testing.assert_allclose(x[:, pages].numpy(), y[:, pages].numpy(),
                                   atol=1e-5, rtol=0)
