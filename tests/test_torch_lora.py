"""The port's multi-LoRA serving (`PagedGPTDecoder.attach_adapters`, the
per-token adapter ids of every decoder path, `ops.lora_delta`, the engine's
`submit(adapter=)`, adapter-salted prefix-cache keys and the page audit's
`slot_adapters` check) against the JAX package on `gpt_tiny` f32, the
weights of one JAX `GPT` carried across by `state_dict_from_numpy`.

The LoRA delta's plain version (the CPU path of `ops.lora_delta`) is held
against the JAX `_lora_delta` within f32 1e-6 (the two frameworks' f32
products sum in different orders); `make_lora_bank` gives JAX's arrays and
`attach_adapters` JAX's bank and `adapter_salt` bytes (mixed ranks, alpha);
mixed-adapter streams equal the JAX engines' on the per-tick,
dispatch-separate, packed ragged and dense ragged engines; k adapters in one
horizon equal k single-adapter engines; the salted cache never aliases
variants, a planted alias is caught by the port's audit; the speculative
engine refuses a bank; without a bank nothing launches.

Tolerance: f32 1e-6 for the delta; none for tokens, bytes and salts.
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
from paddle_tpu.serving import TenantEngine as JaxTenant
from paddle_tpu.serving import make_lora_bank as jax_bank
from paddle_tpu.serving.decoder import _lora_delta as jax_lora_delta
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.ops import lora_delta as lora
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      PagedGPTDecoder, PrefixCache,
                                      SpeculativeEngine, TenantEngine,
                                      make_lora_bank)
from paddle_tpu_torch.serving.page_audit import audit_page_ledger


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
    """One JAX gpt_tiny, the port's tensors of its weights, and a bank of
    3 rank-4 adapters."""
    paddle.seed(7)
    jmodel = GPT(jax_gpt_tiny(max_seq_len=128, dtype="float32",
                              remat=False))
    jmodel.eval()
    np_state = {k: np.asarray(v._value)
                for k, v in jmodel.state_dict().items()}
    cfg = gpt_tiny(max_seq_len=128, dtype="float32")
    return {"jmodel": jmodel, "cfg": cfg,
            "sd": state_dict_from_numpy(np_state, device="cpu"),
            "bank": make_lora_bank(cfg, 3, rank=4, seed=3)}


def _decoder(m, pkg="port", num_pages=32, max_batch=4, bank=True, **kw):
    if pkg == "jax":
        d = JaxDecoder(m["jmodel"], num_pages=num_pages, page_size=16,
                       max_batch=max_batch, **kw)
    else:
        d = PagedGPTDecoder(m["cfg"], m["sd"], num_pages=num_pages,
                            page_size=16, max_batch=max_batch, device="cpu",
                            **kw)
    if bank:
        d.attach_adapters(m["bank"])
    return d


def _mixed_bank(cfg, seed):
    """Adapters of ranks 2, 5 and 3 (zero-padded to 5 in the bank)."""
    rng = np.random.RandomState(seed)
    L, h, hd3 = cfg.num_layers, cfg.hidden_size, \
        3 * cfg.num_heads * cfg.head_dim
    return [(rng.randn(L, h, r).astype(np.float32) * 0.05,
             rng.randn(L, r, hd3).astype(np.float32) * 0.05)
            for r in (2, 5, 3)]


# ------------------------------------------------------------- the delta


@pytest.mark.parametrize("T", [1, 7, 64])
def test_lora_plain_equals_jax_lora_delta(models, T):
    """The plain version against the JAX `_lora_delta` on one layer of a
    mixed-rank bank with alpha, ids 0..3 (0 = the zero bank): f32 1e-6."""
    cfg = models["cfg"]
    d = PagedGPTDecoder(cfg, models["sd"], num_pages=4, page_size=16,
                        max_batch=1, device="cpu")
    d.attach_adapters(_mixed_bank(cfg, T), alpha=8.0)
    rng = np.random.RandomState(T)
    y = rng.randn(T, cfg.hidden_size).astype(np.float32)
    aids = rng.randint(0, 4, T).astype(np.int32)
    aids[0] = 0
    for layer in (0, cfg.num_layers - 1):
        A = d.lora["lora_A"][layer]
        B = d.lora["lora_B"][layer]
        want = np.asarray(jax_lora_delta(
            {"lora_A": A.numpy(), "lora_B": B.numpy()}, y, aids))
        got = lora._lora_delta_ref(torch.from_numpy(y), A, B,
                                   torch.from_numpy(aids)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert not got[aids == 0].any()          # the exact zero bank


def test_lora_delta_wrapper_on_the_cpu(models):
    """The wrapper adds in place at JAX's rounding points (the f32 delta
    cast to the compute dtype, then added), counts a plain launch, and
    leaves id-0 rows' values unchanged."""
    cfg = models["cfg"]
    bank = _mixed_bank(cfg, 1)
    d = PagedGPTDecoder(cfg, models["sd"], num_pages=4, page_size=16,
                        max_batch=1, device="cpu")
    d.attach_adapters(bank)
    A, B = d.lora["lora_A"][1], d.lora["lora_B"][1]
    rng = np.random.RandomState(0)
    T, N = 9, B.shape[-1]
    aids = torch.tensor([0, 1, 2, 3, 0, 3, 2, 1, 0], dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        y = torch.from_numpy(rng.randn(T, cfg.hidden_size).astype(
            np.float32)).to(dtype)
        qkv = torch.from_numpy(rng.randn(T, N).astype(np.float32)).to(dtype)
        before = qkv.clone()
        lora.reset_counts()
        out = lora.lora_delta_(qkv, y, A, B, aids)
        assert out is qkv and lora.plain_launches == 1 and \
            lora.kernel_launches == 0
        delta = lora._lora_delta_ref(y, A, B, aids)
        assert torch.equal(qkv, before + delta.to(dtype))
        assert torch.equal(qkv[aids == 0], before[aids == 0])


def test_make_lora_bank_and_salts_equal_jax(models):
    """`make_lora_bank` gives JAX's arrays; `attach_adapters` gives JAX's
    stacked bank and salt bytes (a permuted adapter with the same sums
    gets another salt, the same content the same salt), mixed ranks and
    alpha included; `cache_fingerprint` stays the base weights'."""
    cfg = models["cfg"]
    for got, want in zip(make_lora_bank(cfg, 3, rank=4, seed=3),
                         jax_bank(models["jmodel"].cfg, 3, rank=4, seed=3)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    mixed = _mixed_bank(cfg, 2)
    a, b = mixed[0]
    adapters = mixed + [(a[:, ::-1, :].copy(), b)]
    salts = {}
    for alpha in (None, 4.0):
        d = _decoder(models, bank=False, max_batch=1, num_pages=4)
        jd = _decoder(models, "jax", bank=False, max_batch=1, num_pages=4)
        base = d.cache_fingerprint()
        d.attach_adapters(adapters, alpha=alpha)
        jd.attach_adapters(adapters, alpha=alpha)
        assert d.n_adapters == jd.n_adapters == 4
        for part in ("lora_A", "lora_B"):
            assert np.array_equal(d.lora[part].numpy(),
                                  np.asarray(jd.lora[part]))
        assert [d.adapter_salt(i) for i in range(5)] == \
            [jd.adapter_salt(i) for i in range(5)]
        assert d.adapter_salt(0) == b"" and \
            d.adapter_salt(1) != d.adapter_salt(4)
        assert d.cache_fingerprint() == base
        salts[alpha] = d.adapter_salt(1)
    assert salts[None] != salts[4.0]
    d2 = _decoder(models, bank=False, max_batch=1, num_pages=4)
    d2.attach_adapters([(torch.from_numpy(a), torch.from_numpy(b))])
    assert d2.adapter_salt(1) == salts[None]


# --------------------------------------------------- decoder and engines


def test_no_bank_runs_no_adapter_launch(models):
    """aids on a decoder without a bank change nothing: no adapter launch,
    the same tokens."""
    d = _decoder(models, bank=False, max_batch=2)
    p = [[3, 141, 59, 26, 535], [7, 7, 1]]
    lora.reset_counts()
    eng = ContinuousBatchingEngine(d, max_new_tokens=6)
    rids = [eng.submit(q) for q in p]
    out = eng.run()
    assert lora.plain_launches == 0 and lora.kernel_launches == 0
    tbl = np.full((2, d.max_pages), d.num_pages - 1, np.int32)
    tbl[0, 0], tbl[1, 0] = 0, 1
    d.prefill_batch([(p[0], [0]), (p[1], [1])])
    a = d.decode([1, 2], [5, 3], tbl).tolist()
    b = d.decode([1, 2], [5, 3], tbl, aids=[2, 3]).tolist()
    assert a == b and lora.plain_launches == 0
    assert [len(out[r]) for r in rids] == [6, 6]


def test_adapter_ids_outside_the_bank_raise(models):
    d = _decoder(models, max_batch=2)
    tbl = np.full((2, d.max_pages), d.num_pages - 1, np.int32)
    with pytest.raises(ValueError, match="outside"):
        d.decode([1, 2], [0, 0], tbl, aids=[0, 4])
    eng = ContinuousBatchingEngine(d, max_new_tokens=4)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit([1, 2], adapter=4)
    nobank = ContinuousBatchingEngine(_decoder(models, bank=False),
                                      max_new_tokens=4)
    with pytest.raises(ValueError, match="no LoRA bank"):
        nobank.submit([1, 2], adapter=1)


ENGINES = {   # engine shape: (engine kwargs, decoder kwargs)
    "per_tick": (dict(k_max=1), {}),
    "dispatch_separate": (dict(k_max=4, ragged=False), {}),
    "packed": (dict(k_max=4), {}),
    "dense": (dict(k_max=4), dict(packed=False)),
}


@pytest.mark.parametrize("shape", sorted(ENGINES))
def test_mixed_adapter_streams_equal_jax(models, shape):
    """Requests over ids 0-3 with more requests than slots, a prefix-cache
    hit inside a variant and an EOS: the port's streams are the JAX
    engine's on every engine shape (so `decode`, `decode_multi`,
    `ragged_multi` in both layouts and both prefill layouts take aids), the
    adapter launches ran on the plain version, and the audit is clean."""
    eng_kw, dec_kw = ENGINES[shape]
    rng = np.random.RandomState(11)
    V = models["cfg"].vocab_size
    shared = list(rng.randint(0, V, 16))
    prompts = [shared + list(rng.randint(0, V, 3 + i)) for i in range(6)]
    aids = [1, 2, 0, 3, 1, 2]
    outs = {}
    for pkg in ("port", "jax"):
        d = _decoder(models, pkg, max_batch=2, **dec_kw)
        cache = (PrefixCache if pkg == "port" else JaxCache)(
            16, salt=d.cache_fingerprint())
        eng = (ContinuousBatchingEngine if pkg == "port" else JaxEngine)(
            d, max_new_tokens=7, eos_token_id=int(prompts[0][3]),
            prefix_cache=cache, **eng_kw)
        lora.reset_counts()
        rids = [eng.submit(np.asarray(p, np.int32), adapter=a)
                for p, a in zip(prompts, aids)]
        res = eng.run()
        outs[pkg] = [res[r] for r in rids]
        if pkg == "port":
            assert lora.plain_launches > 0 and lora.kernel_launches == 0
            assert eng.audit_pages() == []
            assert eng.stats.prefix_hits > 0
    assert outs["port"] == outs["jax"]


def test_multi_lora_bit_equal_to_single_adapter_engines(models):
    """k adapters in ONE horizon give outputs bit-equal to k separate
    single-adapter engines over the same bank, the bank-less engine
    equals adapter 0, the adapters give distinct streams, and the JAX
    TenantEngine's mixed run gives the same."""
    rng = np.random.RandomState(1)
    V = models["cfg"].vocab_size
    prompts = [list(rng.randint(0, V, 9 + 3 * i)) for i in range(4)]
    aids = [0, 1, 2, 3]
    single = {}
    for a, p in zip(aids, prompts):
        eng = ContinuousBatchingEngine(_decoder(models), max_new_tokens=8)
        rid = eng.submit(np.asarray(p, np.int32), adapter=a)
        single[a] = eng.run()[rid]
    assert len({tuple(v) for v in single.values()}) > 1
    base = ContinuousBatchingEngine(_decoder(models, bank=False),
                                    max_new_tokens=8)
    rid = base.submit(np.asarray(prompts[0], np.int32))
    assert base.run()[rid] == single[0]
    outs = {}
    for pkg, cls, cache in (("port", TenantEngine, PrefixCache),
                            ("jax", JaxTenant, JaxCache)):
        d = _decoder(models, pkg)
        eng = cls(d, max_new_tokens=8,
                  prefix_cache=cache(16, salt=d.cache_fingerprint()))
        rids = [eng.submit(np.asarray(p, np.int32), adapter=a,
                           tenant=f"t{a}") for a, p in zip(aids, prompts)]
        res = eng.run()
        outs[pkg] = [res[r] for r in rids]
        if pkg == "port":
            assert eng.audit_pages() == []
    assert outs["port"] == outs["jax"] == [single[a] for a in aids]


def test_bank_with_every_request_on_id_0_equals_no_bank(models):
    """A bank attached and every request on the base id: the same streams
    and the same pool bytes as the bank-less engine."""
    rng = np.random.RandomState(3)
    V = models["cfg"].vocab_size
    prompts = [list(rng.randint(0, V, 5 + 7 * i)) for i in range(5)]
    runs = []
    for bank in (False, True):
        d = _decoder(models, bank=bank, max_batch=2)
        eng = ContinuousBatchingEngine(d, max_new_tokens=6, k_max=4)
        rids = [eng.submit(p) for p in prompts]
        res = eng.run()
        runs.append(([res[r] for r in rids], d.k_pages.clone(),
                     d.v_pages.clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1]) and \
        torch.equal(runs[0][2], runs[1][2])


def test_adapter_salted_cache_never_aliases_variants(models):
    """The same prompt under two adapters MISSES across variants and hits
    within one; the ledger carries slot_adapters rows."""
    d = _decoder(models, max_batch=2)
    eng = ContinuousBatchingEngine(
        d, max_new_tokens=6,
        prefix_cache=PrefixCache(16, salt=d.cache_fingerprint()))
    prompt = list(np.random.RandomState(8).randint(
        0, models["cfg"].vocab_size, 20))
    ra = eng.submit(prompt, adapter=1)
    outa = eng.run()[ra]
    eng.submit(prompt, adapter=2)
    eng.run()
    assert eng.stats.prefix_hits == 0, "cross-variant prompt hit the cache"
    rc = eng.submit(prompt, adapter=1)
    seen = []
    eng.run(on_sync=lambda e: seen.append(e.page_ledger()["slot_adapters"]))
    assert eng.stats.prefix_hits > 0, "same-variant reuse broken"
    assert eng._outputs[rc] == outa
    rows = [r for led in seen for r in led.values()]
    assert rows and all(r == {"adapter": 1,
                              "salt": d.adapter_salt(1).hex()}
                        for r in rows)
    assert eng.audit_pages() == []


def test_adapter_alias_planted_defect_detected():
    """A ledger whose shared page is held by slots of DIFFERENT adapter
    salts is a finding; the same ledger with matching salts is clean."""
    ledger = {
        "num_pages": 4, "scratch": 3, "free": [1, 2],
        "slots": {0: [0], 1: [0]},
        "shared": {0: [0], 1: [0]},
        "cache": {0: {"refs": 2, "parked": False}},
        "slot_adapters": {0: {"adapter": 1, "salt": "aa"},
                          1: {"adapter": 2, "salt": "bb"}},
    }
    findings = audit_page_ledger(ledger)
    assert any("adapter fingerprints" in f.message for f in findings), \
        findings
    ledger["slot_adapters"][1] = {"adapter": 1, "salt": "aa"}
    assert audit_page_ledger(ledger) == []


def test_speculative_engine_refuses_lora(models):
    d = _decoder(models, max_batch=1, num_pages=16)
    draft = _decoder(models, bank=False, max_batch=1, num_pages=16)
    with pytest.raises(ValueError, match="LoRA"):
        SpeculativeEngine(d, draft)
    with pytest.raises(ValueError, match="LoRA"):
        SpeculativeEngine(draft, d)


def test_w4a16_tenant_engine_with_a_bank_equals_jax(models):
    """A TenantEngine over W4A16 weights (the w4 kernel's plain version on
    the CPU) with mixed adapters gives the JAX engine's streams."""
    rng = np.random.RandomState(21)
    V = models["cfg"].vocab_size
    prompts = [list(rng.randint(0, V, 6 + 5 * i)) for i in range(4)]
    outs = {}
    for pkg, cls in (("port", TenantEngine), ("jax", JaxTenant)):
        eng = cls(_decoder(models, pkg, max_batch=2, quant="w4a16"),
                  max_new_tokens=6, k_max=4)
        rids = [eng.submit(np.asarray(p, np.int32), adapter=i % 4,
                           tenant=f"t{i % 2}") for i, p in enumerate(prompts)]
        res = eng.run()
        outs[pkg] = [res[r] for r in rids]
    assert outs["port"] == outs["jax"]
