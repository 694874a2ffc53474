"""The port's multi-tenant serving (`paddle_tpu_torch.serving.tenancy`:
SLO classes, `TenantScheduler`, `TenantEngine` with preemption by
page-spill, `PrecisionRoutedEngine`, `summarize_tenancy`; the per-class
pricing of `cost_model`) against the JAX package's on `gpt_tiny` f32, the
weights of one JAX `GPT` carried across by `state_dict_from_numpy`.

Streams of the port's `TenantEngine` are equal to the JAX `TenantEngine`'s
on the same workload: greedy with a latency arrival that preempts, preempt
on/off under sampled decoding + EOS + int8 pools + the prefix cache on/off
+ the host tier (3 seeds, where each port run — single-tenant on a roomy
pool, tenant with preemption off, tenant on a tight pool with preemption
forced — equals the others and the JAX forced run), a request preempted
twice, preemption without a cache. `summarize_tenancy` equals JAX's on the
same ledgers, the scheduler's latency horizon and per-class targets equal
JAX's on the same chip numbers and host-sync price, and
`PrecisionRoutedEngine.class_capacity()` equals JAX's pool economics with
streams equal to single-precision engines. A preempting run's chrome
export groups request rows into one pid per tenant and passes the schema
check, and an untraced one records nothing.

Tolerance: none — tokens, counters, summaries and prices are equal.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import cost_model as jax_cost
from paddle_tpu.models import GPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import HostKVTier as JaxTier
from paddle_tpu.serving import PagedGPTDecoder as JaxDecoder
from paddle_tpu.serving import PrecisionRoutedEngine as JaxRouted
from paddle_tpu.serving import PrefixCache as JaxCache
from paddle_tpu.serving import TenantEngine as JaxTenant
from paddle_tpu.serving import TenantScheduler as JaxScheduler
from paddle_tpu.serving.tenancy import TenantStats as JaxStats
from paddle_tpu.serving.tenancy import summarize_tenancy as jax_summarize
from paddle_tpu_torch import cost_model, debug
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.serving import (SLO_LATENCY, SLO_THROUGHPUT,
                                      ContinuousBatchingEngine,
                                      FlightRecorder, HostKVTier,
                                      PagedGPTDecoder,
                                      PrecisionRoutedEngine, PrefixCache,
                                      TenantEngine, TenantScheduler,
                                      TenantStats, export_chrome_trace,
                                      summarize_tenancy,
                                      validate_chrome_trace)

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


# the two packages' classes under one set of names
PKGS = {
    "jax": dict(Engine=JaxEngine, Tenant=JaxTenant, Cache=JaxCache,
                Tier=JaxTier),
    "port": dict(Engine=ContinuousBatchingEngine, Tenant=TenantEngine,
                 Cache=PrefixCache, Tier=HostKVTier),
}


def _decoder(m, pkg, num_pages, max_batch=2, **kw):
    if pkg == "jax":
        return JaxDecoder(m["jmodel"], num_pages=num_pages, page_size=16,
                          max_batch=max_batch, **kw)
    return PagedGPTDecoder(m["cfg"], m["sd"], num_pages=num_pages,
                           page_size=16, max_batch=max_batch, device="cpu",
                           **kw)


def _run_preempting(m, pkg, dec_kw=None, cache=True, tier=False,
                    num_pages=7, max_new=12, eos=None, tp_prompts=(),
                    lat_prompts=(), arrive_at=(), trace=None):
    """A TenantEngine of `pkg` through a preemption-forcing workload (the
    JAX test's): a throughput flood up front, latency arrivals at token
    thresholds. Returns (engine, {rid: out})."""
    ns = PKGS[pkg]
    dec = _decoder(m, pkg, num_pages, **(dec_kw or {}))
    pc = None
    if cache:
        pc = ns["Cache"](16, salt=dec.cache_fingerprint(),
                         tier=ns["Tier"]() if tier else None)
    eng = ns["Tenant"](dec, max_new_tokens=max_new, prefix_cache=pc,
                       eos_token_id=eos, trace=trace,
                       tier_policy="restore" if tier else "auto")
    for i, p in enumerate(tp_prompts):
        eng.submit(np.asarray(p, np.int32), tenant=f"b{i % 2}",
                   slo=SLO_THROUGHPUT)
    state = {"n": 0}

    def on_sync(e):
        while state["n"] < len(lat_prompts) and \
                e.stats.tokens >= arrive_at[state["n"]]:
            e.submit(np.asarray(lat_prompts[state["n"]], np.int32),
                     tenant="chat", slo=SLO_LATENCY)
            state["n"] += 1

    outs = eng.run(on_sync=on_sync)
    assert state["n"] == len(lat_prompts), "arrivals never fired"
    return eng, outs


def _prompts(rng, V, n, lo, hi=None):
    return [list(rng.randint(0, V, lo if hi is None
                             else int(rng.randint(lo, hi))).astype(int))
            for _ in range(n)]


# ------------------------------------------------------------------ basics


def test_tenant_engine_matches_jax_and_summary(models):
    """One latency request: the JAX TenantEngine's tokens, and the same
    summary skeleton (tenant rows, a positive latency target, 0
    preemptions, 1 <= k_latency <= k_max)."""
    p = [3, 141, 59, 26, 535]
    outs = {}
    for pkg in PKGS:
        eng = PKGS[pkg]["Tenant"](_decoder(models, pkg, 32),
                                  max_new_tokens=8)
        rid = eng.submit(np.asarray(p, np.int32), tenant="a",
                         slo=SLO_LATENCY)
        outs[pkg] = eng.run()[rid]
        summ = eng.tenancy_summary()
        row = summ["tenants"][0]
        assert (row["tenant"], row["completed"], row["tokens"]) == \
            ("a", 1, 8)
        assert summ["classes"][SLO_LATENCY]["roofline_target_ms"] > 0
        assert summ["preemptions"] == 0
        assert 1 <= eng.scheduler.k_latency <= eng.scheduler.k_max
        if pkg == "port":
            # the report front door carries the tenant engine's summary
            entry = [e for e in debug.serving_report()
                     if e["stats"]["engine_id"] == eng.stats.engine_id]
            assert entry[0]["tenancy"] == summ
    assert outs["port"] == outs["jax"]


def test_submit_rejects_unknown_slo_and_adapter(models):
    eng = TenantEngine(_decoder(models, "port", 16, max_batch=1),
                       max_new_tokens=4)
    with pytest.raises(ValueError, match="slo"):
        eng.submit(np.asarray([1, 2], np.int32), slo="gold")
    with pytest.raises(ValueError, match="adapter"):
        eng.submit(np.asarray([1, 2], np.int32), adapter=1)
    assert eng.stats.requests == 0


def test_latency_requests_queue_ahead_of_backlog(models):
    eng = TenantEngine(_decoder(models, "port", 16, max_batch=1),
                       max_new_tokens=4, preemption=False)
    r_tp = [eng.submit(np.asarray([5, 6, 7], np.int32), tenant="b",
                       slo=SLO_THROUGHPUT) for _ in range(3)]
    r_lat = [eng.submit(np.asarray([8, 9], np.int32), tenant="c",
                        slo=SLO_LATENCY) for _ in range(2)]
    # latency requests jump the throughput backlog, FIFO among themselves
    assert [r for r, _ in eng._queue] == r_lat + r_tp


# --------------------------------------------- preemption by page-spill


def test_preempted_stream_matches_jax(models):
    """Greedy: a preempted-and-resumed victim's stream equals the JAX
    engine's (which equals its never-preempted twin), preemption happened,
    the ledger audits clean and every page is reclaimed."""
    rng = np.random.RandomState(0)
    V = models["cfg"].vocab_size
    tp, lat = _prompts(rng, V, 3, 20), _prompts(rng, V, 1, 36)
    kw = dict(tp_prompts=tp, lat_prompts=lat, arrive_at=[4])
    eng, outs = _run_preempting(models, "port", **kw)
    jeng, jouts = _run_preempting(models, "jax", **kw)
    assert eng.stats.preemptions >= 1 and eng.stats.resumes >= 1
    assert (eng.stats.preemptions, eng.stats.resumes) == \
        (jeng.stats.preemptions, jeng.stats.resumes)
    for rid in range(len(tp) + len(lat)):
        assert outs[rid] == jouts[rid], rid
    assert eng.audit_pages() == []
    assert len(eng._free) + eng.cache.n_parked == eng.d.num_pages - 1
    summ = eng.tenancy_summary()
    assert summ["preemptions"] == eng.stats.preemptions
    assert any(t.get("preemptions") for t in summ["tenants"])
    assert 0 < summ["fairness_jain"] <= 1.0


@pytest.mark.parametrize("seed", range(3))
def test_streams_byte_identical_preempt_on_off(models, seed):
    """The JAX acceptance bar in the port: one randomized workload
    (sampled, an EOS, int8 pools on seed 2, the prefix cache on seeds 0 and
    2, the host tier on seed 0) through (a) the single-tenant engine on a
    roomy pool, (b) the TenantEngine with preemption off and (c) the
    TenantEngine on a tight pool with preemption forced by mid-stream
    latency arrivals — every stream equal across the three, and equal to
    the JAX TenantEngine's forced run."""
    rng = np.random.RandomState(900 + seed)
    V = models["cfg"].vocab_size
    dec_kw = dict(SAMPLING)
    if seed == 2:
        dec_kw["kv_quant"] = "int8"
    cache = seed != 1
    eos = int(rng.randint(0, V))
    max_new = int(rng.randint(10, 14))
    tp = _prompts(rng, V, 4, 17, 24)
    lat = _prompts(rng, V, 2, 33, 40)
    arrive = [3, 9]

    def roomy(tenant, preemption=None):
        dec = _decoder(models, "port", 32, **dec_kw)
        pc = PrefixCache(16, salt=dec.cache_fingerprint()) if cache else None
        if tenant:
            eng = TenantEngine(dec, max_new_tokens=max_new, eos_token_id=eos,
                               prefix_cache=pc, preemption=preemption)
        else:
            eng = ContinuousBatchingEngine(dec, max_new_tokens=max_new,
                                           eos_token_id=eos,
                                           prefix_cache=pc)
        kw = (lambda i: dict(tenant=f"b{i % 2}", slo=SLO_THROUGHPUT)) \
            if tenant else (lambda i: {})
        for i, p in enumerate(tp):
            eng.submit(np.asarray(p, np.int32), **kw(i))
        state = {"n": 0}

        def on_sync(e):
            while state["n"] < len(lat) and \
                    e.stats.tokens >= arrive[state["n"]]:
                e.submit(np.asarray(lat[state["n"]], np.int32),
                         **(dict(tenant="chat", slo=SLO_LATENCY)
                            if tenant else {}))
                state["n"] += 1
        out = eng.run(on_sync=on_sync)
        assert state["n"] == len(lat)
        return eng, out

    _, ref = roomy(False)
    off, off_outs = roomy(True, preemption=False)
    assert off.stats.preemptions == 0
    kw = dict(dec_kw=dec_kw, cache=cache, tier=seed == 0, max_new=max_new,
              eos=eos, tp_prompts=tp, lat_prompts=lat, arrive_at=arrive)
    eng, on = _run_preempting(models, "port", **kw)
    _, jon = _run_preempting(models, "jax", **kw)
    assert eng.stats.preemptions >= 1, (seed, "never preempted")
    rids = range(len(tp) + len(lat))
    assert [on[r] for r in rids] == [ref[r] for r in rids] == \
        [off_outs[r] for r in rids] == [jon[r] for r in rids], seed
    assert eng.audit_pages() == []


def test_double_preemption_stays_byte_identical(models):
    """A request preempted TWICE still matches the JAX engine's stream:
    the resume prompt is the ORIGINAL prompt + cumulative outputs each
    time."""
    rng = np.random.RandomState(6)
    V = models["cfg"].vocab_size
    tp, lat = _prompts(rng, V, 2, 20), _prompts(rng, V, 2, 36)
    kw = dict(tp_prompts=tp, lat_prompts=lat, max_new=16,
              arrive_at=[3, 40])
    eng, outs = _run_preempting(models, "port", **kw)
    _, jouts = _run_preempting(models, "jax", **kw)
    assert eng.stats.preemptions >= 3, "workload did not double-preempt"
    per_tenant = {t["tenant"]: t.get("preemptions", 0)
                  for t in eng.tenancy_summary()["tenants"]}
    assert max(per_tenant.values()) >= 2, per_tenant
    for rid in range(len(tp) + len(lat)):
        assert outs[rid] == jouts[rid], rid
    assert eng.audit_pages() == []


def test_preemption_without_cache_recomputes(models):
    """A cache-less TenantEngine preempts by FREEING the victim's pages;
    resume re-prefills the consumed prefix — the JAX engine's streams, and
    every page back on the free list."""
    rng = np.random.RandomState(4)
    V = models["cfg"].vocab_size
    tp, lat = _prompts(rng, V, 2, 20), _prompts(rng, V, 1, 36)
    kw = dict(cache=False, tp_prompts=tp, lat_prompts=lat, arrive_at=[3])
    eng, outs = _run_preempting(models, "port", **kw)
    _, jouts = _run_preempting(models, "jax", **kw)
    assert eng.stats.preemptions >= 1
    assert all(outs[r] == jouts[r] for r in range(len(tp) + len(lat)))
    assert len(eng._free) == eng.d.num_pages - 1


# ------------------------------------------------------ summary, pricing


def _ledgers(stats_cls, seed):
    """The same per-tenant ledgers in either package's TenantStats."""
    rng = np.random.RandomState(seed)
    out = {}
    for tenant, slo in (("a", SLO_LATENCY), ("b", SLO_THROUGHPUT),
                        ("a", SLO_THROUGHPUT), ("idle", SLO_LATENCY)):
        ts = stats_cls(tenant=tenant, slo=slo)
        if tenant != "idle":
            ts.requests = int(rng.randint(1, 9))
            ts.completed = ts.requests - 1
            ts.tokens = int(rng.randint(0, 500))
            ts.preemptions = int(rng.randint(0, 3))
            ts.resumes = ts.preemptions
            ts.queue_wait_s.extend(rng.rand(7).tolist())
            ts.ttft_s.extend(rng.rand(5).tolist())
            ts.occupancy.extend(rng.rand(4).tolist())
        out[(tenant, slo)] = ts
    return out


@pytest.mark.parametrize("seed", range(3))
def test_summarize_tenancy_equals_jax(seed):
    targets = {SLO_LATENCY: 0.0123, SLO_THROUGHPUT: 0.0456}
    for tg in (None, targets):
        assert summarize_tenancy(_ledgers(TenantStats, seed),
                                 slo_targets_s=tg, preemptions=3,
                                 resumes=2) == \
            jax_summarize(_ledgers(JaxStats, seed), slo_targets_s=tg,
                          preemptions=3, resumes=2)
    assert summarize_tenancy({}) == jax_summarize({})


def test_slo_pricing_and_scheduler_equal_jax(models):
    """`slo_horizon` / `slo_p99_target_s` equal the JAX formulas on the
    same chip numbers, and a TenantScheduler built on them has JAX's
    k_latency, chunk budget, k_max and per-class targets."""
    jchip = jax_cost.chip_spec("v5e")
    chip = cost_model.ChipSpec("v5e", jchip.peak_flops, jchip.hbm_bw,
                               jchip.hbm_bytes, host_bw=jchip.host_bw,
                               host_read_bw=jchip.host_read_bw)
    for hbm in (1e6, 3.3e9):
        for slo in (SLO_LATENCY, SLO_THROUGHPUT):
            for kw in (dict(), dict(chunk_tokens=64, flops_per_token=2e9)):
                for sync in (1e-4, 4e-3):
                    assert cost_model.slo_horizon(
                        hbm, slo, host_sync_s=sync, chip=chip, **kw) == \
                        jax_cost.slo_horizon(hbm, slo, host_sync_s=sync,
                                             chip=jchip, **kw)
                    assert cost_model.slo_p99_target_s(
                        hbm, slo, host_sync_s=sync, chip=chip, **kw) == \
                        jax_cost.slo_p99_target_s(
                            hbm, slo, host_sync_s=sync, chip=jchip, **kw)
    with pytest.raises(ValueError, match="SLO"):
        cost_model.slo_horizon(1e6, "gold", host_sync_s=1e-4)
    for sync in (2e-5, 4e-4):
        port = TenantScheduler(_decoder(models, "port", 16), chip=chip,
                               host_sync_s=sync)
        jax = JaxScheduler(_decoder(models, "jax", 16), chip=jchip,
                           host_sync_s=sync)
        assert (port.k_latency, port.k_max, port.chunk_tokens) == \
            (jax.k_latency, jax.k_max, jax.chunk_tokens)
        assert port.slo_targets_s == jax.slo_targets_s


# ------------------------------------------------------------ flight recorder


def test_trace_groups_by_tenant_and_validates_preemption(models, tmp_path):
    """A preempting run's chrome export: request rows in one pid per
    tenant, preempt/resume instants inside their request's span, the
    schema check passes — and a planted out-of-span preempt instant is
    flagged."""
    rng = np.random.RandomState(2)
    V = models["cfg"].vocab_size
    rec = FlightRecorder()
    eng, _ = _run_preempting(models, "port", tp_prompts=_prompts(rng, V, 3,
                                                                 20),
                             lat_prompts=_prompts(rng, V, 1, 36),
                             arrive_at=[4], trace=rec)
    assert eng.stats.preemptions >= 1
    kinds = {ev["kind"] for ev in rec.events}
    assert "preempt" in kinds and "resume" in kinds
    path = export_chrome_trace(str(tmp_path / "mt.json"), rec)
    assert validate_chrome_trace(path) == []
    with open(path) as f:
        data = json.load(f)
    pid_of = {}
    for e in data["traceEvents"]:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            for t in ("b0", "b1", "chat"):
                if f"tenant={t}" in e["args"]["name"]:
                    pid_of[t] = e["pid"]
    assert len(set(pid_of.values())) == 3, pid_of
    for e in data["traceEvents"]:
        if str(e.get("name", "")).endswith(":preempt"):
            e["ts"] = 0.0
            break
    assert any("preemption instant" in p
               for p in validate_chrome_trace(data))


def test_tenancy_tracing_off_is_dead_branch(models):
    before = FlightRecorder.total_events
    rng = np.random.RandomState(5)
    V = models["cfg"].vocab_size
    eng, _ = _run_preempting(models, "port",
                             tp_prompts=_prompts(rng, V, 2, 20),
                             lat_prompts=_prompts(rng, V, 1, 36),
                             arrive_at=[3])
    assert eng.stats.preemptions >= 1
    assert FlightRecorder.total_events == before


# ------------------------------------------------ per-class KV precision


def test_precision_routed_engine_equals_jax(models):
    """latency=int8 / throughput=int4: separate pools keyed on different
    fingerprints, class_capacity's pool economics equal to JAX's (and its
    k_latency / targets those of each class's own scheduler), global rids,
    streams equal to the JAX routed engine's and to single-precision
    TenantEngines given the same rids."""
    prec = {SLO_LATENCY: "int8", SLO_THROUGHPUT: "int4"}
    kw = dict(kv_precision=prec, max_new_tokens=6, num_pages=16,
              max_batch=2)
    eng = PrecisionRoutedEngine(models["cfg"], models["sd"],
                                dec_kw=dict(SAMPLING, device="cpu"), **kw)
    jeng = JaxRouted(models["jmodel"], dec_kw=dict(SAMPLING), **kw)
    dlat, dthr = eng.decoders[SLO_LATENCY], eng.decoders[SLO_THROUGHPUT]
    assert (dlat.kv_quant, dthr.kv_quant) == ("int8", "int4")
    assert dlat.k_pages[0] is not dthr.k_pages[0]
    assert dlat.cache_fingerprint() != dthr.cache_fingerprint()
    assert eng.engines[SLO_LATENCY].cache.salt != \
        eng.engines[SLO_THROUGHPUT].cache.salt
    cap, jcap = eng.class_capacity(), jeng.class_capacity()
    for slo in (SLO_LATENCY, SLO_THROUGHPUT):
        for k in ("kv_quant", "kv_token_bytes", "step_hbm_bytes",
                  "pool_tokens"):
            assert cap[slo][k] == jcap[slo][k], (slo, k)
        sched = eng.engines[slo].scheduler
        assert cap[slo]["k_latency"] == sched.k_latency
        assert cap[slo]["slo_target_s"] == sched.slo_targets_s[slo] > 0
    assert cap[SLO_THROUGHPUT]["step_hbm_bytes"] < \
        cap[SLO_LATENCY]["step_hbm_bytes"]

    rng = np.random.RandomState(31)
    V = models["cfg"].vocab_size
    prompts = _prompts(rng, V, 4, 12)
    slos = [SLO_LATENCY, SLO_THROUGHPUT, SLO_THROUGHPUT, SLO_LATENCY]
    rids = [eng.submit(np.asarray(p, np.int32), slo=s)
            for p, s in zip(prompts, slos)]
    jrids = [jeng.submit(np.asarray(p, np.int32), slo=s)
             for p, s in zip(prompts, slos)]
    assert rids == jrids == [0, 1, 2, 3]
    outs, jouts = eng.run(), jeng.run()
    assert outs == jouts
    for quant, idxs in (("int8", (0, 3)), ("int4", (1, 2))):
        dec = _decoder(models, "port", 16, kv_quant=quant, **SAMPLING)
        twin = TenantEngine(dec, max_new_tokens=6, prefix_cache=PrefixCache(
            16, salt=dec.cache_fingerprint()))
        for i in idxs:
            twin._next_id = rids[i]
            assert twin.submit(np.asarray(prompts[i], np.int32),
                               slo=slos[i]) == rids[i]
        twin_outs = twin.run()
        for i in idxs:
            assert twin_outs[rids[i]] == outs[rids[i]], (quant, i)
    summ = eng.tenancy_summary()
    for slo in (SLO_LATENCY, SLO_THROUGHPUT):
        assert summ["classes"][slo]["roofline_target_ms"] > 0


def test_precision_routed_engine_shared_and_invalid(models):
    eng = PrecisionRoutedEngine(
        models["cfg"], models["sd"],
        kv_precision={SLO_LATENCY: "int4", SLO_THROUGHPUT: "int4"},
        max_new_tokens=4, num_pages=16, dec_kw=dict(device="cpu"))
    assert eng.engines[SLO_LATENCY] is eng.engines[SLO_THROUGHPUT]
    r0 = eng.submit(np.asarray([3, 141, 59], np.int32), slo=SLO_LATENCY)
    r1 = eng.submit(np.asarray([5, 9, 2], np.int32), slo=SLO_THROUGHPUT)
    assert set(eng.run()) == {r0, r1}
    with pytest.raises(ValueError, match="kv_precision"):
        PrecisionRoutedEngine(models["cfg"], models["sd"],
                              kv_precision={"gold": None},
                              dec_kw=dict(device="cpu"))
    with pytest.raises(ValueError, match="slo"):
        eng.submit(np.asarray([1, 2], np.int32), slo="gold")
