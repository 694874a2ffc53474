"""The port's flight recorder (`paddle_tpu_torch.serving.trace`, the
engines' trace hooks, `debug.serving_report`) against the JAX package's
on `gpt_tiny` f32, the weights of one JAX `GPT` carried across by
`state_dict_from_numpy`: traced streams byte-identical to untraced ones
(and to the JAX engine's) under churn, tracing off leaving zero events,
lifecycle spans, prefix-mount and host-tier records, priced tick records,
the drift ledger's exclusions, the report front door and a chrome export
that passes the schema check. The recorder itself is held against the
JAX recorder on identical events: equal `summary()`, `drift_report()`
and `chrome_events()`. Engine records are compared with the JAX
engine's by kind, request id and shape, not by price: the port's
predictions price an H100 (`cost_model`), and the measured times are
wall clocks.

Tolerance: none — streams, records and recorder outputs are equal.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import HostKVTier as JaxTier
from paddle_tpu.serving import PagedGPTDecoder as JaxDecoder
from paddle_tpu.serving import PrefixCache as JaxCache
from paddle_tpu.serving.trace import FlightRecorder as JaxRecorder
from paddle_tpu.serving.trace import \
    validate_chrome_trace as jax_validate
from paddle_tpu_torch import debug
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      FlightRecorder, HostKVTier,
                                      PagedGPTDecoder, PrefixCache,
                                      SpeculativeEngine,
                                      export_chrome_trace,
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


def _decoder(m, num_pages=48, **kw):
    return PagedGPTDecoder(m["cfg"], m["sd"], num_pages=num_pages,
                           page_size=16, max_batch=2, device="cpu", **kw)


def _serve(eng, waves):
    rids, res = [], {}
    for wave in waves:
        rids += [eng.submit(np.asarray(p, np.int32)) for p in wave]
        res = eng.run()
    return [res[r] for r in rids]


def _stream(m, prompts, max_new, eos=None, dec_kw=None, **eng_kw):
    eng = ContinuousBatchingEngine(_decoder(m, **(dec_kw or {})),
                                   eos_token_id=eos, max_new_tokens=max_new,
                                   **eng_kw)
    out = _serve(eng, [prompts])
    assert len(eng._free) == eng.d.num_pages - 1, "page leak"
    return out, eng


def _jax_stream(m, prompts, max_new, eos=None, dec_kw=None, **eng_kw):
    dec = JaxDecoder(m["jmodel"], num_pages=48, page_size=16, max_batch=2,
                     **(dec_kw or {}))
    eng = JaxEngine(dec, eos_token_id=eos, max_new_tokens=max_new, **eng_kw)
    return _serve(eng, [prompts]), eng


def _records(rec):
    """An engine's records by kind, request id, shape and the fields
    that follow from the schedule (never prices or wall times)."""
    keep = ("rid", "slot", "prompt_tokens", "cached_tokens", "hit_blocks",
            "tokens", "k", "w", "decode_rows", "prefill_rows",
            "tokens_dispatched", "tokens_padded", "pool", "page", "blocks")
    return [(ev["kind"], tuple(ev.get("shape") or ()),
             {k: ev[k] for k in keep if k in ev}) for ev in rec.events]


# ------------------------------------------------------------------ streams


@pytest.mark.parametrize("seed", range(2))
def test_traced_streams_byte_identical_under_churn(models, seed):
    """Sampled decoding, an EOS and chunked prompts, more requests than
    slots: the ragged and the dispatch-separate engines give the untraced
    per-tick engine's streams with tracing ON (the recorder reads only
    host values the engine already fetched), and those are the JAX
    engine's."""
    rng = np.random.RandomState(400 + seed)
    V = models["cfg"].vocab_size
    prompts = [list(rng.randint(0, V, rng.randint(1, 40)).astype(int))
               for _ in range(4)]
    eos = int(rng.randint(0, V))
    max_new = int(rng.randint(3, 14))
    base, _ = _stream(models, prompts, max_new, eos, SAMPLING, k_max=1)
    want, _ = _jax_stream(models, prompts, max_new, eos, SAMPLING, k_max=1)
    assert base == want
    blocking, eb = _stream(models, prompts, max_new, eos, SAMPLING,
                           k_max=4, ragged=False, trace=FlightRecorder())
    ragged, er = _stream(models, prompts, max_new, eos, SAMPLING, k_max=4,
                         chunk_tokens=8, trace=FlightRecorder())
    assert blocking == base and ragged == base
    for eng in (eb, er):
        kinds = {ev["kind"] for ev in eng.trace.events}
        assert {"submit", "admit", "first_token", "retire", "tick"} <= kinds


def test_tracing_off_is_dead_branch(models):
    """With tracing off no record() runs anywhere in a full drain: the
    class-wide event counter is unchanged by the ragged, per-tick,
    dispatch-separate and speculative engines."""
    before = FlightRecorder.total_events
    _, eng = _stream(models, [[3, 141, 59], list(range(1, 30))], 8,
                     k_max=4, chunk_tokens=8)
    assert eng.trace is None
    _stream(models, [[3, 141, 59]], 4, k_max=1)
    _stream(models, [[3, 141, 59]], 4, k_max=4, ragged=False)
    spec = SpeculativeEngine(_decoder(models), _decoder(models),
                             max_new_tokens=4, k=3)
    _serve(spec, [[[3, 141, 59]]])
    assert FlightRecorder.total_events == before


# ------------------------------------------------------- lifecycle records


def test_request_spans_cover_lifecycle(models):
    """Every request's span hits the milestones in causal order, with
    progress marks every progress_every tokens; no token value is
    recorded."""
    rec = FlightRecorder(progress_every=4)
    prompts = [list(range(1, 30)), [5, 6, 7]]
    _stream(models, prompts, 9, k_max=4, chunk_tokens=8, trace=rec)
    by_rid = {}
    for ev in rec.events:
        if "rid" in ev:
            by_rid.setdefault(ev["rid"], []).append(ev)
    assert sorted(by_rid) == [0, 1]
    for rid, evs in by_rid.items():
        marks = {ev["kind"]: ev for ev in evs}
        for kind in ("submit", "admit", "first_token", "retire"):
            assert kind in marks, (rid, sorted(marks))
        assert (marks["submit"]["ts"] <= marks["admit"]["ts"]
                <= marks["first_token"]["ts"] <= marks["retire"]["ts"])
        assert marks["submit"]["prompt_tokens"] == len(prompts[rid])
        assert marks["admit"]["slot"] in (0, 1)
        assert marks["retire"]["tokens"] == 9
        assert [ev["tokens"] for ev in evs
                if ev["kind"] == "progress"] == [4, 8]
    assert not any(k in ("token", "ids") for ev in rec.events for k in ev)


def test_admit_records_prefix_cache_mount(models):
    """A repeat prompt's admit event carries the mount detail (cached
    span, hit blocks), and the records equal the JAX engine's."""
    prompt = list(range(1, 37))              # 2 full blocks + tail
    recs = []
    for jax in (False, True):
        if jax:
            dec = JaxDecoder(models["jmodel"], num_pages=48, page_size=16,
                             max_batch=2)
            eng = JaxEngine(dec, max_new_tokens=4, k_max=4, chunk_tokens=8,
                            prefix_cache=JaxCache(
                                16, salt=dec.cache_fingerprint()),
                            trace=JaxRecorder())
        else:
            dec = _decoder(models)
            eng = ContinuousBatchingEngine(
                dec, max_new_tokens=4, k_max=4, chunk_tokens=8,
                prefix_cache=PrefixCache(16, salt=dec.cache_fingerprint()),
                trace=FlightRecorder())
        _serve(eng, [[prompt], [prompt + [9, 9]]])
        recs.append(_records(eng.trace))
    admits = [r for kind, _, r in recs[0] if kind == "admit"]
    assert admits[0]["cached_tokens"] == 0
    assert admits[1]["cached_tokens"] == 32 and admits[1]["hit_blocks"] == 2
    assert recs[0] == recs[1]


def test_tier_spill_and_restore_records(models):
    """The host tier's records: a "spill" event a page demoted, and an
    ("h2d_restore",) tick a restored span whose predicted H2D is
    `kv_restore_s` of its bytes; the kinds, ids, pages and shapes equal
    the JAX engine's on the same waves."""
    from paddle_tpu_torch.cost_model import kv_restore_s
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(0, 1024, 33).astype(int)) for _ in range(5)]
    waves = [[p] for p in prompts] + [[p] for p in prompts[:2]]
    recs = []
    for jax in (False, True):
        if jax:
            dec = JaxDecoder(models["jmodel"], num_pages=11, page_size=16,
                             max_batch=2)
            cache = JaxCache(16, salt=dec.cache_fingerprint(),
                             tier=JaxTier())
            eng = JaxEngine(dec, max_new_tokens=6, k_max=1,
                            prefix_cache=cache, tier_policy="restore",
                            trace=JaxRecorder())
        else:
            dec = _decoder(models, num_pages=11)
            cache = PrefixCache(16, salt=dec.cache_fingerprint(),
                                tier=HostKVTier())
            eng = ContinuousBatchingEngine(
                dec, max_new_tokens=6, k_max=1, prefix_cache=cache,
                tier_policy="restore", trace=FlightRecorder())
        _serve(eng, waves)
        recs.append(_records(eng.trace))
        if not jax:
            restores = [ev for ev in eng.trace.events
                        if ev.get("shape") == ["h2d_restore"]]
            assert restores and eng.stats.tier_restores > 0
            for ev in restores:
                assert ev["predicted_s"] == kv_restore_s(ev["bytes"]) > 0
                assert ev["measured_s"] > 0
            assert any(ev["kind"] == "spill" for ev in eng.trace.events)
    assert recs[0] == recs[1]


# ---------------------------------------------------- ticks and the ledger


@pytest.mark.parametrize("eng_kw", [
    dict(k_max=4, chunk_tokens=8), dict(k_max=4, chunk_tokens=8,
                                        packed=False),
    dict(k_max=4, ragged=False), dict(k_max=1)],
    ids=["packed", "dense", "dispatch_separate", "per_tick"])
def test_tick_records_price_and_measure(models, eng_kw):
    """Every dispatched horizon leaves one tick record with its row
    composition, a positive priced prediction where the window is clean,
    the measured wall seconds and the pool fold; the drift windows hold
    only recorded shapes; the records equal the JAX engine's."""
    prompts = [list(range(1, 30)), [3, 4, 5]]
    rec = FlightRecorder()
    _, eng = _stream(models, prompts, 24, trace=rec, **eng_kw)
    _, jeng = _jax_stream(models, prompts, 24, trace=JaxRecorder(),
                          **eng_kw)
    assert _records(rec) == _records(jeng.trace)
    ticks = [ev for ev in rec.events if ev["kind"] == "tick"]
    assert ticks
    shape0 = ("tick" if eng_kw["k_max"] == 1 else
              "decode" if eng_kw.get("ragged") is False else
              "ragged" if eng_kw.get("packed") is False else "packed")
    for ev in ticks:
        assert ev["track"] == "serve" and ev["shape"][0] == shape0
        assert ev["tokens_dispatched"] >= ev["tokens_padded"] >= 0
        assert ev["measured_s"] > 0
        assert ev["predicted_s"] is None or ev["predicted_s"] > 0
        assert ev["k"] >= 1 and ev["w"] >= 1
        assert ev["decode_rows"] + ev["prefill_rows"] >= 1
        assert "cow" in ev["pool"] and "evictions" in ev["pool"]
    drift = rec.drift_report()
    assert drift and all(d["n"] >= 1 and d["ratio"] > 0 for d in drift)
    assert {tuple(d["shape"]) for d in drift} <= \
        {tuple(ev["shape"]) for ev in ticks}
    s = rec.summary()
    assert s["events"] == len(rec.events)
    assert s["kinds"]["tick"] == len(ticks)
    assert s["meta"]["engine"] == "ContinuousBatchingEngine"
    assert s["meta"] == jeng.trace.summary()["meta"]


def test_drift_ledger_excludes_prefill_polluted_blocks(models):
    """On the dispatch-separate loop a horizon whose measured window held
    a blocking prefill stays out of the drift ledger."""
    rec = FlightRecorder()
    _, eng = _stream(models, [[3, 141, 59], [7, 8, 9, 10]], 12, k_max=4,
                     ragged=False, trace=rec)
    ticks = [ev for ev in rec.events if ev["kind"] == "tick"]
    assert ticks and all(ev["shape"][0] == "decode" for ev in ticks)
    assert eng.stats.prefill_syncs > 0
    assert sum(d["n"] for d in rec.drift_report()) < len(ticks)


def test_speculative_engine_traces_lifecycle_and_ticks(models):
    """SpeculativeEngine(trace=...) records the lifecycle and a tick a
    spec step, each priced above a plain decode tick (k draft ticks, a
    (k+1)-wide verify and two syncs)."""
    rec = FlightRecorder()
    eng = SpeculativeEngine(_decoder(models), _decoder(models),
                            max_new_tokens=8, k=3, trace=rec)
    assert len(_serve(eng, [[[3, 141, 59]]])[0]) == 8
    kinds = {ev["kind"] for ev in rec.events}
    assert {"submit", "admit", "first_token", "retire", "tick"} <= kinds
    ticks = [ev for ev in rec.events if ev["kind"] == "tick"]
    assert ticks and all(ev["measured_s"] > 0 for ev in ticks)
    assert rec.meta["engine"] == "SpeculativeEngine"
    plain = ContinuousBatchingEngine(_decoder(models), max_new_tokens=4,
                                     k_max=1, trace=FlightRecorder())
    assert all(ev["predicted_s"] > plain._price_horizon(1, 1, 0)
               for ev in ticks if ev["predicted_s"])


def test_serving_report_front_door(models):
    """debug.serving_report(): stats, schedule summary, drift and the pad
    ledger per live engine, deterministically ordered, drifting shapes
    flagged (a drift factor of 1 flags every shape)."""
    rec = FlightRecorder(drift_factor=1.0 + 1e-9)
    _, eng = _stream(models, [list(range(1, 20))], 24, k_max=4,
                     chunk_tokens=8, trace=rec)
    report = debug.serving_report()
    mine = [e for e in report
            if e["stats"]["engine_id"] == eng.stats.engine_id]
    assert len(mine) == 1
    entry = mine[0]
    assert entry["stats"]["tokens"] == 24
    assert entry["schedule"]["horizons"] >= 1
    assert entry["schedule"]["stalled_prefill_syncs"] == 0
    assert entry["drift"] and entry["drifting_shapes"]
    assert entry["trace_events"] == len(rec.events)
    assert entry["pad"]["tokens_dispatched"] > 0
    assert entry["pad"]["pad_fraction"] == pytest.approx(
        entry["pad"]["tokens_padded"] / entry["pad"]["tokens_dispatched"],
        abs=1e-4)
    ids = [e["stats"]["engine_id"] for e in report]
    names = [e["stats"]["engine"] for e in report]
    assert sorted(zip(names, ids)) == list(zip(names, ids))
    assert debug.serving_stats() == [e["stats"] for e in report]


# --------------------------------------------------------- chrome export


def test_mixed_ragged_export_is_schema_clean(models, tmp_path):
    """A real mixed ragged run exports a chrome trace the schema check
    passes (the JAX validator agrees), with spans, instants and ticks;
    a profiler raises (not ported); a tenant field puts the request's row
    under a pid of its own, as the JAX recorder does."""
    rec = FlightRecorder(progress_every=4)
    _stream(models, [list(range(1, 41)), [3, 141, 59]], 9, k_max=4,
            chunk_tokens=8, trace=rec)
    path = export_chrome_trace(str(tmp_path / "ragged.json"), recorders=rec)
    assert validate_chrome_trace(path) == []
    data = json.load(open(path))
    assert jax_validate(data) == []
    kinds = {e["ph"] for e in data["traceEvents"]}
    assert {"X", "M", "i"} <= kinds
    names = [e["name"] for e in data["traceEvents"]]
    assert any(n.startswith("req0:decode") for n in names)
    assert any(n.startswith("tick packed") for n in names)
    with pytest.raises(NotImplementedError):
        export_chrome_trace(str(tmp_path / "p.json"), recorders=rec,
                            profiler=object())
    rec.record("submit", ts=1.0, rid=99, tenant="a")
    evs = rec.chrome_events()
    assert evs == JaxRecorder.chrome_events(rec)
    tenant_pid = [e["pid"] for e in evs if e.get("name") == "process_name"
                  and e["args"]["name"].endswith("tenant=a")]
    assert tenant_pid == [3]                 # past the tick row (pid 2)


def test_recorder_outputs_equal_jax_on_identical_events():
    """The same events fed to both recorders — lifecycle records, a
    pipelined pair of ticks, a one-shot tick, a polluted tick, serial
    prices, a drift factor that flags — give equal summary(),
    drift_report() and chrome_events()."""
    def feed(rec):
        rec.meta.update(engine="E", k_max=4)
        rec.record("submit", ts=1.0, rid=0, prompt_tokens=5)
        rec.record("admit", ts=1.5, rid=0, slot=0, prompt_tokens=5,
                   cached_tokens=0, hit_blocks=0)
        a = rec.tick_dispatch("serve", ("packed", 4, 16), ts=2.0,
                              predicted_s=0.01, predicted_serial_s=0.02,
                              k=4, w=8)
        b = rec.tick_dispatch("serve", ("packed", 4, 16), ts=2.5,
                              predicted_s=0.01, predicted_serial_s=0.02,
                              k=4, w=8)
        rec.tick_complete(a, 0.8, tokens=4, pool={"cow": 0})
        rec.tick("serve", ("h2d_restore",), 0.001, predicted_s=0.002,
                 ts=2.6, blocks=1)
        rec.tick_complete(b, 0.03, drift=False, tokens=4)
        for i, ts in enumerate((3.0, 3.1, 3.2)):
            rec.tick("serve", ("decode", 2, 1), 0.004 * (i + 1),
                     predicted_s=0.003, predicted_serial_s=0.005, ts=ts)
        rec.record("first_token", ts=2.9, rid=0)
        rec.record("progress", ts=3.0, rid=0, tokens=4)
        rec.record("retire", ts=3.5, rid=0, tokens=6)
        return rec

    for kw in ({}, {"drift_factor": 1.5, "progress_every": 4}):
        port, ref = feed(FlightRecorder(**kw)), feed(JaxRecorder(**kw))
        assert port.summary() == ref.summary()
        assert port.drift_report() == ref.drift_report()
        assert port.drift_report(factor=1.1) == ref.drift_report(factor=1.1)
        assert port.chrome_events() == ref.chrome_events()
        assert port.chrome_events(pid=3, label="x") == \
            ref.chrome_events(pid=3, label="x")


def test_validate_chrome_trace_schema(tmp_path):
    """The schema check reports missing keys, negative durations,
    non-monotonic tracks and partially overlapping slices, passes nested
    and abutting ones, and agrees with the JAX validator on each case."""
    def ev(name, ts, dur, tid=0, ph="X"):
        return {"name": name, "ph": ph, "ts": ts, "dur": dur, "pid": 1,
                "tid": tid}
    cases = {
        "good": ([ev("a", 1.0, 2.0), ev("b", 3.0, 0.0),
                  {"name": "m", "ph": "M", "pid": 1, "tid": 0, "args": {}},
                  {"name": "o", "ph": "i", "ts": 0.5, "pid": 2, "tid": 7}],
                 None),
        "missing": ([{"ph": "X", "ts": 1.0, "dur": 1.0, "pid": 1,
                      "tid": 0}], "missing required key 'name'"),
        "bad_dur": ([ev("a", 1.0, -1.0)], "non-negative 'dur'"),
        "non_mono": ([ev("a", 5.0, 1.0), ev("b", 4.0, 1.0)], "monotonic"),
        "overlap": ([ev("a", 0.0, 10.0), ev("b", 5.0, 10.0)], "overlaps"),
        "nested": ([ev("a", 0.0, 10.0), ev("b", 2.0, 3.0),
                    ev("c", 10.0, 4.0)], None),
        "two_tracks": ([ev("a", 5.0, 1.0), ev("b", 4.0, 1.0, tid=1)], None),
    }
    for name, (events, problem) in cases.items():
        data = {"traceEvents": events}
        got = validate_chrome_trace(data)
        assert got == jax_validate(data), name
        if problem is None:
            assert got == [], name
        else:
            assert any(problem in p for p in got), name
    assert validate_chrome_trace({"x": 1}) == \
        ["top-level object must carry a 'traceEvents' list"]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": cases["good"][0]}))
    assert validate_chrome_trace(str(path)) == []
