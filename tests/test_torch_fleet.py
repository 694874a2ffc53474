"""The port's fleet serving (`paddle_tpu_torch.serving.fleet`:
`SharedHostKVTier`, `FleetRouter`; `debug.fleet_report`) against the JAX
package's on `gpt_tiny` f32, the weights of one JAX `GPT` carried across by
`state_dict_from_numpy`, and the kernel build's thread safety
(`ops._build`).

The shared tier keeps `HostKVTier`'s LRU / capacity contract on its
file-backed store, round-trips payloads bit-exact (tensors and numpy, int8
+ scale leaves), shares its entries with a second attach (and with the JAX
tier: one byte format) and refuses a store written for another decoder.
The router keeps template-sharing prompts together and lets a latency
request escape a deep backlog; 1-replica and 3-replica fleets (round-robin
and on threads) give byte-identical streams under admission churn with
sampling, an EOS, int8 pools and the prefix cache (3 seeds), equal to a
bare engine's and, on one seed, to the JAX fleet's; a respawned replica
warm-starts from the shared tier by restores; a second process warm-starts
from the first's spilled pages with the same streams; one trace export
holds disjoint pid blocks per replica. Two threads loading a kernel that
is not built yet start one build.

Tolerance: none — tokens, bytes and counters are equal.
"""
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import FleetRouter as JaxRouter
from paddle_tpu.serving import PagedGPTDecoder as JaxDecoder
from paddle_tpu.serving import PrefixCache as JaxCache
from paddle_tpu.serving import SharedHostKVTier as JaxSharedTier
from paddle_tpu.serving import TenantEngine as JaxTenant
from paddle_tpu_torch import debug
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.serving import (SLO_LATENCY, SLO_THROUGHPUT,
                                      FleetRouter, PagedGPTDecoder,
                                      PrefixCache, SharedHostKVTier,
                                      TenantEngine, validate_chrome_trace)


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


def _payload(nbytes=64):
    return {"k": (torch.zeros(nbytes // 2, dtype=torch.uint8),),
            "v": (torch.zeros(nbytes // 2, dtype=torch.uint8),)}


def _decoder(m, pkg="port", num_pages=11, **kw):
    if pkg == "jax":
        return JaxDecoder(m["jmodel"], num_pages=num_pages, page_size=16,
                          max_batch=2, **kw)
    return PagedGPTDecoder(m["cfg"], m["sd"], num_pages=num_pages,
                           page_size=16, max_batch=2, device="cpu", **kw)


def _build_fleet(m, n, tier_dir, pkg="port", num_pages=11, max_new=6,
                 k_max=2, policy="auto", eos=5, kv_quant=None, trace=None,
                 capacity_bytes=1 << 20):
    """The JAX test's fleet: n sampled TenantEngines over one shared
    tier."""
    tier_cls, cache_cls, eng_cls, router_cls = (
        (JaxSharedTier, JaxCache, JaxTenant, JaxRouter) if pkg == "jax"
        else (SharedHostKVTier, PrefixCache, TenantEngine, FleetRouter))
    engines = []
    for _ in range(n):
        dec = _decoder(m, pkg, num_pages=num_pages, temperature=0.9,
                       top_k=5, seed=11, kv_quant=kv_quant)
        tier = tier_cls(tier_dir, capacity_bytes=capacity_bytes,
                        fingerprint=dec)
        cache = cache_cls(16, salt=dec.cache_fingerprint(), tier=tier)
        engines.append(eng_cls(dec, max_new_tokens=max_new, k_max=k_max,
                               prefix_cache=cache, tier_policy=policy,
                               eos_token_id=eos, trace=trace))
    return router_cls(engines, affinity_blocks=2)


def _prompts(seed, n=8, n_templates=2):
    """Shared-template workload: hot 16-token template blocks with
    per-request suffixes."""
    rng = np.random.default_rng(seed)
    templates = [[int(x) for x in rng.integers(0, 50, size=16)]
                 for _ in range(n_templates)]
    return [list(templates[i % n_templates]) +
            [int(x) for x in rng.integers(0, 50, size=3 + i % 4)]
            for i in range(n)]


# ------------------------------------------------------ shared tier: unit


def test_shared_tier_lru_capacity_and_eviction(tmp_path):
    t = SharedHostKVTier(tmp_path, capacity_bytes=200)
    assert t.put(b"a" * 16, _payload(64)) and t.put(b"b" * 16, _payload(64))
    assert t.bytes_used == 128 and t.n_entries == 2
    t.touch(b"a" * 16)                      # b is now LRU
    assert t.put(b"c" * 16, _payload(128))  # evicts b to fit
    assert b"b" * 16 not in t and b"a" * 16 in t and b"c" * 16 in t
    assert t.evictions == 1 and t.bytes_used == 192
    assert not t.put(b"d" * 16, _payload(400))   # oversized refused
    assert t.put(b"a" * 16, _payload(64))        # re-put refreshes
    assert t.bytes_used == 192 and t.entry_bytes(b"a" * 16) == 64
    t0 = SharedHostKVTier(tmp_path / "off", capacity_bytes=0)
    assert not t0.put(b"a" * 16, _payload(64)) and len(t0) == 0
    assert t.shared is True


def test_shared_tier_payload_roundtrip_and_second_attach(tmp_path):
    """Payloads round-trip bit-exact (f32 and bf16 tensors, numpy int8 +
    f32 scale leaves), a second attach sees the first's entries in LRU
    order with `page: None` ledger rows, and the JAX tier reads the port's
    store: the same byte format."""
    t = SharedHostKVTier(tmp_path, capacity_bytes=1 << 16)
    kf = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    kb = (torch.arange(8, dtype=torch.float32) / 3).to(torch.bfloat16)
    q = {"k": (kf, kb), "v": (np.arange(6, dtype=np.int8),
                              np.ones(3, np.float32))}
    assert t.put(b"q" * 16, q) and t.put(b"r" * 16, _payload(64))
    t.touch(b"q" * 16)                    # r is now LRU
    t2 = SharedHostKVTier(tmp_path, capacity_bytes=1 << 16)
    assert b"q" * 16 in t2 and t2.bytes_used == t.bytes_used
    p = t2.get(b"q" * 16)
    assert torch.equal(p["k"][0], kf) and torch.equal(p["k"][1], kb)
    assert p["v"][0].dtype == torch.int8 and \
        p["v"][1].dtype == torch.float32
    assert [k for k, _ in t2.items()][0] == b"r" * 16
    assert list(t.ledger())[-1] == (b"q" * 16).hex()
    assert all(row["page"] is None for row in t.ledger().values())
    jt = JaxSharedTier(tmp_path, capacity_bytes=1 << 16)
    jp = jt.get(b"q" * 16)
    assert np.array_equal(np.asarray(jp["k"][0]), kf.numpy())
    assert np.asarray(jp["k"][1]).tobytes() == \
        kb.view(torch.int16).numpy().tobytes()


def test_shared_tier_fingerprint_mismatch_refuses(tmp_path, models):
    dec = _decoder(models)
    SharedHostKVTier(tmp_path, fingerprint=dec)
    SharedHostKVTier(tmp_path, fingerprint=dec)            # same: fine
    other = _decoder(models, kv_quant="int8")
    with pytest.raises(ValueError, match="fingerprint"):
        SharedHostKVTier(tmp_path, fingerprint=other)


# ------------------------------------------------------------- the router


def test_merge_single_replica_is_identity(tmp_path, models):
    r = _build_fleet(models, 1, tmp_path / "tier")
    for p in _prompts(0, n=4):
        r.submit(p)
    r.run(parallel=False)
    s_eng = r.engines[0].stats.summary()
    s_fleet = r.merged_stats().summary()
    for k in set(s_eng) | set(s_fleet):
        if k not in ("engine_id", "replica"):
            assert s_fleet[k] == s_eng[k], k
    assert r.tenancy_summary() == r.engines[0].tenancy_summary()
    rep = debug.fleet_report(r)
    assert rep["stats"] == s_fleet and len(rep["replicas"]) == 1
    assert rep["shared_tier"]["entries"] == r.engines[0].tier.n_entries


def test_affinity_and_slo_escape(tmp_path, models):
    """Template-sharing requests land on one replica (the chain key is the
    routing key), a sub-block prompt goes least-loaded, and a latency
    request facing an affinity backlog a full batch deeper than the
    least-loaded replica reroutes while its throughput twin stays home.
    (The homes themselves differ from the JAX router's: the chain keys are
    salted by each package's own `cache_fingerprint`.)"""
    r = _build_fleet(models, 3, tmp_path / "tier")
    ps = _prompts(1, n=6)
    homes = [r.replica_of(r.submit(p)) for p in ps]
    assert len({homes[0], homes[2], homes[4]}) == 1
    assert len({homes[1], homes[3], homes[5]}) == 1
    least = min(range(3), key=lambda j: (r._load(j), j))
    assert r.replica_of(r.submit([1, 2, 3])) == least
    r.run(parallel=False)
    r = _build_fleet(models, 3, tmp_path / "tier_b")
    hot = _prompts(2, n=5, n_templates=1)
    gids = [r.submit(p, slo=SLO_THROUGHPUT) for p in hot]
    home = r.replica_of(gids[0])
    assert all(r.replica_of(g) == home for g in gids)
    assert r.replica_of(r.submit(hot[0], slo=SLO_THROUGHPUT)) == home
    assert r.replica_of(r.submit(hot[0], slo=SLO_LATENCY)) != home
    r.run(parallel=False)


def _run_fleet_workload(m, n, tier_dir, seed, parallel, pkg="port"):
    """Half the workload up front, the rest churned in through on_sync;
    returns (router, streams in gid order)."""
    r = _build_fleet(m, n, tier_dir, pkg=pkg, kv_quant="int8")
    ps = _prompts(seed, n=8)
    slos = [SLO_LATENCY if i % 3 == 0 else SLO_THROUGHPUT
            for i in range(len(ps))]
    gids = [r.submit(p, tenant=f"t{i % 2}", slo=slos[i])
            for i, p in enumerate(ps[:5])]
    state = {"i": 5}

    def on_sync(router, rep, eng):
        if state["i"] < len(ps):
            j = state["i"]
            state["i"] += 1
            gids.append(router.submit(ps[j], tenant=f"t{j % 2}",
                                      slo=slos[j]))

    out = r.run(on_sync=on_sync, parallel=parallel)
    while state["i"] < len(ps) or any(g not in out for g in gids):
        out.update(r.run(on_sync=on_sync, parallel=parallel))
    return r, [out[g] for g in gids]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_streams_byte_identical_1_vs_3(tmp_path, models, seed):
    """1-replica vs 3-replica streams are byte-identical under admission
    churn (sampled, EOS, prefix cache, int8 pools), on threads on seed 0,
    equal to a bare TenantEngine fed the prompts in gid order, and on seed
    0 equal to the JAX 3-replica fleet's."""
    _, out1 = _run_fleet_workload(models, 1, tmp_path / "t1", seed, False)
    r3, out3 = _run_fleet_workload(models, 3, tmp_path / "t3", seed, False)
    assert out1 == out3
    assert all(e.audit_pages() == [] for e in r3.engines)
    if seed == 0:
        _, out3p = _run_fleet_workload(models, 3, tmp_path / "t3p", seed,
                                       True)
        assert out1 == out3p
        _, jout = _run_fleet_workload(models, 3, tmp_path / "j3", seed,
                                      False, pkg="jax")
        assert out1 == jout
    dec = _decoder(models, temperature=0.9, top_k=5, seed=11,
                   kv_quant="int8")
    eng = TenantEngine(dec, max_new_tokens=6, k_max=2, eos_token_id=5,
                       prefix_cache=PrefixCache(
                           16, salt=dec.cache_fingerprint()))
    ps = _prompts(seed, n=8)
    for i, p in enumerate(ps):
        eng.submit(p, tenant=f"t{i % 2}")
    twin = eng.run()
    assert [twin[i] for i in range(len(ps))] == out1


def test_respawn_warm_starts_from_shared_tier(tmp_path, models):
    """Kill a replica and respawn it cold over the same shared tier: the
    steady-state hit rate recovers, and the respawned replica's template
    spans come back as tier RESTORES, never as recompute."""
    tier_dir = tmp_path / "tier"

    def fresh_engine():
        dec = _decoder(models, num_pages=9, temperature=0.9, top_k=5,
                       seed=11)
        tier = SharedHostKVTier(tier_dir, capacity_bytes=1 << 20,
                                fingerprint=dec)
        cache = PrefixCache(16, salt=dec.cache_fingerprint(), tier=tier)
        return TenantEngine(dec, max_new_tokens=6, k_max=2,
                            prefix_cache=cache, tier_policy="restore")

    r = FleetRouter([fresh_engine(), fresh_engine()], affinity_blocks=2)
    rng = np.random.default_rng(5)
    templates = [[int(x) for x in rng.integers(0, 50, size=32)]
                 for _ in range(10)]

    def wave(suffix_seed):
        rs = np.random.default_rng(suffix_seed)
        before = r.merged_stats()
        h0, m0 = before.prefix_hits, before.prefix_misses
        for i in range(2 * len(templates)):
            r.submit(list(templates[i % len(templates)]) +
                     [int(x) for x in rs.integers(0, 50, size=3 + i % 4)])
        r.run(parallel=False)
        after = r.merged_stats()
        hits, misses = after.prefix_hits - h0, after.prefix_misses - m0
        return hits / max(hits + misses, 1)

    wave(31)
    wave(32)
    pre = wave(33)
    assert pre > 0.5 and r.engines[0].tier.n_entries > 0
    r.respawn(1, fresh_engine())
    post = wave(34)
    assert post >= pre - 0.10, (pre, post)
    st = r.engines[1].stats
    assert st.tier_restores > 0 and st.tier_recomputes == 0
    assert st.prefix_hits > 0
    assert all(e.audit_pages() == [] for e in r.engines)


_WORKER = """
import json, sys
import numpy as np
import torch
from paddle_tpu_torch.models import gpt_tiny
from paddle_tpu_torch.serving import (PagedGPTDecoder, PrefixCache,
                                      SharedHostKVTier, TenantEngine)

sd_path, tier_dir, out_path = sys.argv[1:4]
torch.set_num_threads(1)
sd = torch.load(sd_path)
dec = PagedGPTDecoder(gpt_tiny(max_seq_len=128, dtype="float32"), sd,
                      num_pages=9, page_size=16, max_batch=2,
                      temperature=0.9, top_k=5, seed=11, device="cpu")
tier = SharedHostKVTier(tier_dir, capacity_bytes=1 << 20, fingerprint=dec)
eng = TenantEngine(dec, max_new_tokens=6, k_max=2, tier_policy="restore",
                   prefix_cache=PrefixCache(16, salt=dec.cache_fingerprint(),
                                            tier=tier))
rng = np.random.default_rng(9)
templates = [[int(x) for x in rng.integers(0, 50, size=32)]
             for _ in range(6)]
for i in range(12):
    eng.submit(list(templates[i % 6]) +
               [int(x) for x in rng.integers(0, 50, size=3 + i % 4)])
out = eng.run()
json.dump({"outputs": {str(k): v for k, v in out.items()},
           "tier_restores": eng.stats.tier_restores,
           "prefix_hits": eng.stats.prefix_hits,
           "n_entries": tier.n_entries}, open(out_path, "w"))
"""


def test_shared_tier_cross_process_warm_start(tmp_path, models):
    """Two OS processes, one store: A serves a template workload and
    spills; B (a fresh process, cold cache) serves the same workload,
    restores A's spans and emits the same streams."""
    sd_path = tmp_path / "sd.pt"
    torch.save(models["sd"], sd_path)
    res = []
    for name in ("a", "b"):
        out = tmp_path / f"{name}.json"
        subprocess.run([sys.executable, "-c", _WORKER, str(sd_path),
                        str(tmp_path / "tier"), str(out)], check=True,
                       timeout=300, capture_output=True,
                       cwd=Path(__file__).resolve().parents[1])
        res.append(json.loads(out.read_text()))
    a, b = res
    assert a["n_entries"] > 0, "process A never spilled"
    assert b["outputs"] == a["outputs"]
    assert b["tier_restores"] > 0
    assert b["prefix_hits"] >= a["prefix_hits"]


def test_fleet_trace_one_timeline_distinct_pids(tmp_path, models):
    r = _build_fleet(models, 2, tmp_path / "tier", trace=True)
    for i, p in enumerate(_prompts(4, n=6)):
        r.submit(p, tenant=f"t{i % 2}")
    r.run(parallel=False)
    path = tmp_path / "fleet_trace.json"
    r.export_trace(str(path))
    doc = json.loads(path.read_text())
    assert validate_chrome_trace(doc) == []
    names = {e["args"]["name"]: e["pid"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"}
    r0 = {p for n, p in names.items() if n.startswith("replica0")}
    r1 = {p for n, p in names.items() if n.startswith("replica1")}
    assert r0 and r1 and not (r0 & r1)
    assert any("tenant=t1" in n for n in names)
    plain = _build_fleet(models, 1, tmp_path / "tier2")
    with pytest.raises(ValueError, match="FlightRecorder"):
        plain.export_trace(str(tmp_path / "none.json"))


# ------------------------------------------------------- the kernel build


def test_two_threads_loading_a_kernel_start_one_build(tmp_path,
                                                      monkeypatch):
    """`_build.load` from two threads at once on a library that is not
    built yet runs one nvcc (mocked), and both threads get the one
    handle."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "stub.cu").write_text("// stub\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_LIBS", {})
    started = []
    gate = threading.Barrier(2, timeout=30)

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            started.append(cmd)
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            with open(self.out, "wb") as f:
                f.write(b"lib")
            return (b"", None)

    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("handle", path))
    got = []

    def worker():
        gate.wait()
        got.append(_build.load("stub"))

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(started) == 1, started
    assert len(got) == 2 and got[0] is got[1]
    assert len(list((tmp_path / "build").glob("*.so"))) == 1
