"""Fleet-scale serving on one host: a shared host KV tier and a
prefix-affinity router over N engine replicas (the port's counterpart of
`paddle_tpu/serving/fleet.py`; numpy and the stdlib).

A KV page's bytes are a pure function of (request, position) — schedule-,
batch-, slot- and process-independent — so a page is a wire format for
free:

- **`SharedHostKVTier`** — the `HostKVTier` payloads re-homed onto a
  file-backed store (point `path` at /dev/shm for shared memory) keyed by
  the same chain keys plus a `cache_fingerprint` digest, one entry per
  spilled page in the exact `PrefixCache.save` / `load` byte format
  (`pack_array` / `unpack_array`: raw uint8 + JSON shape/dtype meta). One
  warm set serves every replica on the host; a killed replica's spilled
  working set warms its siblings and its own respawn. Mutations hold the
  in-process `threading.RLock` AND an `fcntl.flock` on the store (in that
  order, always); index updates publish via atomic `os.replace`.
  Restores out of the shared store pay a host-RAM read leg before the
  PCIe copy, so `shared = True` routes the engine's pricing through
  `cost_model.kv_restore_s(shared=True)`.
- **`FleetRouter`** — a front end over N `TenantEngine` replicas that
  routes by PREFIX AFFINITY: the prompt's first chain blocks hash to a
  home replica (the prefix cache's own content-addressed keys are the
  routing key), with an SLO-aware least-loaded escape and a least-loaded
  fallback for prompts too short to key. Each replica drains in its own
  thread through the engine's `run(on_sync=)` hook, and churn submitted
  mid-run parks on the router and is drained into the owning replica
  from its own thread at its next sync — engine internals are only ever
  touched by their own thread.
- **Byte identity across fleet sizes.** The router owns request
  identity: one GLOBAL rid counter, stamped into the owning engine
  (`_next_id`) right before its `submit`. Sampling keys are (seed, rid,
  position) and KV bytes are (request, position)-pure, so an N-replica
  fleet emits the 1-replica twin's streams.
- **Observability.** `ServeStats.merge` over the replicas, a fleet-wide
  `tenancy_summary` through the same `summarize_tenancy` math as the
  single engine, and `export_trace` → one Perfetto timeline with
  distinct pids per (replica, tenant).

On one card every replica is a decoder + engine of its own over that
card; their horizons share the device and its default stream (the port's
one-card form of the JAX fleet). Scope: ONE host — the store is a file
path and the lock an fcntl flock.
"""
import hashlib
import json
import os
import threading
import time

import numpy as np
import torch

from .kv_tier import DEFAULT_CAPACITY_BYTES, _TierEntry, payload_bytes
from .prefix_cache import pack_array, unpack_array
from .stats import ServeStats
from .tenancy import SLO_LATENCY, SLO_THROUGHPUT, TenantStats, \
    summarize_tenancy

try:
    import fcntl
except ImportError:          # non-POSIX: in-process locking only
    fcntl = None

__all__ = ["SharedHostKVTier", "FleetRouter"]


class SharedHostKVTier:
    """Cross-process host KV tier: `HostKVTier`'s contract (the duck
    type the engine and `PrefixCache.save` consume) over a file-backed
    store shared by every replica on the host.

    Layout under `path` (point it at /dev/shm for an shm-backed
    store): `tier.json` (fingerprint digest + nominal capacity),
    `index.json` (recency sequence + per-entry bytes — the LRU state,
    published by atomic `os.replace` so unlocked readers see a
    complete old or new index, never a torn one), `lock` (the flock
    file), and `entries/<chain key hex>.npz` — one spilled page per
    file in the exact `PrefixCache.save/load` byte format
    (`pack_array` raw-uint8 leaves + JSON shape/dtype meta), so a
    restored payload is bit-identical to the spilled one and the
    byte-identical-stream invariant survives the process boundary.

    Lock discipline (the JAX package's thread lint certifies its twin;
    that lint is not ported): every
    mutation takes the in-process `self._lock` (RLock) FIRST, then
    the cross-process flock, releases in reverse — one global order,
    no ABBA. Queries take `self._lock` only (the atomic index publish
    makes unlocked file reads safe; the RLock still serializes the
    in-process stat cache).

    `fingerprint` (bytes, or a decoder exposing `cache_fingerprint`)
    pins the store to one model/pool config: a mismatched attach
    REFUSES, exactly like `PrefixCache.load`. Chain keys are already
    fingerprint-salted so cross-model entries could never alias — the
    check turns silent 0-hit sharing into a loud error.

    Device-twin backrefs (`note_mounted`) are deliberately NOT kept:
    a shared entry may have twins in MANY replicas' pools at once, so
    a single backref is ill-defined — `ledger()` rows carry
    `"page": None` and the MEM-PAGE-REFCOUNT audit's twin cross-check
    simply has nothing to flag (the per-process `HostKVTier` keeps
    that audit). `capacity_bytes=0` refuses every put — the same
    tier-off twin semantics as `HostKVTier`."""

    # restores pay host-RAM read + PCIe: the engine reads this into
    # restore_beats_recompute(shared=True) / kv_restore_s(shared=True)
    shared = True

    def __init__(self, path, capacity_bytes=DEFAULT_CAPACITY_BYTES,
                 fingerprint=None):
        self.path = os.path.abspath(path)
        self.capacity_bytes = int(capacity_bytes)
        self.puts = 0            # accepted spills (this attach)
        self.evictions = 0       # entries this attach LRU'd out
        self._lock = threading.RLock()
        self._stat_cache = None  # (index stat signature, parsed index)
        self._entries_dir = os.path.join(self.path, "entries")
        self._index_path = os.path.join(self.path, "index.json")
        os.makedirs(self._entries_dir, exist_ok=True)
        self._lock_fd = os.open(os.path.join(self.path, "lock"),
                                os.O_RDWR | os.O_CREAT, 0o644)
        fp_hex = None
        if fingerprint is not None:
            fp = fingerprint.cache_fingerprint() \
                if hasattr(fingerprint, "cache_fingerprint") \
                else bytes(fingerprint)
            fp_hex = hashlib.blake2b(fp, digest_size=16).hexdigest()
        with self._lock:
            self._flock()
            try:
                meta_path = os.path.join(self.path, "tier.json")
                if os.path.exists(meta_path):
                    with open(meta_path) as f:
                        meta = json.load(f)
                    want = meta.get("fingerprint")
                    if fp_hex is not None and want is not None and \
                            want != fp_hex:
                        raise ValueError(
                            f"shared KV tier at {self.path!r} was "
                            f"created for fingerprint {want} but this "
                            f"attach is {fp_hex} — different weights/"
                            "arch/pool config would share garbage KV; "
                            "use a different path or rebuild the "
                            "matching decoder")
                else:
                    self._write_json(meta_path, {
                        "fingerprint": fp_hex,
                        "capacity_bytes": self.capacity_bytes})
                if not os.path.exists(self._index_path):
                    self._write_json(self._index_path,
                                     {"seq": 0, "entries": {}})
            finally:
                self._funlock()

    def close(self):
        fd, self._lock_fd = self._lock_fd, None
        if fd is not None:
            os.close(fd)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # --------------------------------------------------- lock + files

    def _flock(self):
        """Cross-process leg. Callers already hold `self._lock`, so
        one fd per process is safe: flock is per-fd, and the RLock
        serializes this process's threads onto it."""
        if fcntl is not None and self._lock_fd is not None:
            fcntl.flock(self._lock_fd, fcntl.LOCK_EX)

    def _funlock(self):
        if fcntl is not None and self._lock_fd is not None:
            fcntl.flock(self._lock_fd, fcntl.LOCK_UN)

    def _write_json(self, path, obj):
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)

    def _load_index(self):
        """Fresh parse, for mutators (caller holds lock + flock)."""
        try:
            with open(self._index_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"seq": 0, "entries": {}}

    def _publish_index(self, idx):
        self._write_json(self._index_path, idx)
        self._stat_cache = None

    def _index(self):
        """Parsed index for queries (caller holds `self._lock`),
        cached on the file's stat signature — hot-path membership
        checks (`_tier_plan` walks the chain per admission) re-parse
        only when another process actually published."""
        try:
            st = os.stat(self._index_path)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            return {"seq": 0, "entries": {}}
        if self._stat_cache is not None and self._stat_cache[0] == sig:
            return self._stat_cache[1]
        idx = self._load_index()
        self._stat_cache = (sig, idx)
        return idx

    def _entry_path(self, hexkey):
        return os.path.join(self._entries_dir, hexkey + ".npz")

    def _write_entry(self, hexkey, arrays):
        tmp = os.path.join(self._entries_dir,
                           f".{hexkey}.{os.getpid()}.tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, self._entry_path(hexkey))

    def _read_entry(self, hexkey):
        with np.load(self._entry_path(hexkey)) as data:
            meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
            return {part: tuple(
                unpack_array(data[f"{part}.{i}"],
                             meta["arrays"][f"{part}.{i}"])
                for i in range(meta["leaves"][part]))
                for part in ("k", "v")}

    @staticmethod
    def _encode(payload, nbytes):
        """One spilled page -> npz arrays in the PrefixCache.save
        byte format: raw-uint8 leaves + a JSON meta array carrying
        shape/dtype (npz can't serialize bf16 leaves directly)."""
        arrays, ameta, leaves = {}, {}, {}
        for part in ("k", "v"):
            leaves[part] = len(payload[part])
            for i, leaf in enumerate(payload[part]):
                arrays[f"{part}.{i}"], ameta[f"{part}.{i}"] = \
                    pack_array(leaf)
        arrays["__meta__"] = np.frombuffer(
            json.dumps({"arrays": ameta, "leaves": leaves,
                        "nbytes": int(nbytes)}).encode("utf-8"),
            np.uint8)
        return arrays

    # ------------------------------------------------------------ query

    def __contains__(self, key):
        with self._lock:
            return key.hex() in self._index()["entries"]

    def __len__(self):
        with self._lock:
            return len(self._index()["entries"])

    @property
    def n_entries(self):
        return len(self)

    @property
    def bytes_used(self):
        with self._lock:
            return sum(int(e["bytes"]) for e in
                       self._index()["entries"].values())

    def entry_bytes(self, key):
        with self._lock:
            return int(self._index()["entries"][key.hex()]["bytes"])

    def items(self):
        """(key, entry-with-.payload) pairs in LRU order (oldest
        first) — the persistence walk (`PrefixCache.save`) reads
        `.payload`, so this READS every entry file; it is the
        snapshot path, not a hot path."""
        with self._lock:
            self._flock()
            try:
                idx = self._index()
                out = []
                for hexkey, e in sorted(idx["entries"].items(),
                                        key=lambda kv: kv[1]["seq"]):
                    key = bytes.fromhex(hexkey)
                    out.append((key, _TierEntry(
                        key, self._read_entry(hexkey),
                        int(e["bytes"]))))
                return out
            finally:
                self._funlock()

    # ----------------------------------------------------------- insert

    def put(self, key, payload, page=None):
        """Spill one page's payload under `key`; False when the
        capacity bound refuses it (entry bigger than the whole tier,
        or capacity 0 — the tier-off twin). Evicts LRU entries (never
        the one being put) to fit; a re-put refreshes payload +
        recency. The entry file lands BEFORE the index row: a crash
        between the two leaves an orphan file, never a dangling
        index row."""
        nbytes = int(payload_bytes(payload))
        if nbytes > self.capacity_bytes:
            return False
        arrays = self._encode(payload, nbytes)
        hexkey = key.hex()
        with self._lock:
            self._flock()
            try:
                idx = self._load_index()
                entries = idx["entries"]
                entries.pop(hexkey, None)
                self._write_entry(hexkey, arrays)
                entries[hexkey] = {"bytes": nbytes,
                                   "seq": int(idx["seq"])}
                idx["seq"] = int(idx["seq"]) + 1
                used = sum(int(e["bytes"]) for e in entries.values())
                while used > self.capacity_bytes and len(entries) > 1:
                    victim = min(
                        (h for h in entries if h != hexkey),
                        key=lambda h: entries[h]["seq"])
                    used -= int(entries[victim]["bytes"])
                    del entries[victim]
                    try:
                        os.remove(self._entry_path(victim))
                    except OSError:
                        pass
                    self.evictions += 1
                self._publish_index(idx)
            finally:
                self._funlock()
            self.puts += 1
        return True

    def get(self, key):
        """Payload of `key` (touches recency — the cross-process LRU
        sequence bumps under the flock). KeyError when absent:
        callers gate on `key in tier`, and the engine's plan-time
        hold tolerates a sibling evicting between the two."""
        hexkey = key.hex()
        with self._lock:
            self._flock()
            try:
                idx = self._load_index()
                e = idx["entries"].get(hexkey)
                if e is None:
                    raise KeyError(key)
                payload = self._read_entry(hexkey)
                e["seq"] = int(idx["seq"])
                idx["seq"] = int(idx["seq"]) + 1
                self._publish_index(idx)
            finally:
                self._funlock()
        return payload

    def touch(self, key):
        """Refresh recency without reading (the recompute-refresh
        path); absent keys are a no-op."""
        hexkey = key.hex()
        with self._lock:
            self._flock()
            try:
                idx = self._load_index()
                e = idx["entries"].get(hexkey)
                if e is not None:
                    e["seq"] = int(idx["seq"])
                    idx["seq"] = int(idx["seq"]) + 1
                    self._publish_index(idx)
            finally:
                self._funlock()

    # ------------------------------------------- device-twin bookkeeping

    def note_mounted(self, key, page):
        """No-op by design: a shared entry may be mounted in many
        replicas' pools at once, so the single-backref audit the
        per-process tier supports is ill-defined here. Recency was
        already refreshed by the plan-time `get`."""

    def note_unmounted(self, key):
        """The local device twin was evicted; the host payload is
        still the exact write-time bytes — refresh recency (the entry
        is hot again), matching `HostKVTier` semantics."""
        self.touch(key)

    # ------------------------------------------------------------ ledger

    def ledger(self):
        """{key hex: {"bytes": n, "page": None}} in LRU order — the
        host rows of `page_ledger()`. `page` is always None (no
        cross-replica backref; see class docstring)."""
        with self._lock:
            idx = self._index()
            return {h: {"bytes": int(e["bytes"]), "page": None}
                    for h, e in sorted(idx["entries"].items(),
                                       key=lambda kv: kv[1]["seq"])}


class FleetRouter:
    """Prefix-affinity front end over N engine replicas (normally
    `TenantEngine`s sharing one `SharedHostKVTier`).

    Routing: the prompt's first `affinity_blocks` chain blocks hash
    to a home replica — the prefix cache's content-addressed keys ARE
    the routing key, so two requests sharing a template land where
    that template's pages already live. A latency-SLO request facing
    an affinity backlog `max_batch`+ deeper than the least-loaded
    replica reroutes there (SLO class + least-loaded tiebreak);
    prompts too short to key (< one full block) go least-loaded.
    Routing never affects stream BYTES — sampling keys are (seed,
    rid, position) and the router owns rid: one global counter
    assigned in submission order, stamped into the owning engine
    right before its `submit`, so an N-replica fleet is
    byte-identical to the 1-replica twin serving the same submission
    sequence.

    `run(parallel=True)` drains each replica in its own thread
    through the engine's `run(on_sync=)` hook; `on_sync(router,
    replica, engine)`, if given, fires at every replica sync under
    the router lock and may `router.submit` more work (admission
    churn) — churn parks on the router and is drained into the
    owning replica from that replica's OWN thread at its next sync,
    so engine internals are single-threaded by construction.
    `parallel=False` drains replicas round-robin on the calling
    thread — the deterministic mode the byte-identity tests drive.
    Submit through the router only: a
    direct `engine.submit` would collide with the global rid space.

    `respawn(i, engine)` swaps a dead replica for a fresh engine
    (same decoder config, same shared tier): the global rid counter
    keeps advancing, and the respawned replica warm-starts from the
    shared tier — its prefix hit rate recovers to the pre-kill
    steady state with zero prefill recompute for restored spans
    (test-pinned)."""

    def __init__(self, engines, affinity_blocks=2):
        engines = list(engines)
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        if len({id(e) for e in engines}) != len(engines):
            raise ValueError("FleetRouter replicas must be distinct "
                             "engine objects (one pool each)")
        self.engines = engines
        self.affinity_blocks = max(1, int(affinity_blocks))
        self._lock = threading.RLock()
        self._next_rid = 0           # global rid: THE sampling identity
        self._rid_replica = {}       # gid -> replica index
        self._pending = []           # (replica, gid, ids, tenant, slo,
        #                              adapter): churn awaiting the
        #                              owner replica's next sync
        self._outputs = {}           # gid -> generated tokens
        self._running = set()        # replicas currently inside run()
        self._serving = False        # inside router.run()
        self._errors = []
        for i, eng in enumerate(engines):
            eng.stats.replica = i

    # ------------------------------------------------------- submission

    def submit(self, prompt_ids, tenant="default", slo=SLO_THROUGHPUT,
               adapter=None):
        """Route + queue one prompt; returns its GLOBAL request id
        (the rid every stream byte is keyed by). Safe to call from
        `on_sync` churn callbacks mid-run: the submission parks on
        the router and the owning replica drains it at its next
        sync."""
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.cpu().numpy()
        ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        with self._lock:
            gid = self._next_rid
            self._next_rid = gid + 1
            i = self._route(ids, slo, adapter)
            self._rid_replica[gid] = i
            if self._serving:
                self._pending.append((i, gid, ids, tenant, slo,
                                      adapter))
            else:
                self._submit_to(i, gid, ids, tenant, slo, adapter)
        return gid

    def replica_of(self, gid):
        """Replica index a request was routed to (raises KeyError for
        unknown rids)."""
        with self._lock:
            return self._rid_replica[gid]

    def _route(self, ids, slo, adapter):
        """Affinity first, load as the escape hatch (caller holds the
        lock). Load reads are racy against running replicas — they
        only steer placement, never bytes."""
        n = len(self.engines)
        if n == 1:
            return 0
        eng0 = self.engines[0]
        target = None
        if eng0.cache is not None:
            keys = eng0.cache.block_keys(
                ids, extra_salt=eng0.d.adapter_salt(int(adapter or 0)))
            if keys:
                akey = keys[min(self.affinity_blocks, len(keys)) - 1]
                target = int.from_bytes(akey[:8], "big") % n
        loads = [self._load(j) for j in range(n)]
        least = min(range(n), key=lambda j: (loads[j], j))
        if target is None:
            return least
        if slo == SLO_LATENCY and loads[target] - loads[least] >= \
                self.engines[target].d.max_batch:
            # the affinity home is a full batch deeper than the
            # least-loaded replica: re-prefilling elsewhere beats
            # queueing behind the backlog for the latency tier
            return least
        return target

    def _load(self, j):
        eng = self.engines[j]
        return len(eng._queue) + sum(r is not None
                                     for r in eng._slot_req)

    def _submit_to(self, i, gid, ids, tenant, slo, adapter):
        """Hand one routed request to its engine, stamping the global
        rid into the engine's allocator first — rid IS the sampling
        key id, so fleet streams match the single-engine twin's.
        Called from the engine's own thread only (direct submit
        before run, or the owner's sync drain during it)."""
        eng = self.engines[i]
        eng._next_id = gid
        if hasattr(eng, "_submit_meta"):     # TenantEngine
            eng.submit(ids, tenant=tenant, slo=slo, adapter=adapter)
        else:
            eng.submit(ids, adapter=adapter)

    def _drain_pending(self, i):
        """Move replica `i`'s parked churn into its engine (called
        from that replica's own thread)."""
        with self._lock:
            mine = [p for p in self._pending if p[0] == i]
            if mine:
                self._pending = [p for p in self._pending
                                 if p[0] != i]
        for _, gid, ids, tenant, slo, adapter in mine:
            self._submit_to(i, gid, ids, tenant, slo, adapter)

    # ---------------------------------------------------------- serving

    def _hook(self, i, on_sync):
        """The per-replica `run(on_sync=)` wrapper: user churn under
        the router lock, then drain whatever was routed here."""
        def hook(eng):
            if on_sync is not None:
                with self._lock:
                    on_sync(self, i, eng)
            self._drain_pending(i)
        return hook

    def run(self, on_sync=None, parallel=True):
        """Drain the whole fleet; returns {global rid: generated
        token list} for every request retired during this call.
        `on_sync(router, replica, engine)` fires at every replica
        sync (under the router lock) and may `router.submit` churn.
        `parallel=True` gives each replica its own thread (on one card
        the replicas' launches share its default stream, and eager
        dispatch holds the GIL for most of a tick, so the threads mostly
        take turns);
        `parallel=False` drains replicas round-robin on the calling
        thread (deterministic order)."""
        with self._lock:
            self._outputs = {}
            self._errors = []
            self._serving = True
        try:
            if parallel and len(self.engines) > 1:
                threads = [threading.Thread(
                    target=self._serve_replica, args=(i, on_sync),
                    name=f"fleet-replica{i}")
                    for i in range(len(self.engines))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                if self._errors:
                    raise self._errors[0]
            else:
                self._serve_round_robin(on_sync)
        finally:
            with self._lock:
                self._serving = False
        with self._lock:
            return dict(self._outputs)

    def _serve_replica(self, i, on_sync):
        """One replica's drain loop (worker thread): run whenever the
        engine has queued work, then wait for routed churn until the
        whole fleet is quiescent."""
        eng = self.engines[i]
        hook = self._hook(i, on_sync)
        try:
            while True:
                self._drain_pending(i)
                if eng._queue:
                    with self._lock:
                        self._running.add(i)
                    try:
                        out = eng.run(on_sync=hook)
                    finally:
                        with self._lock:
                            self._running.discard(i)
                    with self._lock:
                        self._outputs.update(out)
                    continue
                if self._quiescent():
                    return
                time.sleep(0.0005)
        except BaseException as e:           # surfaced after join
            with self._lock:
                self._errors.append(e)
                self._running.discard(i)

    def _quiescent(self):
        """No parked churn, no replica mid-run, every queue and slot
        empty — only then may a drain loop exit (a running sibling
        may still route work here)."""
        with self._lock:
            if self._pending or self._running or self._errors:
                return bool(self._errors)
            return all(not e._queue and
                       all(r is None for r in e._slot_req)
                       for e in self.engines)

    def _serve_round_robin(self, on_sync):
        """Deterministic single-thread drain: replicas run to
        completion in index order, looped until no churn remains."""
        while True:
            progressed = False
            for i in range(len(self.engines)):
                self._drain_pending(i)
                eng = self.engines[i]
                if eng._queue:
                    out = eng.run(on_sync=self._hook(i, on_sync))
                    with self._lock:
                        self._outputs.update(out)
                    progressed = True
            with self._lock:
                if not self._pending and not progressed:
                    return

    # ------------------------------------------------------ replica ops

    def respawn(self, i, engine):
        """Swap replica `i` for a fresh engine (kill/respawn): the
        new engine inherits the replica id and, when built over the
        same `SharedHostKVTier`, warm-starts from the fleet's shared
        working set. Call between runs (the dead replica must not be
        mid-drain)."""
        with self._lock:
            if self._serving and i in self._running:
                raise RuntimeError(
                    f"replica {i} is mid-run — drain or kill it "
                    "before respawning")
            engine.stats.replica = i
            self.engines[i] = engine

    # ---------------------------------------------------- observability

    def merged_stats(self):
        """One fleet-wide `ServeStats` (`ServeStats.merge` over the
        replicas in replica order)."""
        return ServeStats.merge([e.stats for e in self.engines])

    def summary(self):
        return self.merged_stats().summary()

    def tenancy_summary(self):
        """Fleet-wide tenancy view: per-replica `TenantStats` merge
        per (tenant, slo) — counters sum, windows pool in replica
        order — then the SAME `summarize_tenancy` math as the single
        engine (a 1-replica fleet reproduces its engine's summary
        bit-for-bit)."""
        merged = {}
        for eng in self.engines:
            for key, ts in getattr(eng, "_tenants", {}).items():
                m = merged.get(key)
                if m is None:
                    m = merged[key] = TenantStats(tenant=ts.tenant,
                                                  slo=ts.slo)
                m.requests += ts.requests
                m.completed += ts.completed
                m.tokens += ts.tokens
                m.preemptions += ts.preemptions
                m.resumes += ts.resumes
                m.queue_wait_s.extend(ts.queue_wait_s)
                m.ttft_s.extend(ts.ttft_s)
                m.occupancy.extend(ts.occupancy)
        targets = next(
            (eng.scheduler.slo_targets_s for eng in self.engines
             if hasattr(eng.scheduler, "slo_targets_s")), None)
        return summarize_tenancy(
            merged, slo_targets_s=targets,
            preemptions=sum(e.stats.preemptions for e in self.engines),
            resumes=sum(e.stats.resumes for e in self.engines))

    def page_ledgers(self):
        """One auditable page ledger per replica (replica order) —
        each feeds `page_audit.audit_page_ledger` exactly like a single
        engine's."""
        return [eng.page_ledger() for eng in self.engines]

    def export_trace(self, path, profiler=None):
        """ONE Perfetto timeline for the whole fleet: every traced
        replica's recorder under its own labeled pid block
        ("replica<i> requests" / tick track / one pid per tenant), so
        N replicas x T tenants read as distinct processes on a shared
        perf_counter time base."""
        from .trace import export_chrome_trace
        recs = [(f"replica{i}", eng.trace)
                for i, eng in enumerate(self.engines)
                if eng.trace is not None]
        if not recs:
            raise ValueError(
                "no replica carries a FlightRecorder — construct the "
                "engines with trace=True to export a fleet timeline")
        return export_chrome_trace(path, recorders=recs,
                                   profiler=profiler)
