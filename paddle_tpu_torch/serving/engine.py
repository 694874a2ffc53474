"""Continuous-batching engines over the paged decoder (counterpart of
`paddle_tpu/serving/engine.py`): slot scheduling, ragged chunked-prefill
horizons, the dispatch-separate loop, the per-tick loop, prefix-cache
admission with its host KV tier, the flight recorder's hooks and
speculative decoding.

Ported: the ragged horizon loop (`_run_ragged`, the default for
k_max > 1) in the packed and the dense (`packed=False`) layout; the
dispatch-separate loop (`_run_multi`, `ragged=False` with k_max > 1: a
blocking prefill at admission, then decode-only `decode_multi`
horizons); the per-tick loop (`step` / `_run_per_tick`, k_max=1), the
in-port oracle for both; the scheduling-decision trace
(`serve_schedule`); content-addressed admission over a `PrefixCache`
(mount, copy-on-write, publish, evict), the host tier behind it
(`HostKVTier`: spill waves, priced restore or recompute) and the page
ledger with its audit; the flight recorder (`trace=`: lifecycle spans,
priced tick records, drift); `SpeculativeEngine`, greedy and sampled;
multi-LoRA (`submit(adapter=)`: per-slot adapter ids handed to every
dispatch, adapter-salted prefix-cache keys, `slot_adapters` ledger rows)
and the hooks the tenancy engine (`serving.tenancy`) overrides:
`_admission_blocked`, `_note_queue_wait` / `_note_ttft` /
`_note_resident`, and the resume-safe bookkeeping that lets a preempted
request occupy a slot again (`_emit_base`, `_release_slot`).
"""
import collections
import time
import weakref

import numpy as np
import torch

from ..cost_model import (decode_horizon, decode_tick_roofline_s,
                          kv_restore_s, measured_host_sync_s,
                          ragged_tick_legs)
from .decoder import PagedGPTDecoder, _spec_accept, pow2_at_least
from .kv_tier import HostKVTier, restore_beats_recompute
from .page_audit import audit_kv_scale_planes, audit_page_ledger
from .prefix_cache import PrefixCache
from .scheduler import RaggedScheduler
from .stats import _ENGINES, ServeStats
from .trace import FlightRecorder

__all__ = ["ContinuousBatchingEngine", "SpeculativeEngine"]

# bounded schedule-event window (`serve_schedule`): the most recent
# scheduling decisions, not the process lifetime
_SCHED_WINDOW = 4096


class ContinuousBatchingEngine:
    """Slot-based continuous batching: requests are admitted into free
    slots as soon as capacity allows, every tick serves ALL active slots,
    finished sequences free their pages.

    By default `run()` schedules RAGGED horizons: blocks of k
    device-resident ticks (`PagedGPTDecoder.ragged_multi`) in which
    decode rows emit a token per tick while newly admitted prompts stream
    in as token-budgeted chunks (`RaggedScheduler` owns the chunk/horizon
    policy). Admission only allocates pages on the host; there is no
    host-blocking prefill. The host syncs at block boundaries only, and
    each block's fetch overlaps the NEXT block's dispatch
    (one-horizon-delayed retirement: a slot finishing inside block N
    stays frozen on the device through block N+1 — its writes route to
    the scratch page — and its pages are freed exactly once, when block
    N is processed). `ragged=False` keeps the dispatch-separate loop
    (`_run_multi`: a blocking prefill at admission, then decode-only
    `decode_multi` horizons — the same streams). `k_max=1` selects the
    per-tick loop (`step()` is the per-tick API either way); `k_max=None`
    lets the scheduler (or, with `ragged=False`, the pure decode tick)
    price K (`cost_model.decode_horizon`, with `host_sync_s` the host's
    cost of a sync, measured when not given). `packed=False` serves the
    ragged horizons and the admission prefill in the dense window layout
    (default: the decoder's flag); `scheduler=` replaces the
    `RaggedScheduler`. `trace` (a `FlightRecorder`, or True for a default
    one) records lifecycle spans and priced tick records; off, every hook
    is a dead branch.

    With `prefix_cache` (a `PrefixCache`, or True for a default one
    salted by `decoder.cache_fingerprint()`) admission is
    content-addressed: a prompt's full token blocks are hashed, the
    longest cached run is MOUNTED into the request's page-table row
    host-side (the pages already hold the bytes this prompt's prefill
    would write), and only the uncached suffix is prefilled — at
    `start > 0` through the same ragged paged attention. Mounted pages
    are refcounted and never written: a full-prompt hit, whose last
    position is re-consumed for its logits, copy-on-writes the final
    page first. Retirement decrefs shared pages; refcount-0 pages park
    in the cache's LRU and are evicted only under pool pressure — every
    page freed exactly once (`page_ledger()` / `audit_pages()`).
    `host_tier` (a `HostKVTier`, or True) spills evicted pages to host
    memory in one D2H a wave; an admission whose chain continues onto
    host entries restores them (one H2D a span) or recomputes them, as
    `tier_policy` says: "auto" prices the wire against the recompute
    (`kv_tier.restore_beats_recompute`), "restore" / "recompute" pin
    the decision."""

    def __init__(self, decoder: PagedGPTDecoder, eos_token_id=None,
                 max_new_tokens=64, k_max=None, host_sync_s=None,
                 prefix_cache=None, ragged=None, chunk_tokens=None,
                 scheduler=None, trace=None, packed=None, host_tier=None,
                 tier_policy="auto"):
        if max_new_tokens < 1:
            raise ValueError(
                "max_new_tokens must be >= 1 (the prefill forward always "
                f"produces one token), got {max_new_tokens}")
        self.d = decoder
        self.eos = eos_token_id
        self.max_new = max_new_tokens
        # page 0..num_pages-2 allocatable; last page reserved as scratch
        self._free = list(range(decoder.num_pages - 2, -1, -1))
        S = decoder.max_batch
        self._slot_req = [None] * S          # request id per slot
        self._slot_pages = [[] for _ in range(S)]
        # pages a slot holds as SHARED (cache-refcounted, never written)
        self._slot_shared = [set() for _ in range(S)]
        # int32 end to end: the decoder feeds these to the kernel as int32
        self._lens = np.zeros(S, np.int32)
        self._tokens = np.zeros(S, np.int32)
        # request id per slot: the sampling key id, so a request's draws
        # do not depend on which slot, batch or schedule served it
        self._kids = np.zeros(S, np.int32)
        # LoRA adapter id per slot (only read when the decoder carries a
        # bank) and per request (ids other than 0)
        self._aids = np.zeros(S, np.int32)
        self._rid_adapter = {}
        # per-slot admission generation: a block dispatched for an earlier
        # occupancy of the slot must never book-keep against a later one —
        # the rid alone cannot tell them apart once preemption
        # (serving.tenancy) lets the SAME rid re-occupy a slot whose stale
        # block is still in flight
        self._slot_gen = [0] * S
        # rid -> output length at (re-)admission: the "first token of this
        # admission" mark. 0 for fresh requests; a preempted request
        # resumes with its generated prefix already in _outputs, and its
        # first post-resume token must NOT restamp TTFT or republish
        self._emit_base = {}
        self._table_cache = None             # rebuilt on admit/retire only
        self._queue = []                     # (req_id, ids)
        self._outputs = {}                   # req_id -> [generated ids]
        self._next_id = 0
        self.steps = 0
        self.k_max = max(1, int(k_max)) if k_max is not None else None
        self._init_cache(prefix_cache, host_tier, tier_policy)
        self._restore_s_pending = 0.0    # priced H2D awaiting a horizon
        if scheduler is None and ragged is not False and \
                (self.k_max is None or self.k_max > 1 or ragged):
            # k_max=None: the scheduler prices K (cost_model)
            scheduler = RaggedScheduler(
                decoder, chunk_tokens=chunk_tokens, k_max=self.k_max,
                host_sync_s=host_sync_s)
        self.scheduler = scheduler
        if self.k_max is None:
            if scheduler is not None:
                self.k_max = scheduler.k_max
            else:
                # the dispatch-separate loop: K priced on the PURE decode
                # tick (no chunk compute leg, no scheduler)
                self.k_max = decode_horizon(decoder.step_hbm_bytes(),
                                            host_sync_s=host_sync_s,
                                            device=decoder.device)
        self.ragged = bool(self.k_max > 1 if ragged is None else ragged)
        # the ragged horizons' (and the admission prefill's) layout: the
        # packed token stream, or the dense [S, w] window twin
        self.packed = bool(decoder.packed if packed is None else packed)
        self._prompt_len = [0] * S           # admitted prompt length/slot
        # scheduling decisions: blocking prefills and ragged horizons
        self._sched_events = collections.deque(maxlen=_SCHED_WINDOW)
        self.stats = ServeStats(
            engine=type(self).__name__, k_max=self.k_max,
            # num_pages - 1: the reserved scratch page never holds a
            # sequence's KV — capacity counts allocatable pages only
            kv_pool_bytes=(decoder.num_pages - 1) * decoder.kv_page_bytes,
            kv_bytes_per_token=decoder.kv_page_bytes // decoder.page_size)
        if self.tier is not None:
            # a warm-started tier (PrefixCache.load) already holds bytes
            self.stats.host_tier_bytes = self.tier.bytes_used
        self._submit_t = {}                  # rid -> submit wall time
        # FLIGHT RECORDER: off by default; every hook below is a dead
        # `if self.trace is not None` branch
        if trace is True:
            trace = FlightRecorder()
        self.trace = trace or None
        self._trace_price = None         # `_price_inputs`, once
        self._trace_pool_mark = (0, 0)   # (cow, evictions) marks
        self._trace_warm = set()         # dispatch shapes already run
        if self.trace is not None:
            # the host-sync price is measured now, before any dispatch:
            # pricing a tick later must not add a sync to the run
            measured_host_sync_s(decoder.device)
            self.trace.meta.update(
                engine=type(self).__name__, k_max=self.k_max,
                ragged=self.ragged, packed=self.packed,
                page_size=decoder.page_size,
                kv_quant=decoder.kv_quant or "none")
        _ENGINES.add(self)

    def _init_cache(self, prefix_cache, host_tier, tier_policy):
        """Bind the prefix cache and its host tier (see the class
        docstring). A preloaded cache (`PrefixCache.load`) must belong to
        this decoder, and its pages leave the free list; `host_tier=` may
        not replace a tier the cache already carries."""
        decoder = self.d
        if prefix_cache is True:
            prefix_cache = PrefixCache(decoder.page_size,
                                       salt=decoder.cache_fingerprint())
        if prefix_cache is not None and \
                prefix_cache.page_size != decoder.page_size:
            raise ValueError(
                f"prefix cache page_size {prefix_cache.page_size} != "
                f"decoder page_size {decoder.page_size}")
        self.cache = prefix_cache
        # identity checks, not truthiness: an EMPTY HostKVTier is falsy
        # (__len__ == 0) but very much "tier on"
        if host_tier is not None and host_tier is not False:
            if self.cache is None:
                raise ValueError(
                    "host_tier needs a prefix_cache: the tier is keyed "
                    "by the cache's chain keys (pass prefix_cache=True "
                    "for a default cache)")
            if self.cache.tier is None:
                self.cache.tier = HostKVTier() if host_tier is True \
                    else host_tier
            elif host_tier is not True and \
                    host_tier is not self.cache.tier:
                # a loaded cache may arrive with a WARM tier — silently
                # replacing it would drop the persisted host entries
                raise ValueError(
                    "prefix_cache already carries a host tier — pass "
                    "host_tier=True to keep it, or attach your tier "
                    "to the cache (PrefixCache.load(tier=...)) "
                    "instead")
        self.tier = self.cache.tier if self.cache is not None else None
        if tier_policy not in ("auto", "restore", "recompute"):
            raise ValueError(f"tier_policy must be auto/restore/"
                             f"recompute, got {tier_policy!r}")
        self.tier_policy = tier_policy
        if self.cache is not None:
            if self.cache.n_pages:
                # a populated cache's pages live in the pool of the
                # decoder it is bound to; with any other decoder (even
                # one of the same weights) its keys would mount garbage
                bound = self.cache._decoder and self.cache._decoder()
                if bound is not decoder:
                    raise ValueError(
                        "prefix_cache holds pages for a different "
                        "decoder — pass the decoder the cache was "
                        "loaded onto, or PrefixCache.load the save "
                        "dir onto THIS decoder")
                owned = set(self.cache.pages())
                self._free = [p for p in self._free if p not in owned]
            self.cache._decoder = weakref.ref(decoder)
        decoder._engines.add(self)
        self._cache_meta = {}                # rid -> (start, keys, n_hit)

    # -- flight recorder (every method below runs only with tracing on) --

    def _price_horizon(self, k, w, prefill_rows, decode_rows=0,
                       serial=False):
        """Roofline-PREDICTED wall cost of one dispatched horizon: k
        mixed ticks (`cost_model.ragged_tick_legs` priced on the tick's
        total new-token count — chunk rows at w each plus one per decode
        row) plus ONE host sync. `serial=True` prices the SERIAL sum of
        the legs instead of their overlapped max, so the drift ledger can
        tell a mispriced leg from a serialized schedule."""
        hbm, fpt, sync = self._price_inputs()
        hbm_s, compute_s = ragged_tick_legs(
            hbm, w * prefill_rows + decode_rows, fpt)
        tick = (hbm_s + compute_s) if serial else max(hbm_s, compute_s)
        return k * tick + sync

    def _price_inputs(self):
        """(step HBM bytes, matmul FLOPs a token, host sync seconds) of
        the horizon pricing, computed once (the sync was measured when
        the engine was built)."""
        if self._trace_price is None:
            self._trace_price = (self.d.step_hbm_bytes(),
                                 self._flops_per_token(),
                                 measured_host_sync_s(self.d.device))
        return self._trace_price

    def _trace_pool_delta(self):
        """Pool events since the previous tick record (CoW copies,
        evictions), folded into each tick so the trace shows WHICH
        horizon paid for cache churn."""
        cow, ev = self.stats.prefix_cow, self.stats.prefix_evictions
        d = {"cow": cow - self._trace_pool_mark[0],
             "evictions": ev - self._trace_pool_mark[1]}
        self._trace_pool_mark = (cow, ev)
        return d

    def _trace_shape_warm(self, key):
        """A dispatch shape's first run pays its one-time costs (cuBLAS
        heuristics, allocator growth) inside the measured window: its
        tick is recorded but kept OUT of the drift ledger."""
        warm = key in self._trace_warm
        self._trace_warm.add(key)
        return warm

    def _trace_admits(self, admitted, now):
        """Admit events with the prefix-cache mount detail (cached span,
        hit blocks)."""
        for slot, rid, ids, _pages in admitted:
            meta = self._cache_meta.get(rid)
            self.trace.record(
                "admit", ts=now, rid=rid, slot=slot,
                prompt_tokens=len(ids),
                cached_tokens=int(meta[0]) if meta else 0,
                hit_blocks=int(meta[2]) if meta else 0)

    def _trace_progress(self, rid):
        """Per-N-token progress mark (N = recorder.progress_every)."""
        n = len(self._outputs[rid])
        if n % self.trace.progress_every == 0:
            self.trace.record("progress", rid=rid, tokens=n)

    # -- host KV tier ----------------------------------------------------

    def _flops_per_token(self):
        """Matmul FLOPs one prompt token costs (the 2x-params GPT rule;
        the scheduler already holds it on ragged engines)."""
        if hasattr(self.scheduler, "flops_per_token"):
            return self.scheduler.flops_per_token
        return 2.0 * self.d.cfg.num_params()

    def _spill_wave(self, need, exclude=()):
        """Reclaim at least `need` parked pages, demoting the wave to the
        host tier with ONE gather + D2H per pool leaf
        (`fetch_page_payloads`). `PrefixCache.evict` only records the
        victims; the copy runs after the walk and before any freed page is
        handed out, so it reads the exact write-time bytes (and, on the
        card's stream, after every horizon already dispatched). A page
        whose key already has a host twin needs no copy: the host payload
        is still valid, only its device-twin backref clears. Returns the
        freed page ids."""
        tier = self.tier
        pending = []                     # (key, page): victims to copy

        def note(key, page):
            if tier is None:
                return
            if key in tier:
                tier.note_unmounted(key)
                self.stats.host_tier_bytes = tier.bytes_used
                return
            if self.d.kv_page_bytes > tier.capacity_bytes:
                # put() would refuse it: the capacity-0 twin pays no copy
                return
            pending.append((key, page))

        freed = self.cache.evict(need, exclude=exclude, spill=note)
        if pending:
            payloads = self.d.fetch_page_payloads([p for _, p in pending])
            for (key, page), payload in zip(pending, payloads):
                if tier.put(key, payload):
                    self.stats.tier_spills += 1
                    if self.trace is not None:
                        self.trace.record("spill", page=int(page),
                                          bytes=tier.entry_bytes(key))
            self.stats.host_tier_bytes = tier.bytes_used
        return freed

    def _tier_plan(self, keys, n_dev):
        """How far the chain continues onto the HOST tier past the
        device-resident run, and whether to restore it: (n_tier, restore,
        hold). "auto" prices `cost_model.kv_restore_s` against the span's
        prefill recompute (`restore_beats_recompute`); a losing wire
        recomputes and only refreshes the host entries' recency (their
        bytes stay valid: write-time determinism). On a restore, `hold`
        pins the span's (key, payload, bytes) here, so this admission's
        own evictions cannot LRU the payloads out of the tier before the
        restore reads them."""
        tier = self.tier
        if tier is None:
            return 0, False, None
        n_tier = 0
        while n_dev + n_tier < len(keys) and \
                keys[n_dev + n_tier] in tier:
            n_tier += 1
        if not n_tier:
            return 0, False, None
        span = keys[n_dev:n_dev + n_tier]
        restore = self.tier_policy == "restore"
        if self.tier_policy == "auto":
            restore = restore_beats_recompute(
                sum(tier.entry_bytes(k) for k in span),
                n_tier * self.d.page_size, self._flops_per_token(),
                shared=getattr(tier, "shared", False))
        hold = None
        if restore:
            hold = [(k, tier.get(k), tier.entry_bytes(k)) for k in span]
        return n_tier, restore, hold

    def _tier_recompute(self, keys, lo, n):
        """Host blocks keys[lo:lo+n] will be RE-PREFILLED: refresh their
        recency (the recomputed bytes equal the spilled ones) and count
        the decision — only once the admission commits."""
        for i in range(n):
            self.tier.touch(keys[lo + i])
        self.stats.tier_recomputes += n

    def _tier_restore(self, keys, n_dev, pages, hold, rid):
        """Re-mount `len(pages)` host-resident blocks (keys[n_dev:], their
        payloads pinned in `hold`) into freshly allocated device pages:
        ONE H2D + `index_copy_` per pool leaf for the whole span
        (`mount_page_payloads`, asynchronous on the decoder's stream, so
        every later horizon reads the restored bytes), then cache insert
        under the held parent chain and the device-twin backref for the
        audit. Returns [(page, inserted)]: a capacity-refused insert
        leaves that page (and the rest of the chain) private to the
        request. The priced H2D (`cost_model.kv_restore_s`) joins the
        next horizon's prediction (`_note_restore`) and, with tracing on,
        is recorded as an ("h2d_restore",) tick."""
        tier = self.tier
        tot_bytes = sum(nbytes for _, _, nbytes in hold[:len(pages)])
        t0 = time.perf_counter()
        self.d.mount_page_payloads(
            list(pages), [hold[i][1] for i in range(len(pages))])
        out = []
        stop = False
        for i, pid in enumerate(pages):
            key = hold[i][0]
            ok = False
            if not stop:
                parent = keys[n_dev + i - 1] if (n_dev + i) else None
                ok = self.cache.insert(key, pid, parent=parent)
                if ok:
                    tier.note_mounted(key, pid)
                else:
                    stop = True
            out.append((pid, ok))
        dt = time.perf_counter() - t0
        pred = kv_restore_s(tot_bytes, shared=getattr(tier, "shared", False))
        self.stats.tier_restores += len(pages)
        self.stats.host_tier_bytes = tier.bytes_used
        self._note_restore(pred)
        if self.trace is not None:
            self.trace.tick(
                "serve", ("h2d_restore",), dt, predicted_s=pred,
                drift=self._trace_shape_warm(("h2d_restore",)),
                rid=rid, blocks=len(pages), bytes=tot_bytes)
        return out

    def _note_restore(self, seconds):
        if hasattr(self.scheduler, "note_restore"):
            self.scheduler.note_restore(seconds)
        else:
            self._restore_s_pending += float(seconds)

    def _take_restore_s(self):
        """Pending restore H2D price, drained once per dispatched horizon
        (the mount lands inside exactly one measured window — the next
        dispatch's)."""
        if hasattr(self.scheduler, "take_restore_s"):
            return self.scheduler.take_restore_s()
        s, self._restore_s_pending = self._restore_s_pending, 0.0
        return s

    # -- requests and admission -------------------------------------------

    def submit(self, prompt_ids, adapter=None):
        """Queue one prompt (list, numpy array or tensor of token ids);
        returns its request id. `adapter` selects a LoRA variant by id
        (1..n over a bank attached with `PagedGPTDecoder.attach_adapters`;
        0/None = base weights): requests of different adapters batch into
        the same horizons, resolved per token on the device."""
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.cpu().numpy()
        ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not ids:
            raise ValueError(
                "prompt must contain at least one token (prefill "
                "samples the first generated token after the prompt's "
                "last position — an empty prompt has none)")
        aid = self._check_adapter(adapter)
        decoders = [d for d, _, _ in self._pools()]
        total = len(ids) + self.max_new + self._margin
        tokens = f"prompt {len(ids)} + max_new {self.max_new}" + (
            f" + speculation margin {self._margin}" if self._margin else "")
        need = self._pages_for(total)
        limit = min(min(d.max_pages, d.num_pages - 1) for d in decoders)
        if need > limit:
            raise ValueError(
                f"request needs {need} pages ({tokens} tokens) but the "
                f"pool allows {limit}")
        max_seq = min(d.cfg.max_seq_len for d in decoders)
        if total > max_seq:
            raise ValueError(
                f"{tokens} tokens exceeds the model's max_seq_len "
                f"{max_seq} (positions past it have no embedding)")
        return self._register_request(ids, adapter=aid)

    def _check_adapter(self, adapter):
        aid = int(adapter or 0)
        if aid and self.d.lora is None:
            raise ValueError(
                f"adapter {aid} requested but the decoder carries no LoRA "
                "bank — attach one with PagedGPTDecoder.attach_adapters")
        if aid < 0 or aid > self.d.n_adapters:
            raise ValueError(
                f"adapter id {aid} out of range: the attached bank serves "
                f"ids 0 (base) .. {self.d.n_adapters}")
        return aid

    def _register_request(self, ids, adapter=0, trace_fields=None):
        """Queue a VALIDATED request: rid allocation, queue-wait stamp,
        stats, the trace's submit record — one implementation for both
        engines' submit()s, called only after validation so a rejected
        submission leaves no trace in the stats. `trace_fields` ride into
        the submit record (the tenancy engine stamps tenant/slo there;
        the chrome exporter groups spans by it)."""
        rid = self._next_id
        self._next_id += 1
        self._submit_t[rid] = time.perf_counter()
        self.stats.requests += 1
        if adapter:
            self._rid_adapter[rid] = adapter
        self._queue.append((rid, ids))
        if self.trace is not None:
            self.trace.record("submit", ts=self._submit_t[rid], rid=rid,
                              prompt_tokens=len(ids),
                              **(trace_fields or {}))
        return rid

    def _request_max_new(self, rid):
        """Tokens this request may still emit, for admission-time page
        budgeting: max_new for a fresh request; a resumed (preempted) one
        already banked len(outputs) of them, so its resume prompt
        (original + generated prefix) plus the remainder needs exactly
        the original page total."""
        return self.max_new - len(self._outputs.get(rid, ()))

    def _pages_for(self, n_tokens):
        return (n_tokens + self.d.page_size - 1) // self.d.page_size

    # positions a request may write past its prompt + max_new budget
    _margin = 0

    def _pools(self):
        """(decoder, free list, per-slot page lists) of each page pool a
        request holds pages in: the decoder's own here."""
        return ((self.d, self._free, self._slot_pages),)

    def _note_queue_wait(self, rid, dt):
        """Queue-wait stamp hook (submit -> admit); the tenancy engine
        also banks it per tenant."""
        self.stats.queue_wait_s.append(dt)

    def _note_ttft(self, rid, dt):
        """TTFT stamp hook (submit -> first token); the tenancy engine
        also banks it per tenant."""
        self.stats.ttft_s.append(dt)

    def _note_resident(self):
        n = sum(r is not None for r in self._slot_req)
        self.stats.max_resident_slots = max(
            self.stats.max_resident_slots, n)

    def _note_admits(self, admitted):
        """Queue-wait stamps (submit -> admit) and the trace's admit
        records of one admission round."""
        now = time.perf_counter()
        for _, rid, _, _ in admitted:
            t0 = self._submit_t.get(rid)
            if t0 is not None:
                self._note_queue_wait(rid, now - t0)
        if self.trace is not None:
            self._trace_admits(admitted, now)

    def _admit(self):
        """Blocking admission (the per-tick and dispatch-separate loops):
        gather every admittable request and prefill them in one forward
        (host-blocking). Returns the slots that entered decode."""
        active0 = sum(r is not None for r in self._slot_req)
        admitted = self._gather_admissions()
        if not admitted:
            return []
        self._note_admits(admitted)
        self._table_cache = None
        firsts = self._prefill_admitted(admitted)
        self.stats.prefill_syncs += 1
        # this prefill BLOCKED the host while `active0` slots sat decoding
        self._sched_events.append(
            {"kind": "prefill_sync", "decode_active": int(active0),
             "rows": len(admitted)})
        if active0:
            self.stats.prefill_stall_syncs += 1
        self._extra_prefill(admitted)
        done_t = time.perf_counter()
        live = []
        for (slot, rid, ids, pages), first in zip(admitted, firsts):
            t0 = self._submit_t.pop(rid, None)
            if t0 is not None:
                self._note_ttft(rid, done_t - t0)
            self._outputs[rid] = [first]
            if self.trace is not None:
                self.trace.record("first_token", ts=done_t, rid=rid)
            self.stats.tokens += 1
            if (self.eos is not None and first == self.eos) \
                    or self.max_new <= 1:
                # finished at prefill: never occupy a decode slot
                self._retire(slot)
                continue
            self._lens[slot] = len(ids)
            self._tokens[slot] = first
            self._kids[slot] = rid
            self._after_admit(slot, len(ids))
            live.append(slot)
        return live

    def _prefill_admitted(self, admitted):
        """The blocking prefill of the admitted requests, in the engine's
        layout (`packed`): whole prompts without a prefix cache; with
        one, each request's uncached suffix from its `start` (the cached
        span is mounted, zero device work). Freshly computed full blocks
        are published to the cache afterwards (`.tolist()` has synced, so
        their bytes are written before any later mount reads them)."""
        reqs = []
        for _, rid, ids, pages in admitted:
            start = self._cache_meta[rid][0] if self.cache is not None \
                else 0
            reqs.append((ids[start:], start, pages))
        firsts = self.d.prefill_suffix_batch(
            reqs, kids=[rid for _, rid, _, _ in admitted],
            packed=self.packed,
            aids=[self._rid_adapter.get(rid, 0)
                  for _, rid, _, _ in admitted])
        for slot, rid, _, _ in admitted:
            self._publish_blocks(rid, slot)
        return firsts

    def _publish_blocks(self, rid, slot):
        """Publish a request's freshly computed full blocks to the prefix
        cache (the slot keeps holding the pages until retirement decrefs
        them). Called once the blocks' bytes are ordered before any future
        reader: after the prefill sync on the blocking paths, at the first
        token's block processing on the ragged path. Publishing STOPS at
        the first refused insert (a same-batch duplicate keeps its copy
        private): a deeper block would chain under a parent this request
        does not hold, breaking the every-ancestor-referenced invariant
        the eviction cascade relies on."""
        if self.cache is None:
            return
        meta = self._cache_meta.pop(rid, None)
        if meta is None:
            return
        _start, keys, n_hit = meta
        pages = self._slot_pages[slot]
        for b in range(n_hit, len(keys)):
            parent = keys[b - 1] if b else None
            if not self.cache.insert(keys[b], pages[b], parent=parent):
                break
            self._slot_shared[slot].add(pages[b])

    def _occupy(self, slot, rid):
        """Bind `rid` to `slot` (both admission paths): the request id, its
        adapter id for the dispatch-side aids row, and the slot generation
        stamp the stale-block check compares."""
        self._slot_req[slot] = rid
        self._aids[slot] = self._rid_adapter.get(rid, 0)
        self._slot_gen[slot] += 1

    def _admission_blocked(self, rid, need):
        """The queue head cannot get its pages: True = wait (head-of-line).
        The tenancy engine overrides it with preemption by page-spill —
        parking a throughput victim's KV in the prefix cache frees or
        parks enough pages that the admission can replan (False)."""
        return True

    def _gather_admissions(self):
        """Bind queued requests to free slots in order while their pages
        fit (head-of-line: a request that does not fit waits, and so do
        the ones behind it, unless `_admission_blocked` makes room)."""
        if self.cache is not None:
            return self._gather_admissions_cached()
        admitted = []
        pools = self._pools()
        blocked = False
        for slot in range(self.d.max_batch):
            if blocked:
                break
            if self._slot_req[slot] is not None or not self._queue:
                continue
            while True:
                rid, ids = self._queue[0]
                need = self._pages_for(len(ids) + self._request_max_new(rid)
                                       + self._margin)
                if any(need > d.max_pages for d, _, _ in pools):
                    blocked = True           # permanently oversized head
                    break
                if any(need > len(free) for _, free, _ in pools):
                    if self._admission_blocked(rid, need):
                        blocked = True       # head-of-line: wait
                        break
                    # tenancy made room (a victim's pages freed): replan
                    # THIS slot
                    continue
                self._queue.pop(0)
                for _, free, held in pools:
                    held[slot] = [free.pop() for _ in range(need)]
                self._occupy(slot, rid)
                admitted.append((slot, rid, ids, self._slot_pages[slot]))
                break
        return admitted

    def _gather_admissions_cached(self):
        """Prefix-cache admission: hash the prompt's full blocks, mount
        the longest cached run into the page-table row (incref), evict
        parked refcount-0 pages if the free list cannot cover the rest,
        and record (start, keys, n_hit) for the suffix prefill. A
        FULL-prompt hit still needs its last position's logits: the one
        re-consumed token would write into the final mounted page, so
        that page is copied to a private page first (copy-on-write; the
        rewritten bytes are the same, prefill being position-local).

        With a host tier the chain may continue past the device run onto
        host entries (`_tier_plan`): restored blocks join the hit span
        and cost a device page each; recomputed ones prefill as misses.
        The mounted span degrades (restored blocks first) until the pool
        can cover the admission: mounted hits are excluded from eviction,
        so a full-span mount could otherwise block itself forever."""
        admitted = []
        blocked = False
        ps = self.d.page_size
        tok_bytes = self.d.kv_page_bytes // ps
        for slot in range(self.d.max_batch):
            if blocked:
                break
            if self._slot_req[slot] is not None or not self._queue:
                continue
            while True:
                rid, ids = self._queue[0]
                L = len(ids)
                total = self._pages_for(L + self._request_max_new(rid))
                if total > self.d.max_pages:
                    blocked = True           # permanently oversized head
                    break
                keys = self.cache.block_keys(
                    ids, extra_salt=self.d.adapter_salt(
                        self._rid_adapter.get(rid, 0)))
                hits = self.cache.match(keys)
                n_dev = len(hits)
                n_tier, do_restore, hold = self._tier_plan(keys, n_dev)
                span = n_dev + (n_tier if do_restore else 0)
                chosen = None
                for n_hit in range(span, -1, -1):
                    start = n_hit * ps
                    # full hit: re-consume the last token
                    cow = n_hit > 0 and start >= L
                    if cow:
                        start = L - 1
                    n_rest = max(0, n_hit - n_dev)
                    need_new = total - n_hit + (1 if cow else 0) + n_rest
                    if need_new <= len(self._free) + self.cache.evictable(
                            exclude=keys[:n_hit]):
                        chosen = (n_hit, start, cow, need_new, n_rest)
                        break
                if chosen is None:
                    if self._admission_blocked(rid, total):
                        blocked = True       # head-of-line: wait for pages
                        break
                    # tenancy made room (a victim's pages parked or
                    # freed): replan THIS slot from scratch
                    continue
                n_hit, start, cow, need_new, n_rest = chosen
                hits = hits[:n_hit - n_rest]
                self._queue.pop(0)
                if n_tier:
                    # recompute-decided host blocks, plus any restore span the
                    # loop above degraded away, are re-prefilled
                    lo = max(n_hit, n_dev)
                    n_recomp = n_dev + n_tier - lo
                    if n_recomp:
                        self._tier_recompute(keys, lo, n_recomp)
                self.cache.mount(keys[:len(hits)])
                if len(self._free) < need_new:
                    freed = self._spill_wave(need_new - len(self._free))
                    self.stats.prefix_evictions += len(freed)
                    self._free.extend(freed)
                privates = [self._free.pop() for _ in range(need_new)]
                keys_meta = keys
                inserted = {}
                if n_rest:
                    rest_pages = [privates.pop() for _ in range(n_rest)]
                    inserted = dict(self._tier_restore(keys, len(hits),
                                                       rest_pages, hold, rid))
                    if not all(inserted.values()):
                        # a refused restore insert breaks the held chain:
                        # publish nothing deeper for this request
                        keys_meta = keys[:len(hits)]
                    hits = hits + rest_pages
                shared = list(hits)
                shared_set = set(shared[:n_hit - n_rest]) | \
                    {p for p, ok in inserted.items() if ok}
                if cow:
                    last = shared[-1]
                    if last in shared_set:
                        dst = privates.pop()
                        self.d.copy_page(last, dst)
                        self.cache.release_page(last)
                        self.stats.prefix_cow += 1
                        shared_set.discard(last)
                        shared[-1] = dst
                    else:
                        # the final block is a restore whose insert was
                        # refused: already private, return the spare page
                        self._free.append(privates.pop())
                pages = shared + privates        # block order: prefix first
                self._occupy(slot, rid)
                self._slot_pages[slot] = pages
                self._slot_shared[slot] = shared_set
                self._cache_meta[rid] = (start, keys_meta, n_hit)
                self.stats.prefix_hits += n_hit
                self.stats.prefix_misses += len(keys) - n_hit
                self.stats.prefix_tokens_saved += start
                self.stats.prefix_bytes_saved += start * tok_bytes
                admitted.append((slot, rid, ids, pages))
                break
        return admitted

    def _extra_prefill(self, admitted):
        """Hook after the blocking prefill (`SpeculativeEngine`: the
        draft's prefill)."""

    def _after_admit(self, slot, prompt_len):
        """Hook for a slot entering decode (`SpeculativeEngine`: the
        draft's length)."""

    def _retire(self, slot):
        """Give back the slot's pages — a shared page drops this request's
        cache reference (the cache still owns it, parked at refcount 0),
        a private one returns to the free list — and clear every per-slot
        field (the generation bump makes any in-flight block of this
        occupancy stale)."""
        if self.trace is not None:
            rid = self._slot_req[slot]
            self.trace.record("retire", rid=rid,
                              tokens=len(self._outputs.get(rid, ())))
        shared = self._slot_shared[slot]
        for pid in self._slot_pages[slot]:
            if pid in shared:
                self.cache.release_page(pid)
            else:
                self._free.append(pid)
        rid = self._slot_req[slot]
        self._rid_adapter.pop(rid, None)
        self._emit_base.pop(rid, None)
        self._release_slot(slot)
        self.stats.completed += 1

    def _release_slot(self, slot):
        """Clear every per-slot field — retirement AND preemption (tenancy)
        share this one sequence, so a field added for one cannot go stale
        under the other (the generation bump, the adapter id and the
        scheduler's retire all ride here)."""
        self._slot_shared[slot] = set()
        self._slot_req[slot] = None
        self._slot_pages[slot] = []
        self._slot_gen[slot] += 1
        self._lens[slot] = 0
        self._tokens[slot] = 0
        self._aids[slot] = 0
        self._prompt_len[slot] = 0
        if self.scheduler is not None:
            self.scheduler.retire(slot)
        self._table_cache = None

    def page_ledger(self):
        """Auditable snapshot of page ownership: the free list, each
        slot's pages and the shared ones among them, the cache's
        refcounts and parked pages, and the host tier's entries with
        their device twins (`audit_pages` checks it)."""
        return {
            "num_pages": self.d.num_pages,
            "scratch": self.d.num_pages - 1,
            "free": list(self._free),
            "slots": {s: list(p)
                      for s, p in enumerate(self._slot_pages) if p},
            "shared": {s: sorted(sh)
                       for s, sh in enumerate(self._slot_shared) if sh},
            "cache": self.cache.ledger() if self.cache else {},
            # multi-LoRA rows: each occupied slot's adapter id and cache-key
            # salt (hex) — the audit's cross-variant aliasing check
            "slot_adapters": {
                s: {"adapter": int(self._aids[s]),
                    "salt": self.d.adapter_salt(int(self._aids[s])).hex()}
                for s in range(self.d.max_batch)
                if self._slot_req[s] is not None
            } if self.d.lora is not None else {},
            "host": self.tier.ledger() if self.tier is not None else {},
        }

    def audit_pages(self):
        """The MEM-PAGE-REFCOUNT audit of the live ledger; returns the
        findings (empty = every page owned exactly once). A quantized
        pool's held and cached pages are also checked for scale planes
        under their bytes (a copy that moved the bytes without the scales
        dequantizes to garbage)."""
        findings = audit_page_ledger(self.page_ledger())
        if self.d.kv_quant:
            held = {p for pg in self._slot_pages for p in pg}
            if self.cache is not None:
                held |= set(self.cache.pages())
            findings += audit_kv_scale_planes(self.d, sorted(held))
        return findings

    def _table(self, pages_per_slot, decoder):
        """Page table of `decoder` with inactive/unused entries routed to
        its reserved scratch page (their discarded KV writes must never
        land in allocatable pages)."""
        t = np.full((decoder.max_batch, decoder.max_pages),
                    decoder.num_pages - 1, np.int32)
        for s, pg in enumerate(pages_per_slot):
            if pg:
                t[s, :len(pg)] = pg
        return t

    # -- the per-tick loop ---------------------------------------------------

    def step(self):
        """Admit + one decode tick. Returns number of active slots."""
        self._admit()
        active = [s for s in range(self.d.max_batch)
                  if self._slot_req[s] is not None]
        if not active:
            return 0
        if self._table_cache is None:        # slots changed since last tick
            self._table_cache = self._table(self._slot_pages, self.d)
        nxt = self.d.decode(self._tokens, self._lens, self._table_cache,
                            kids=self._kids, aids=self._aids).cpu().numpy()
        self.steps += 1
        self.stats.ticks += 1
        self.stats.decode_syncs += 1
        # pad ledger: the tick computed every batch row (one position
        # each); only the active rows' positions were real work
        self.stats.tokens_dispatched += self.d.max_batch
        self.stats.tokens_padded += self.d.max_batch - len(active)
        self.stats.occupancy.append(len(active) / self.d.max_batch)
        self._note_resident()
        for s in active:
            rid = self._slot_req[s]
            tok = int(nxt[s])
            self._outputs[rid].append(tok)
            self.stats.tokens += 1
            if self.trace is not None:
                self._trace_progress(rid)
            self._lens[s] += 1
            self._tokens[s] = tok
            if (self.eos is not None and tok == self.eos) or \
                    len(self._outputs[rid]) >= self.max_new:
                self._retire(s)
        return len(active)

    def run(self, step_times=None, on_sync=None):
        """Drain the queue; returns {request_id: generated token list}.
        `step_times`, if given, receives wall seconds per host sync (per
        tick on the per-tick path, per horizon on the multi-tick paths).
        `on_sync(engine)` is called after every processed host sync and
        may `submit()` new requests."""
        if self.ragged:
            return self._run_ragged(step_times, on_sync)
        if self.k_max <= 1:
            return self._run_per_tick(step_times, on_sync)
        return self._run_multi(step_times, on_sync)

    def serve_schedule(self):
        """The recent scheduling-decision trace (bounded window): one
        event per host-blocking prefill ("prefill_sync", with the decode
        slots it stalled) and per ragged horizon ("horizon", with its k/w
        and row mix). A prefill_sync with decode_active > 0 is the stall
        the ragged path exists to remove."""
        return list(self._sched_events)

    def _run_per_tick(self, step_times=None, on_sync=None):
        """Per-tick loop: one tick, one host sync per token."""
        while self._queue or any(r is not None for r in self._slot_req):
            t0 = time.perf_counter()
            before = self.stats.tokens
            before_p = self.stats.prefill_syncs
            active = self.step()
            dt = time.perf_counter() - t0
            if step_times is not None:
                step_times.append(dt)
            n = self.stats.tokens - before
            # a restore on this blocking path always rides a
            # prefill-polluted window, which the drift ledger excludes
            self._take_restore_s()
            clean = self.stats.prefill_syncs == before_p
            if self.trace is not None and active:
                # a step that contained a blocking prefill is not a decode
                # tick: it is recorded unpriced, outside the drift ledger
                warm = self._trace_shape_warm(("tick",))
                self.trace.tick(
                    "serve", ("tick", 1, 1), dt, ts=t0,
                    predicted_s=(self._price_horizon(
                        1, 1, 0, decode_rows=active) if clean else None),
                    predicted_serial_s=(self._price_horizon(
                        1, 1, 0, decode_rows=active, serial=True)
                        if clean else None),
                    drift=clean and warm, k=1, w=1,
                    decode_rows=active, prefill_rows=0, tokens=n,
                    tokens_dispatched=self.d.max_batch,
                    tokens_padded=self.d.max_batch - active,
                    pool=self._trace_pool_delta())
            # steady-state decode latency only: a sync that contained a
            # prefill would turn p99 into a prefill number
            if n and clean:
                self.stats.token_time_s.extend([dt / n] * n)
            if on_sync is not None:
                on_sync(self)
        return dict(self._outputs)

    def _budget_left(self, slot):
        """Tokens this slot may still emit (host view, excludes ticks
        already dispatched but not yet processed)."""
        return self.max_new - len(self._outputs[self._slot_req[slot]])

    # -- the dispatch-separate loop (ragged=False, k_max > 1) --------------

    def _horizon(self, slots, inflight):
        """Largest power-of-two tick count <= k_max that fits every
        dispatchable slot's remaining budget."""
        rem = min(self._budget_left(s) - inflight[s] for s in slots)
        k = 1
        while k * 2 <= min(rem, self.k_max):
            k *= 2
        return k

    def _merge_carry(self, carry, admitted):
        """Device-resident decode state (tokens, lens, done, remaining)
        for the next horizon. Newly admitted slots are scattered into the
        in-flight tensors with device ops; the carry never round-trips
        through the host."""
        S = self.d.max_batch
        dev = self.d.device
        if carry is None:
            done = np.array([r is None for r in self._slot_req])
            rem = np.array([self._budget_left(s) if self._slot_req[s]
                            is not None else 0 for s in range(S)],
                           np.int32)
            return tuple(torch.tensor(a, device=dev) for a in
                         (self._tokens, self._lens, done, rem))
        if not admitted:
            return carry
        idx = (torch.as_tensor(admitted, dtype=torch.long, device=dev),)
        new = (self._tokens[admitted], self._lens[admitted],
               np.zeros(len(admitted), bool),
               np.array([self._budget_left(s) for s in admitted],
                        np.int32))
        return tuple(c.index_put(idx, torch.as_tensor(v, device=dev))
                     for c, v in zip(carry, new))

    def _process_block(self, meta, inflight, step_times,
                       prefilled_since=False, trace_ev=None):
        """Fetch + bookkeep one finished decode horizon (called AFTER the
        next horizon is dispatched, so the device->host wait overlaps
        it)."""
        block_d, done_before_d, k, rids, t0, had_prefill = meta
        block = block_d.cpu().numpy()
        done_before = done_before_d.cpu().numpy()
        self.stats.decode_syncs += 1
        # pad ledger: the fused loop computed k*S positions; frozen rows'
        # ticks (done_before True) were filler
        disp_toks = k * self.d.max_batch
        pad_toks = int(done_before.sum())
        self.stats.tokens_dispatched += disp_toks
        self.stats.tokens_padded += pad_toks
        emitted = 0
        for s, rid in rids.items():
            inflight[s] = max(0, inflight[s] - k)
            if self._slot_req[s] != rid:
                continue
            for j in range(k):
                if done_before[j, s]:
                    break
                tok = int(block[j, s])
                self._outputs[rid].append(tok)
                self.stats.tokens += 1
                emitted += 1
                if self.trace is not None:
                    self._trace_progress(rid)
                self._lens[s] += 1
                self._tokens[s] = tok
                if (self.eos is not None and tok == self.eos) or \
                        len(self._outputs[rid]) >= self.max_new:
                    self._retire(s)
                    break
        dt = time.perf_counter() - t0
        if step_times is not None:
            step_times.append(dt)
        if trace_ev is not None:
            # a window that held a prefill, the shape's first dispatch, or
            # another shape's first dispatch inside this still-open
            # window stays out of the drift ledger
            self.trace.tick_complete(
                trace_ev, dt, tokens=emitted,
                tokens_dispatched=disp_toks, tokens_padded=pad_toks,
                drift=(not (had_prefill or prefilled_since)
                       and trace_ev.get("warm_shape", True)
                       and not trace_ev.get("compiled_in_window")),
                pool=self._trace_pool_delta())
        # steady-state decode latency only: a prefill in the block's
        # dispatch round or before its processing is kept out
        if emitted and not had_prefill and not prefilled_since:
            self.stats.token_time_s.extend([dt / emitted] * emitted)

    def _run_multi(self, step_times=None, on_sync=None):
        """Dispatch-separate drain: admission runs the blocking prefill,
        then one K-tick decode-only horizon (`decode_multi`) is
        dispatched and the PREVIOUS horizon processed while it runs.
        Retirement is one horizon delayed — a slot finishing inside block
        N stays frozen on the device through block N+1 (its K/V writes
        route to the scratch page) and its pages are freed exactly once,
        when block N's results land on the host."""
        S = self.d.max_batch
        pending = None               # the in-flight horizon's meta
        pending_ev = None            # its open tick record (trace on)
        carry = None                 # device (tokens, lens, done, rem)
        inflight = [0] * S           # dispatched-not-yet-processed ticks
        while (self._queue or pending is not None
               or any(r is not None for r in self._slot_req)):
            t0 = time.perf_counter()
            before_p = self.stats.prefill_syncs
            admitted = self._admit()
            # a prefill ran iff the sync counter moved (a round whose
            # admissions all finish at prefill admits no decode slot)
            prefilled = self.stats.prefill_syncs != before_p
            for s in admitted:
                # a fresh request starts from a clean carry: ticks still
                # in flight for the slot's previous request do not gate it
                inflight[s] = 0
            carry = self._merge_carry(carry, admitted)
            # a live slot left out here is already frozen on the device
            # (its device `remaining` is budget_left - inflight == 0)
            disp = [s for s in range(S) if self._slot_req[s] is not None
                    and self._budget_left(s) - inflight[s] > 0]
            meta = None
            meta_ev = None
            if disp:
                k = self._horizon(disp, inflight)
                if self._table_cache is None:
                    self._table_cache = self._table(self._slot_pages,
                                                    self.d)
                tokens_d, lens_d, done_d, rem_d = carry
                out = self.d.decode_multi(
                    tokens_d, lens_d, self._table_cache, k,
                    kids=self._kids, done=done_d, remaining=rem_d,
                    eos=self.eos, aids=self._aids)
                carry = (out.tokens, out.lens, out.done, out.remaining)
                self.steps += k
                self.stats.ticks += k
                self.stats.occupancy.append(len(disp) / S)
                self._note_resident()
                for s in disp:
                    inflight[s] += k
                meta = (out.tokens_block, out.done_before, k,
                        {s: self._slot_req[s] for s in disp}, t0,
                        prefilled)
                # a restore dispatched this round lands inside THIS
                # horizon's window (drained even when untraced)
                restore_s = self._take_restore_s()
                if self.trace is not None:
                    meta_ev = self.trace.tick_dispatch(
                        "serve", ("decode", k, 1), ts=t0,
                        predicted_s=self._price_horizon(
                            k, 1, 0, decode_rows=len(disp)) + restore_s,
                        predicted_serial_s=self._price_horizon(
                            k, 1, 0, decode_rows=len(disp), serial=True)
                        + restore_s,
                        k=k, w=1, decode_rows=len(disp), prefill_rows=0,
                        warm_shape=self._trace_shape_warm(("decode", k)))
                    if pending_ev is not None and \
                            not meta_ev["warm_shape"]:
                        # this first dispatch ran inside the PENDING
                        # tick's still-open window
                        pending_ev["compiled_in_window"] = True
            if pending is not None:
                self._process_block(pending, inflight, step_times,
                                    prefilled_since=prefilled,
                                    trace_ev=pending_ev)
                if on_sync is not None:
                    on_sync(self)
            pending = meta
            pending_ev = meta_ev
        return dict(self._outputs)

    # -- ragged scheduling (chunked prefill INSIDE the decode horizon) --

    def _admit_ragged(self):
        """Admission without a prefill dispatch: mount the prefix-cache
        span (zero device work), allocate pages and hand the uncached
        suffix to the SCHEDULER — it streams into the horizon w tokens per
        tick from the device-resident pend carry, from position `start`.
        Returns [(slot, rid, suffix), ...] for the carry merge."""
        admitted = self._gather_admissions()
        if not admitted:
            return []
        self._note_admits(admitted)
        self._table_cache = None
        plans = []
        for slot, rid, ids, _pages in admitted:
            start = self._cache_meta[rid][0] if self.cache is not None \
                else 0
            suffix = ids[start:]
            # setdefault: a RESUMED request (tenancy preemption) keeps its
            # generated prefix — the continuation appends to it
            self._outputs.setdefault(rid, [])
            self._lens[slot] = start
            self._tokens[slot] = 0
            self._kids[slot] = rid
            self._prompt_len[slot] = len(ids)
            self._after_admit(slot, len(ids))
            self.scheduler.admit(slot, len(suffix))
            self.stats.prefill_chunk_tokens += len(suffix)
            plans.append((slot, rid, suffix))
        return plans

    def _first_token(self, rid, slot):
        """A request's FIRST token just landed on the host: stamp TTFT
        (submit -> first token, however many horizons the prefill
        spanned) and publish its freshly computed cache blocks (the
        horizon that wrote them precedes, on the card's stream, every
        later mount's reads and any spill's copy)."""
        t0 = self._submit_t.pop(rid, None)
        if t0 is not None:
            self._note_ttft(rid, time.perf_counter() - t0)
        if self.trace is not None:
            self.trace.record("first_token", rid=rid)
        self._publish_blocks(rid, slot)
        # prompt fully consumed; the emitted token is not consumed yet
        self._lens[slot] = self._prompt_len[slot]

    def _merge_carry_ragged(self, carry, plans):
        """Device-resident mixed-horizon state (tokens, lens, done,
        remaining, pend, pend_n). Newly admitted slots are scattered into
        the in-flight tensors with device ops; the carry never
        round-trips through the host."""
        S = self.d.max_batch
        P = self.d.pend_capacity
        dev = self.d.device
        if carry is None:
            done = np.array([r is None for r in self._slot_req])
            rem = np.array([self._budget_left(s) if self._slot_req[s]
                            is not None else 0 for s in range(S)],
                           np.int32)
            pend = np.zeros((S, P), np.int32)
            pend_n = np.zeros(S, np.int32)
            for slot, _rid, suffix in plans:
                pend[slot, :len(suffix)] = suffix
                pend_n[slot] = len(suffix)
            return tuple(torch.as_tensor(a, device=dev) for a in
                         (self._tokens, self._lens, done, rem, pend, pend_n))
        if not plans:
            return carry
        slots = [s for s, _, _ in plans]
        rows = np.zeros((len(plans), P), np.int32)
        ns = np.zeros(len(plans), np.int32)
        for r, (_slot, _rid, suffix) in enumerate(plans):
            rows[r, :len(suffix)] = suffix
            ns[r] = len(suffix)
        idx = (torch.as_tensor(slots, dtype=torch.long, device=dev),)
        new = (self._tokens[slots], self._lens[slots],
               np.zeros(len(slots), bool),
               np.array([self._budget_left(s) for s in slots], np.int32),
               rows, ns)
        return tuple(c.index_put(idx, torch.as_tensor(v, device=dev))
                     for c, v in zip(carry, new))

    def _process_ragged_block(self, meta, inflight, step_times,
                              trace_ev=None):
        """Fetch + bookkeep one finished mixed horizon (called AFTER the
        next horizon is dispatched, so the device->host wait overlaps
        it). The per-tick `emitted` mask separates real tokens from
        filler ticks and from mid-prefill chunk ticks; a request's first
        emitted token stamps TTFT."""
        block_d, emitted_d, real_d, disp_toks, k, rids, emit_ticks, t0 = \
            meta
        block = block_d.cpu().numpy()
        emitted = emitted_d.cpu().numpy()
        # pad ledger: dispatched is the horizon's layout cost (k * the
        # packed t_tokens bucket, or k*S*w dense); real is the device's
        # per-tick count
        pad_toks = disp_toks - int(real_d.sum())
        self.stats.tokens_dispatched += disp_toks
        self.stats.tokens_padded += pad_toks
        self.stats.decode_syncs += 1
        n_emitted = 0
        for s, (rid, gen) in rids.items():
            if self._slot_req[s] != rid or self._slot_gen[s] != gen:
                # stale block of a retired/re-admitted slot: its emit
                # ticks were already discarded by the inflight reset at
                # re-admission. The generation matters beyond the rid:
                # preemption (tenancy) can resume the SAME rid into the
                # same slot while its pre-preemption block is in flight —
                # those tokens are regenerated after the resume
                continue
            inflight[s] = max(0, inflight[s] - emit_ticks.get(s, 0))
            for j in range(k):
                if not emitted[j, s]:
                    continue
                tok = int(block[j, s])
                if len(self._outputs[rid]) == self._emit_base.get(rid, 0):
                    # first token of THIS admission (a resume's _submit_t
                    # is long popped: no second TTFT)
                    self._first_token(rid, s)
                else:
                    self._lens[s] += 1
                self._outputs[rid].append(tok)
                self.stats.tokens += 1
                n_emitted += 1
                if self.trace is not None:
                    self._trace_progress(rid)
                self._tokens[s] = tok
                if (self.eos is not None and tok == self.eos) or \
                        len(self._outputs[rid]) >= self.max_new:
                    self._retire(s)
                    break
        dt = time.perf_counter() - t0
        if step_times is not None:
            step_times.append(dt)
        if trace_ev is not None:
            # a shape's first dispatch (or another's inside this still-
            # open window) stays out of the drift ledger; steady ragged
            # windows ARE the honest tick, chunk cost included
            self.trace.tick_complete(
                trace_ev, dt, tokens=n_emitted,
                tokens_dispatched=disp_toks, tokens_padded=pad_toks,
                drift=(trace_ev.get("warm_shape", True)
                       and not trace_ev.get("compiled_in_window")),
                pool=self._trace_pool_delta())
        if n_emitted:
            self.stats.token_time_s.extend([dt / n_emitted] * n_emitted)

    def _table_width(self, live, plan, inflight):
        """Page-table columns this horizon can actually touch: the max over
        live slots of the position bound it may read or write, bucketed
        to a power of two. Trailing table entries hold only causally
        masked pages — an exact no-op in the online softmax — so slicing
        them off changes no output bit while early chunk ticks of a long
        prompt walk a short table."""
        ps = self.d.page_size
        bound = 1
        for s, rid in live.items():
            if self.scheduler.prefilling(s):
                # suffix_left was already decremented by plan(): positions
                # consumed after this horizon, plus k emitted tokens if
                # the prompt finishes inside it
                pos = (self._prompt_len[s]
                       - self.scheduler.suffix_left(s) + plan.k + 1)
            else:
                # NOT host _lens: it lags at 0 until the first token is
                # PROCESSED, while the device may already sit at
                # prompt_len + in-flight emissions. Outputs count from
                # this ADMISSION's base: a resumed request's earlier
                # tokens are already inside _prompt_len
                pos = (self._prompt_len[s]
                       + len(self._outputs.get(rid, ()))
                       - self._emit_base.get(rid, 0)
                       + inflight[s] + plan.k + 2)
            bound = max(bound, pos)
        need = min(self.d.max_pages, (bound + ps - 1) // ps + 1)
        width = 1
        while width < need:
            width *= 2
        return min(width, self.d.max_pages)

    def _run_ragged(self, step_times=None, on_sync=None):
        """Mixed-horizon drain: every scheduling round admits queued
        prompts STRAIGHT into the device carry (page allocation only — no
        prefill dispatch, no prefill sync), dispatches one `ragged_multi`
        block of k ticks in which decode rows emit a token per tick while
        prefilling rows consume w prompt tokens per tick, and processes
        the PREVIOUS block while the new one runs. Retirement is one
        horizon delayed: pages are freed exactly once, when the block
        that finished the request is processed."""
        S = self.d.max_batch
        sched = self.scheduler
        pending = None               # the in-flight horizon's meta
        pending_ev = None            # its open tick record (trace on)
        carry = None                 # (tokens, lens, done, rem, pend, pend_n)
        inflight = [0] * S           # in-flight EMISSION ticks per slot
        while (self._queue or pending is not None
               or any(r is not None for r in self._slot_req)):
            t0 = time.perf_counter()
            plans = self._admit_ragged()
            for slot, _, _ in plans:
                # fresh request in a recycled slot: stale in-flight ticks
                # belong to the PREVIOUS request and must not gate this one
                inflight[slot] = 0
            carry = self._merge_carry_ragged(carry, plans)
            live = {s: self._slot_req[s] for s in range(S)
                    if self._slot_req[s] is not None}
            meta = None
            meta_ev = None
            plan = sched.plan(live,
                              {s: self._budget_left(s) for s in live},
                              inflight) if live else None
            if plan is not None:
                if self._table_cache is None:
                    self._table_cache = self._table(self._slot_pages,
                                                    self.d)
                tokens_d, lens_d, done_d, rem_d, pend_d, pend_n_d = carry
                width = self._table_width(live, plan, inflight)
                t_tokens = plan.t_tokens
                if self.packed and t_tokens is None:
                    # a custom scheduler may plan without t_tokens: the
                    # dense-equivalent bucket, so the dispatch and the pad
                    # ledger price the SAME layout
                    t_tokens = pow2_at_least(S * max(plan.w, 1))
                out = self.d.ragged_multi(
                    tokens_d, lens_d,
                    np.ascontiguousarray(self._table_cache[:, :width]),
                    plan.k, plan.w, pend_d, pend_n_d, kids=self._kids,
                    done=done_d, remaining=rem_d, eos=self.eos,
                    packed=self.packed, t_tokens=t_tokens, aids=self._aids)
                carry = (out.tokens, out.lens, out.done, out.remaining,
                         out.pend, out.pend_n)
                self.steps += plan.k
                self.stats.ticks += plan.k
                self.stats.prefill_chunks += plan.n_chunks
                self.stats.occupancy.append(len(live) / S)
                self._note_resident()
                for s, e in plan.emit_ticks.items():
                    inflight[s] += e
                # layout cost of this dispatch: the packed path pays the
                # total-token bucket per tick, the dense twin the full
                # [S, w] window grid
                disp_toks = plan.k * (t_tokens if self.packed
                                      else S * plan.w)
                self._sched_events.append(
                    {"kind": "horizon", "k": plan.k, "w": plan.w,
                     "t_tokens": t_tokens if self.packed else None,
                     "decode_rows": len(live) - plan.prefill_rows,
                     "prefill_rows": plan.prefill_rows})
                meta = (out.tokens_block, out.emitted, out.real,
                        disp_toks, plan.k,
                        {s: (rid, self._slot_gen[s])
                         for s, rid in live.items()},
                        plan.emit_ticks, t0)
                # restores dispatched at this round's admission are ordered
                # before this horizon's reads: their priced H2D belongs to
                # this window's prediction (drained even when untraced)
                restore_s = self._take_restore_s()
                if self.trace is not None:
                    decode_rows = len(live) - plan.prefill_rows
                    shape = (("packed", plan.k, t_tokens) if self.packed
                             else ("ragged", plan.k, plan.w))
                    meta_ev = self.trace.tick_dispatch(
                        "serve", shape, ts=t0,
                        predicted_s=self._price_horizon(
                            plan.k, plan.w, plan.prefill_rows,
                            decode_rows=decode_rows) + restore_s,
                        predicted_serial_s=self._price_horizon(
                            plan.k, plan.w, plan.prefill_rows,
                            decode_rows=decode_rows, serial=True)
                        + restore_s,
                        k=plan.k, w=plan.w, decode_rows=decode_rows,
                        prefill_rows=plan.prefill_rows,
                        warm_shape=self._trace_shape_warm(
                            shape + (width,)))
                    if pending_ev is not None and \
                            not meta_ev["warm_shape"]:
                        # see _run_multi: the first dispatch ran in the
                        # pending tick's still-open window
                        pending_ev["compiled_in_window"] = True
            if pending is not None:
                self._process_ragged_block(pending, inflight, step_times,
                                           trace_ev=pending_ev)
                if on_sync is not None:
                    on_sync(self)
            pending = meta
            pending_ev = meta_ev
        return dict(self._outputs)


class SpeculativeEngine(ContinuousBatchingEngine):
    """Speculative decoding over the paged engine (the JAX
    `SpeculativeEngine`): a small DRAFT decoder proposes k tokens with k
    device-resident decode ticks (`decode_multi`); the TARGET scores all
    of them in ONE verify window (`PagedGPTDecoder.verify`, W = k + 1).
    Greedy configs accept the longest matching prefix plus the target's
    token at the first mismatch — exactly the target's greedy stream;
    sampled configs (the same temperature / top-k / top-p on both
    decoders) accept by rejection sampling (`_spec_accept`, host numpy
    draws from a per-(seed, target call, slot) generator), so emitted
    tokens are distributed as target-only sampling. Paged KV makes
    rollback free: `lens` is the source of truth, rejected positions are
    overwritten. Each pool holds its own pages (twin page pools), every
    admission with a +k margin (a verify window writes up to k positions
    past the accepted length). Acceptance is capped at k-1 drafts so the
    draft cache (which holds proposals d1..d_{k-1}) never falls behind.
    Runs the per-tick loop (`step()`); no prefix cache, no quantized
    pools, no adapters."""

    def __init__(self, decoder, draft_decoder, eos_token_id=None,
                 max_new_tokens=64, k=4, trace=None):
        if decoder.sampling != draft_decoder.sampling:
            raise ValueError(
                "speculative decoding needs the SAME sampling config on "
                "target and draft (acceptance compares their masked "
                f"distributions): {decoder.sampling} vs "
                f"{draft_decoder.sampling}")
        if draft_decoder.max_batch != decoder.max_batch or \
                draft_decoder.page_size != decoder.page_size:
            raise ValueError("draft/target max_batch and page_size must match")
        if decoder.lora is not None or draft_decoder.lora is not None:
            # the verify window runs the base weights only
            raise ValueError(
                "SpeculativeEngine does not support LoRA adapter banks: "
                "the verify window does not gather adapters")
        if decoder.kv_quant or draft_decoder.kv_quant:
            # verify windows write up to k positions past the accepted
            # length; the twin-pool rollback of quantized bytes + scales
            # is unproven — refuse rather than risk a silent drift
            quant = decoder.kv_quant or draft_decoder.kv_quant
            raise ValueError(
                f"SpeculativeEngine does not support quantized KV pools "
                f"(kv_quant={quant!r}; int8 and int4 alike): use "
                "ContinuousBatchingEngine, or plain bf16 pools for "
                "speculation")
        # k_max=1: the verify cadence IS this engine's horizon
        super().__init__(decoder, eos_token_id, max_new_tokens, k_max=1,
                         trace=trace)
        self.draft = draft_decoder
        self.k = int(k)
        self._draft_free = list(range(draft_decoder.num_pages - 2, -1, -1))
        self._draft_pages = [[] for _ in range(decoder.max_batch)]
        self._dlens = np.zeros(decoder.max_batch, np.int32)
        self.target_calls = 0

    @property
    def _margin(self):
        # a verify window can write up to k positions past the final
        # accepted length
        return self.k

    def _pools(self):
        return super()._pools() + (
            (self.draft, self._draft_free, self._draft_pages),)

    def _extra_prefill(self, admitted):
        self.draft.prefill_batch(           # draft's guesses discarded
            [(ids, self._draft_pages[slot])
             for slot, _, ids, _ in admitted],
            kids=[rid for _, rid, _, _ in admitted])

    def _after_admit(self, slot, prompt_len):
        self._dlens[slot] = prompt_len

    def _retire(self, slot):
        self._draft_free.extend(self._draft_pages[slot])
        self._draft_pages[slot] = []
        self._dlens[slot] = 0
        super()._retire(slot)

    def step(self):
        self._admit()
        active = [s for s in range(self.d.max_batch)
                  if self._slot_req[s] is not None]
        if not active:
            return 0
        k = self.k
        if self._table_cache is None:        # slots changed since last tick
            self._table_cache = (self._table(self._slot_pages, self.d),
                                 self._table(self._draft_pages, self.draft))
        ttable, dtable = self._table_cache
        sampled = self.d.sampling is not None

        # the draft proposes k tokens: k device-resident ticks, one fetch
        qrows = None
        out = self.draft.decode_multi(self._tokens, self._dlens, dtable,
                                      k, kids=self._kids,
                                      return_logits=sampled)
        proposals = out.tokens_block.cpu().numpy().T.astype(np.int32)
        if sampled and k > 1:
            # the k-th draft's distribution is never judged (acceptance
            # is capped at k-1): skip its transfer
            qp = self.draft._probs_of(out.logits_block[:k - 1])
            qrows = np.moveaxis(qp, 0, 1)          # [S, k-1, V]
        self.stats.ticks += k
        self.stats.decode_syncs += 1

        # the target verifies [cur, d1..dk] in one forward
        window = np.concatenate(
            [self._tokens[:, None], proposals[:, :k]], axis=1)  # [S, k+1]
        if sampled:
            tgt, prows = self.d.verify(window, self._lens, ttable,
                                       return_probs=True)
        else:
            tgt = self.d.verify(window, self._lens, ttable)     # [S, k+1]
        self.target_calls += 1
        self.steps += 1
        self.stats.ticks += 1
        self.stats.decode_syncs += 1
        # pad ledger: k draft positions plus a (k+1)-wide verify window
        # per batch row; rows with no request were padding (rejected
        # drafts are the engine's gamble, not the layout's padding)
        S_all = self.d.max_batch
        self.stats.tokens_dispatched += S_all * (2 * k + 1)
        self.stats.tokens_padded += (S_all - len(active)) * (2 * k + 1)
        self.stats.occupancy.append(len(active) / self.d.max_batch)
        self._note_resident()

        for s in active:
            rid = self._slot_req[s]
            if sampled:
                rng = np.random.default_rng(
                    (self.d.seed * 1000003 + self.target_calls) * 4093 + s)
                a, tok = _spec_accept(
                    prows[s, :k],
                    qrows[s] if qrows is not None else
                    np.zeros((0, prows.shape[-1])),
                    proposals[s, :k - 1], rng)
                emitted = [int(t) for t in proposals[s, :a]] + [tok]
            else:
                a = 0
                while a < k - 1 and proposals[s, a] == tgt[s, a]:
                    a += 1
                emitted = [int(t) for t in proposals[s, :a]] + \
                    [int(tgt[s, a])]
            L = int(self._lens[s])
            self._lens[s] = L + a + 1
            self._dlens[s] = L + a + 1
            self._tokens[s] = emitted[-1]
            done = False
            for t in emitted:
                self._outputs[rid].append(t)
                self.stats.tokens += 1
                if self.trace is not None:
                    self._trace_progress(rid)
                if (self.eos is not None and t == self.eos) or \
                        len(self._outputs[rid]) >= self.max_new:
                    done = True      # tokens speculated past the stop
                    break            # point are simply never appended
            if done:
                self._retire(s)
        return len(active)

    def _price_horizon(self, k, w, prefill_rows, decode_rows=0,
                       serial=False):
        """One SPEC step's roofline price, in place of the plain decode
        tick's: k device-resident draft ticks (the draft's HBM leg), one
        (k+1)-position verify forward over the target (HBM vs window
        compute) and the step's TWO host syncs (draft fetch, verify
        fetch). `serial=True` sums the verify legs instead of taking
        their max."""
        hbm, fpt, sync = self._price_inputs()
        draft = self.k * decode_tick_roofline_s(self.draft.step_hbm_bytes())
        hbm_s, compute_s = ragged_tick_legs(hbm, self.k + 1, fpt)
        verify = (hbm_s + compute_s) if serial else max(hbm_s, compute_s)
        return draft + verify + 2 * sync
