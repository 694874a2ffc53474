"""Continuous-batching engine over the paged decoder (counterpart of
`paddle_tpu/serving/engine.py` `ContinuousBatchingEngine`): slot
scheduling, ragged chunked-prefill horizons, the per-tick loop, and
prefix-cache admission with its host KV tier.

Ported: the ragged packed horizon loop (`_run_ragged`, the default for
k_max > 1) and the per-tick loop (`step` / `_run_per_tick`, k_max=1),
which is the in-port oracle for it; content-addressed admission over a
`PrefixCache` (mount, copy-on-write, publish, evict), the host tier
behind it (`HostKVTier`: spill waves, priced restore or recompute) and
the page ledger with its audit. Not ported yet: the flight recorder, the
dispatch-separate baseline (`ragged=False` with k_max > 1), LoRA
adapters, tenancy hooks and the speculative engine.
"""
import time
import weakref

import numpy as np
import torch

from .decoder import PagedGPTDecoder, _not_ported
from .kv_tier import HostKVTier, restore_beats_recompute
from .page_audit import audit_kv_scale_planes, audit_page_ledger
from .prefix_cache import PrefixCache
from .scheduler import RaggedScheduler
from .stats import _ENGINES, ServeStats

__all__ = ["ContinuousBatchingEngine"]


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
    N is processed). `k_max=1` selects the per-tick loop (`step()` is the
    per-tick API either way); `k_max=None` lets the scheduler price K
    (`cost_model.decode_horizon`).

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
        if trace:
            raise _not_ported("the flight recorder (trace=; ROADMAP.md "
                              "queue 1, item 4.1)")
        for name, value in (("host_sync_s", host_sync_s),
                            ("scheduler", scheduler), ("packed", packed)):
            if value is not None:
                raise _not_ported(f"the engine's {name}= (ROADMAP.md "
                                  "queue 1, item 4.5)")
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
        # per-slot admission generation: a block dispatched for an earlier
        # occupancy of the slot must never book-keep against a later one
        self._slot_gen = [0] * S
        self._table_cache = None             # rebuilt on admit/retire only
        self._queue = []                     # (req_id, ids)
        self._outputs = {}                   # req_id -> [generated ids]
        self._next_id = 0
        self.steps = 0
        self.k_max = max(1, int(k_max)) if k_max is not None else None
        self._init_cache(prefix_cache, host_tier, tier_policy)
        if ragged is False and self.k_max != 1:
            raise _not_ported("the dispatch-separate baseline "
                              "(ragged=False with k_max > 1)")
        self.scheduler = None
        if self.k_max is None or self.k_max > 1 or ragged:
            # k_max=None: the scheduler prices K (cost_model)
            self.scheduler = RaggedScheduler(
                decoder, chunk_tokens=chunk_tokens, k_max=self.k_max)
            self.k_max = self.scheduler.k_max
        self.ragged = bool(self.k_max > 1 if ragged is None else ragged)
        self._prompt_len = [0] * S           # admitted prompt length/slot
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

    # -- host KV tier ----------------------------------------------------

    def _flops_per_token(self):
        """Matmul FLOPs one prompt token costs (the 2x-params GPT rule;
        the scheduler already holds it on ragged engines)."""
        if self.scheduler is not None:
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
            for (key, _page), payload in zip(pending, payloads):
                if tier.put(key, payload):
                    self.stats.tier_spills += 1
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

    def _tier_restore(self, keys, n_dev, pages, hold):
        """Re-mount `len(pages)` host-resident blocks (keys[n_dev:], their
        payloads pinned in `hold`) into freshly allocated device pages:
        ONE H2D + `index_copy_` per pool leaf for the whole span
        (`mount_page_payloads`, asynchronous on the decoder's stream, so
        every later horizon reads the restored bytes), then cache insert
        under the held parent chain and the device-twin backref for the
        audit. Returns [(page, inserted)]: a capacity-refused insert
        leaves that page (and the rest of the chain) private to the
        request."""
        tier = self.tier
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
        self.stats.tier_restores += len(pages)
        self.stats.host_tier_bytes = tier.bytes_used
        return out

    def submit(self, prompt_ids):
        """Queue one prompt (list, numpy array or tensor of token ids);
        returns its request id."""
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.cpu().numpy()
        ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not ids:
            raise ValueError(
                "prompt must contain at least one token (prefill "
                "samples the first generated token after the prompt's "
                "last position — an empty prompt has none)")
        total = len(ids) + self.max_new
        need = self._pages_for(total)
        if need > min(self.d.max_pages, self.d.num_pages - 1):
            raise ValueError(
                f"request needs {need} pages (prompt {len(ids)} + "
                f"max_new {self.max_new} tokens) but the pool allows "
                f"{min(self.d.max_pages, self.d.num_pages - 1)}")
        if total > self.d.cfg.max_seq_len:
            raise ValueError(
                f"prompt {len(ids)} + max_new {self.max_new} tokens "
                f"exceeds the model's max_seq_len "
                f"{self.d.cfg.max_seq_len} (positions past it have no "
                "embedding)")
        rid = self._next_id
        self._next_id += 1
        self._submit_t[rid] = time.perf_counter()
        self.stats.requests += 1
        self._queue.append((rid, ids))
        return rid

    def _pages_for(self, n_tokens):
        return (n_tokens + self.d.page_size - 1) // self.d.page_size

    def _note_resident(self):
        n = sum(r is not None for r in self._slot_req)
        self.stats.max_resident_slots = max(
            self.stats.max_resident_slots, n)

    def _note_queue_waits(self, admitted):
        now = time.perf_counter()
        for _, rid, _, _ in admitted:
            t0 = self._submit_t.get(rid)
            if t0 is not None:
                self.stats.queue_wait_s.append(now - t0)

    def _admit(self):
        """Per-tick admission: gather every admittable request and
        prefill them as ONE packed forward (host-blocking). Returns the
        slots that entered decode."""
        active0 = sum(r is not None for r in self._slot_req)
        admitted = self._gather_admissions()
        if not admitted:
            return []
        self._note_queue_waits(admitted)
        self._table_cache = None
        firsts = self._prefill_admitted(admitted)
        self.stats.prefill_syncs += 1
        if active0:
            # this prefill BLOCKED the host while slots sat decoding
            self.stats.prefill_stall_syncs += 1
        done_t = time.perf_counter()
        live = []
        for (slot, rid, ids, pages), first in zip(admitted, firsts):
            t0 = self._submit_t.pop(rid, None)
            if t0 is not None:
                self.stats.ttft_s.append(done_t - t0)
            self._outputs[rid] = [first]
            self.stats.tokens += 1
            if (self.eos is not None and first == self.eos) \
                    or self.max_new <= 1:
                # finished at prefill: never occupy a decode slot
                self._retire(slot)
                continue
            self._lens[slot] = len(ids)
            self._tokens[slot] = first
            self._kids[slot] = rid
            live.append(slot)
        return live

    def _prefill_admitted(self, admitted):
        """The per-tick path's blocking prefill of the admitted requests:
        whole prompts without a prefix cache; with one, each request's
        uncached suffix from its `start` (the cached span is mounted, zero
        device work). Freshly computed full blocks are published to the
        cache afterwards (`.tolist()` has synced, so their bytes are
        written before any later mount reads them)."""
        reqs = []
        for _, rid, ids, pages in admitted:
            start = self._cache_meta[rid][0] if self.cache is not None \
                else 0
            reqs.append((ids[start:], start, pages))
        firsts = self.d.prefill_suffix_batch(
            reqs, kids=[rid for _, rid, _, _ in admitted])
        for slot, rid, _, _ in admitted:
            self._publish_blocks(rid, slot)
        return firsts

    def _publish_blocks(self, rid, slot):
        """Publish a request's freshly computed full blocks to the prefix
        cache (the slot keeps holding the pages until retirement decrefs
        them). Called once the blocks' bytes are ordered before any future
        reader: after the prefill sync on the per-tick path, at the first
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

    def _occupy(self, slot, rid, pages):
        self._slot_req[slot] = rid
        self._slot_gen[slot] += 1
        self._slot_pages[slot] = pages

    def _gather_admissions(self):
        """Bind queued requests to free slots in order while their pages
        fit (head-of-line: a request that does not fit waits, and so do
        the ones behind it)."""
        if self.cache is not None:
            return self._gather_admissions_cached()
        admitted = []
        for slot in range(self.d.max_batch):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            rid, ids = self._queue[0]
            need = self._pages_for(len(ids) + self.max_new)
            if need > self.d.max_pages or need > len(self._free):
                break
            self._queue.pop(0)
            self._occupy(slot, rid, [self._free.pop() for _ in range(need)])
            admitted.append((slot, rid, ids, self._slot_pages[slot]))
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
        ps = self.d.page_size
        tok_bytes = self.d.kv_page_bytes // ps
        for slot in range(self.d.max_batch):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            rid, ids = self._queue[0]
            L = len(ids)
            total = self._pages_for(L + self.max_new)
            if total > self.d.max_pages:
                break                        # permanently oversized head
            keys = self.cache.block_keys(ids,
                                         extra_salt=self.d.adapter_salt(0))
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
                break                        # head-of-line: wait for pages
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
                                                   rest_pages, hold))
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
            self._occupy(slot, rid, shared + privates)  # prefix first
            self._slot_shared[slot] = shared_set
            self._cache_meta[rid] = (start, keys_meta, n_hit)
            self.stats.prefix_hits += n_hit
            self.stats.prefix_misses += len(keys) - n_hit
            self.stats.prefix_tokens_saved += start
            self.stats.prefix_bytes_saved += start * tok_bytes
            admitted.append((slot, rid, ids, self._slot_pages[slot]))
        return admitted

    def _retire(self, slot):
        """Give back the slot's pages — a shared page drops this request's
        cache reference (the cache still owns it, parked at refcount 0),
        a private one returns to the free list — and clear every per-slot
        field (the generation bump makes any in-flight block of this
        occupancy stale)."""
        shared = self._slot_shared[slot]
        for pid in self._slot_pages[slot]:
            if pid in shared:
                self.cache.release_page(pid)
            else:
                self._free.append(pid)
        self.stats.completed += 1
        self._slot_shared[slot] = set()
        self._slot_req[slot] = None
        self._slot_pages[slot] = []
        self._slot_gen[slot] += 1
        self._lens[slot] = 0
        self._tokens[slot] = 0
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

    def _table(self):
        """Page table with inactive/unused entries routed to the reserved
        scratch page (their discarded KV writes must never land in
        allocatable pages)."""
        d = self.d
        t = np.full((d.max_batch, d.max_pages), d.num_pages - 1, np.int32)
        for s, pg in enumerate(self._slot_pages):
            if pg:
                t[s, :len(pg)] = pg
        return t

    def step(self):
        """Admit + one decode tick. Returns number of active slots."""
        self._admit()
        active = [s for s in range(self.d.max_batch)
                  if self._slot_req[s] is not None]
        if not active:
            return 0
        if self._table_cache is None:        # slots changed since last tick
            self._table_cache = self._table()
        nxt = self.d.decode(self._tokens, self._lens, self._table_cache,
                            kids=self._kids).cpu().numpy()
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
            self._lens[s] += 1
            self._tokens[s] = tok
            if (self.eos is not None and tok == self.eos) or \
                    len(self._outputs[rid]) >= self.max_new:
                self._retire(s)
        return len(active)

    def run(self, step_times=None, on_sync=None):
        """Drain the queue; returns {request_id: generated token list}.
        `step_times`, if given, receives wall seconds per host sync (per
        tick on the per-tick path, per horizon on the ragged path).
        `on_sync(engine)` is called after every processed host sync and
        may `submit()` new requests."""
        if self.ragged:
            return self._run_ragged(step_times, on_sync)
        return self._run_per_tick(step_times, on_sync)

    def _run_per_tick(self, step_times=None, on_sync=None):
        """Per-tick loop: one tick, one host sync per token."""
        while self._queue or any(r is not None for r in self._slot_req):
            t0 = time.perf_counter()
            before = self.stats.tokens
            before_p = self.stats.prefill_syncs
            self.step()
            dt = time.perf_counter() - t0
            if step_times is not None:
                step_times.append(dt)
            n = self.stats.tokens - before
            # steady-state decode latency only: a sync that contained a
            # prefill would turn p99 into a prefill number
            if n and self.stats.prefill_syncs == before_p:
                self.stats.token_time_s.extend([dt / n] * n)
            if on_sync is not None:
                on_sync(self)
        return dict(self._outputs)

    def _budget_left(self, slot):
        """Tokens this slot may still emit (host view, excludes ticks
        already dispatched but not yet processed)."""
        return self.max_new - len(self._outputs[self._slot_req[slot]])

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
        self._note_queue_waits(admitted)
        self._table_cache = None
        plans = []
        for slot, rid, ids, _pages in admitted:
            start = self._cache_meta[rid][0] if self.cache is not None \
                else 0
            suffix = ids[start:]
            self._outputs[rid] = []
            self._lens[slot] = start
            self._tokens[slot] = 0
            self._kids[slot] = rid
            self._prompt_len[slot] = len(ids)
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
            self.stats.ttft_s.append(time.perf_counter() - t0)
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

    def _process_ragged_block(self, meta, inflight, step_times):
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
        # packed t_tokens bucket); real is the device's per-tick count
        pad_toks = disp_toks - int(real_d.sum())
        self.stats.tokens_dispatched += disp_toks
        self.stats.tokens_padded += pad_toks
        self.stats.decode_syncs += 1
        n_emitted = 0
        for s, (rid, gen) in rids.items():
            if self._slot_req[s] != rid or self._slot_gen[s] != gen:
                # stale block of a retired/re-admitted slot: its emit
                # ticks were already discarded by the inflight reset at
                # re-admission
                continue
            inflight[s] = max(0, inflight[s] - emit_ticks.get(s, 0))
            for j in range(k):
                if not emitted[j, s]:
                    continue
                tok = int(block[j, s])
                if not self._outputs[rid]:
                    self._first_token(rid, s)
                else:
                    self._lens[s] += 1
                self._outputs[rid].append(tok)
                self.stats.tokens += 1
                n_emitted += 1
                self._tokens[s] = tok
                if (self.eos is not None and tok == self.eos) or \
                        len(self._outputs[rid]) >= self.max_new:
                    self._retire(s)
                    break
        dt = time.perf_counter() - t0
        if step_times is not None:
            step_times.append(dt)
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
                # prompt_len + in-flight emissions
                pos = (self._prompt_len[s]
                       + len(self._outputs.get(rid, ()))
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
            plan = sched.plan(live,
                              {s: self._budget_left(s) for s in live},
                              inflight) if live else None
            if plan is not None:
                if self._table_cache is None:
                    self._table_cache = self._table()
                tokens_d, lens_d, done_d, rem_d, pend_d, pend_n_d = carry
                width = self._table_width(live, plan, inflight)
                out = self.d.ragged_multi(
                    tokens_d, lens_d,
                    np.ascontiguousarray(self._table_cache[:, :width]),
                    plan.k, plan.w, pend_d, pend_n_d, kids=self._kids,
                    done=done_d,
                    remaining=rem_d, eos=self.eos, t_tokens=plan.t_tokens)
                carry = (out.tokens, out.lens, out.done, out.remaining,
                         out.pend, out.pend_n)
                self.steps += plan.k
                self.stats.ticks += plan.k
                self.stats.prefill_chunks += plan.n_chunks
                self.stats.occupancy.append(len(live) / S)
                self._note_resident()
                for s, e in plan.emit_ticks.items():
                    inflight[s] += e
                meta = (out.tokens_block, out.emitted, out.real,
                        plan.k * plan.t_tokens, plan.k,
                        {s: (rid, self._slot_gen[s])
                         for s, rid in live.items()},
                        plan.emit_ticks, t0)
            if pending is not None:
                self._process_ragged_block(pending, inflight, step_times)
                if on_sync is not None:
                    on_sync(self)
            pending = meta
        return dict(self._outputs)
