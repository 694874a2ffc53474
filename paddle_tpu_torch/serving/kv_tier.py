"""Tiered KV memory: a pinned-host-RAM spill tier behind the prefix
cache, and the pricing that decides when a spilled page is worth the
wire (the port's own copy of `paddle_tpu/serving/kv_tier.py`, priced by
the port's cost model: the card's PCIe link, not a TPU host's).

The prefix cache (prefix_cache.py) made shared-prompt KV pages
content-addressable inside HBM — but HBM is the SMALL tier: at
production scale the shared-prompt working set exceeds the pool, the
cache evicts at the HBM cliff, and hit rate collapses exactly when the
server needs it (the serving-under-load axis of the serving
comparison in PAPERS.md, arxiv 2605.25645; the memory-hierarchy layer the
Ragged Paged Attention design leaves open, arxiv 2604.15464). This
module adds the second level:

- **Spill, don't evict.** A refcount-0 parked page reclaimed under
  pool pressure first copies its bytes (and, for an int8 pool, its
  write-time scale planes — the spill is ALREADY quantized, half the
  host bytes for free) into a capacity-bounded host LRU
  (`HostKVTier`), keyed by the same chain key. The device page then
  returns to the free list as before — HBM holds the hot set, host
  RAM the warm set.
- **Priced re-mount.** An admission whose chain continues past the
  device-resident run into host-resident entries restores them via
  H2D only when `cost_model.kv_restore_s(bytes)` (the PCIe leg,
  `ChipSpec.host_bw`) beats the prefill recompute of the same span
  (`cost_model.prefill_ttft_s`, no sync floor — the ragged path pays
  no extra sync either way). Otherwise it recomputes and merely
  refreshes the host entry's recency: the recomputed bytes are
  bit-identical to the spilled ones (write-time (request, position)
  determinism), so the stale payload stays valid. Either way the
  decision is observable: ServeStats `tier_restores` /
  `tier_recomputes` / `tier_spills` / `host_tier_bytes`.
- **Byte identity is the gate.** A restored page's bytes are the SAME
  write-time bytes that were spilled (lossless D2H/H2D round trip),
  and a recomputed block's bytes equal them by the prefill's
  position-local determinism — so tier-on, tier-off and capacity-0
  engines emit byte-identical streams under admission churn
  (fuzz-pinned in tests/test_torch_kv_tier.py).

`PrefixCache.save(dir)` / `PrefixCache.load(dir, decoder)` extend the
hierarchy to DISK across engine restarts (prefix_cache.py), through
the decoder's `pool_state`/`load_pool_state` seam and keyed by
`cache_fingerprint()` — a mismatched decoder refuses, exactly like a
quant-config mismatch does today.
"""
import collections

__all__ = ["HostKVTier", "payload_bytes", "restore_beats_recompute"]

# default host budget: enough for thousands of tiny-model pages, and a
# deliberate bound — the tier is an LRU cache, not a leak
DEFAULT_CAPACITY_BYTES = 256 << 20


def payload_bytes(payload):
    """Host bytes one spilled page costs: every leaf of its K and V
    payloads (torch tensors or numpy arrays; int8 pools pay quantized
    bytes + scale rows — already half the unquantized spill)."""
    return int(sum(leaf.nbytes for part in ("k", "v")
                   for leaf in payload[part]))


def restore_beats_recompute(restore_bytes, span_tokens, flops_per_token,
                            chip=None, shared=False):
    """THE tier decision: is re-mounting `restore_bytes` over the host
    wire cheaper than recomputing `span_tokens` of prefill?  Pure
    pricing (`cost_model.kv_restore_s` vs the compute leg of
    `prefill_ttft_s` with no sync floor — admission pays no extra sync
    either way), so the call sites (engine admission, tests) can never
    disagree on the formula. `shared=True` prices a cross-process
    tier (`serving.fleet.SharedHostKVTier`): the payload is read out
    of an shm-/file-backed store first (`ChipSpec.host_read_bw`), THEN
    crosses PCIe — the engine
    passes the tier's own `shared` attribute."""
    from ..cost_model import kv_restore_s, prefill_ttft_s
    return kv_restore_s(restore_bytes, chip=chip, shared=shared) < \
        prefill_ttft_s(span_tokens, flops_per_token, chip=chip,
                       host_sync_s=0.0)


class _TierEntry:
    __slots__ = ("key", "payload", "nbytes", "page")

    def __init__(self, key, payload, nbytes, page=None):
        self.key = key
        self.payload = payload
        self.nbytes = nbytes
        self.page = page        # device page currently holding a
        # restored twin of this entry (None = host-only). Audit-only
        # backref: the page ledger's host rows cross-check it against
        # the free list (a key both host-resident-with-a-device-twin
        # and device-free is a dropped unmount — MEM-PAGE-REFCOUNT).


class HostKVTier:
    """Capacity-bounded LRU of spilled KV pages in host RAM, keyed by
    the prefix cache's chain key.

    An entry's payload is the exact device bytes of one page —
    ``{"k": (leaf arrays...), "v": (...)}`` as produced by
    `PagedGPTDecoder.fetch_page_payload` — so restore is a lossless
    H2D scatter and the byte-identical-stream invariant survives the
    round trip. int8 pools spill (int8 page bytes, f32 scale rows):
    the host cost is the QUANTIZED cost. `capacity_bytes=0` refuses
    every put — the exact tier-off twin the equivalence tests compare
    against (mirroring `PrefixCache(capacity=0)`)."""

    # per-process tier: restores pay PCIe only. A cross-process tier
    # flips this — the engine reads it (getattr-defaulted) to price
    # the shared host-read leg into restore_beats_recompute
    shared = False

    def __init__(self, capacity_bytes=DEFAULT_CAPACITY_BYTES):
        self.capacity_bytes = int(capacity_bytes)
        self._entries = collections.OrderedDict()   # key -> _TierEntry
        self.bytes_used = 0
        self.evictions = 0          # entries LRU'd out under capacity
        self.puts = 0               # accepted spills (lifetime)

    # ------------------------------------------------------------ query

    def __contains__(self, key):
        return key in self._entries

    def __len__(self):
        return len(self._entries)

    @property
    def n_entries(self):
        return len(self._entries)

    def entry_bytes(self, key):
        return self._entries[key].nbytes

    def items(self):
        """(key, entry) pairs in LRU order (oldest first) — the
        persistence walk (`PrefixCache.save`) keeps this order so a
        loaded tier evicts in the same sequence."""
        return list(self._entries.items())

    # ----------------------------------------------------------- insert

    def put(self, key, payload, page=None):
        """Spill one page's payload under `key`; returns False when the
        capacity bound refuses it (entry bigger than the whole tier,
        or capacity 0 — the tier-off twin). Evicts LRU entries to fit;
        a re-put of an existing key refreshes payload + recency."""
        nbytes = payload_bytes(payload)
        if nbytes > self.capacity_bytes:
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes_used -= old.nbytes
        while self._entries and self.bytes_used + nbytes > \
                self.capacity_bytes:
            _, victim = self._entries.popitem(last=False)
            self.bytes_used -= victim.nbytes
            self.evictions += 1
        self._entries[key] = _TierEntry(key, payload, nbytes, page=page)
        self.bytes_used += nbytes
        self.puts += 1
        return True

    def get(self, key):
        """Payload of `key` (touches recency). KeyError when absent —
        callers gate on `key in tier`."""
        e = self._entries[key]
        self._entries.move_to_end(key)
        return e.payload

    def touch(self, key):
        """Refresh recency without reading (the recompute-refresh path:
        a hot entry whose span was re-prefilled must not age out)."""
        if key in self._entries:
            self._entries.move_to_end(key)

    # ------------------------------------------- device-twin bookkeeping

    def note_mounted(self, key, page):
        """A restored twin of `key` now lives in device page `page`
        (the ledger's host rows cross-check the backref)."""
        if key in self._entries:
            self._entries[key].page = int(page)

    def note_unmounted(self, key):
        """The device twin was evicted (and needs no re-spill: the
        host payload is still the exact write-time bytes); also
        refreshes recency — the entry is hot again."""
        e = self._entries.get(key)
        if e is not None:
            e.page = None
            self._entries.move_to_end(key)

    # ------------------------------------------------------------ ledger

    def ledger(self):
        """{key hex: {"bytes": n, "page": device twin or None}} — the
        host-tier rows of `ContinuousBatchingEngine.page_ledger()`,
        audited by MEM-PAGE-REFCOUNT (`serving.page_audit
        .audit_page_ledger`): a host entry whose device twin sits on
        the free list is a dropped unmount."""
        return {e.key.hex(): {"bytes": e.nbytes, "page": e.page}
                for e in self._entries.values()}
