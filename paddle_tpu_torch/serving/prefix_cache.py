"""Content-addressed prefix cache over the paged KV pool (the port's own
copy of `paddle_tpu/serving/prefix_cache.py`: hashlib, numpy and torch,
no JAX; the chain keys and the persisted byte format are the JAX
package's, byte for byte).

Real serving fleets overwhelmingly share prompt prefixes (system
prompts, few-shot templates); the Gemma-on-TPU serving comparison
(PAPERS.md, arxiv 2605.25645) attributes a large share of its
serving win to page-level prefix reuse, and the paged KV pool
(`serving.decoder.PagedGPTDecoder`) already gives the page-granular
indirection the Ragged Paged Attention design assumes (arxiv
2604.15464).  This module adds the missing piece: a host-side,
content-addressed index over that pool so requests sharing a prefix
skip prefill for the shared span entirely.

Design (vLLM-style hash-block caching over the paged pool):

- **Chain keys.**  A prompt is split into full `page_size`-token
  blocks; block ``j``'s key is ``H(key_{j-1} || tokens_j)`` with the
  root key salted by a model/sampling-invariant decoder fingerprint.
  Position and full prefix content are therefore implicit in the key —
  two requests map to the same page iff their ENTIRE token prefix up to
  that block matches (and was produced by an equivalent decoder
  config), so a mounted page's KV bytes are exactly the bytes the
  request's own prefill would have written (prefill is deterministic
  and per-position computations are batch-independent).
- **Refcounts.**  ``refs`` counts live requests mounting a page.  The
  cache itself holds pages beyond ``refs == 0``: they park in an LRU
  and are reclaimed (evicted back to the engine's free list) only
  under pool pressure.  A page is never freed while referenced, and
  freed exactly once — the engine's page ledger is auditable
  (`serving.page_audit.audit_page_ledger`, rule MEM-PAGE-REFCOUNT).
- **Copy-on-write.**  The cache never hands out writable shared pages;
  the ENGINE copies a page before the first divergent-token write
  lands in it (the full-hit branch of
  `ContinuousBatchingEngine._gather_admissions_cached`, via
  `PagedGPTDecoder.copy_page`) and releases its reference on the
  original.  The cache only tracks the refcounts that make the "is
  this page shared" question answerable.
- **Eviction.**  LRU over parked (refcount-0) entries.  Keys chain, so
  an evicted block's parked descendants are unreachable (a lookup must
  match block 0..j-1 before j) and are evicted in the same sweep —
  no stranded pages.
"""
import collections
import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["PrefixCache", "pack_array", "unpack_array"]

# the persisted dtype names (numpy's, as the JAX package writes them:
# ml_dtypes' bf16 prints as "bfloat16") and the torch dtypes they load as
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8,
           "uint8": torch.uint8, "int32": torch.int32}
_NAMES = {v: k for k, v in _DTYPES.items()}


def pack_array(arr):
    """(raw uint8 bytes, {"shape","dtype"} meta) of one pool/payload
    leaf — THE persisted byte format: npz can't serialize a bf16 leaf
    directly, so every array is stored as its raw bytes with
    shape+dtype carried out-of-band in JSON. Takes a torch tensor (on
    any device: its bytes are copied to the host) or a numpy array; a
    bf16 tensor is stored as its raw bytes under dtype "bfloat16", the
    name the JAX package writes for the same leaf, so both packages'
    snapshots are the same bytes."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu", copy=True).contiguous()
        return (t.reshape(-1).view(torch.uint8).numpy(),
                {"shape": list(t.shape), "dtype": _NAMES[t.dtype]})
    arr = np.asarray(arr)
    return (np.frombuffer(arr.tobytes(), np.uint8),
            {"shape": list(arr.shape), "dtype": str(arr.dtype)})


def unpack_array(raw, meta):
    """Inverse of `pack_array`: a CPU torch tensor that owns its bytes
    (a writable copy — never a view of the npz buffer — so it can be
    mounted or copied into a pool without aliasing the file's
    memory)."""
    flat = torch.from_numpy(np.array(raw, np.uint8).reshape(-1))
    return flat.view(_DTYPES[meta["dtype"]]).reshape(meta["shape"])


@dataclass
class _Entry:
    key: bytes
    page: int
    parent: bytes = None         # chain parent key (None for block 0)
    refs: int = 0                # live requests mounting this page
    children: set = field(default_factory=set)


class PrefixCache:
    """Content-addressed, refcounted page index: chain key -> page id.

    `page_size` is the token-block granularity (one KV page).  `salt`
    folds the decoder's model/sampling-invariant fingerprint into the
    root key so two decoders with different weights or quantization
    never alias.  `capacity` bounds the number of cached pages
    (None = bounded only by the pool; 0 = caching disabled — every
    lookup misses and inserts are refused, which is the exact
    "caching off" twin the equivalence tests compare against)."""

    def __init__(self, page_size, salt=b"", capacity=None, tier=None):
        self.page_size = int(page_size)
        self.salt = salt if isinstance(salt, bytes) else str(salt).encode()
        self.capacity = capacity
        # optional HOST spill tier (serving.kv_tier.HostKVTier): pages
        # evicted under pool pressure spill their bytes to pinned host
        # RAM instead of vanishing, and admissions whose chain
        # continues onto host entries may restore them (the engine owns
        # the spill/restore I/O and the pricing; the cache only chains
        # the keys). None = a single-level cache.
        self.tier = tier
        self._decoder = None             # weakref set by the engine —
        # save() reads the pool through it when no decoder is passed
        self._entries = {}               # key -> _Entry
        self._by_page = {}               # page id -> key
        self._lru = collections.OrderedDict()   # key -> None (refs == 0)

    # ------------------------------------------------------------ keys

    def block_keys(self, tokens, extra_salt=b""):
        """Chain keys of every FULL `page_size`-token block of `tokens`
        (a trailing partial block is never cacheable — its page will
        keep growing). `extra_salt` folds a per-REQUEST identity into
        the root key on top of the cache's decoder salt — the
        multi-LoRA engine passes the request's adapter fingerprint
        (`PagedGPTDecoder.adapter_salt`), so two variants' KV pages
        never alias even when their token prefixes match (the bytes
        differ: the adapter's low-rank delta is part of the write)."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        n = len(toks) // self.page_size
        keys, prev = [], self.salt + extra_salt
        for b in range(n):
            block = toks[b * self.page_size:(b + 1) * self.page_size]
            h = hashlib.blake2b(digest_size=16)
            h.update(prev)
            h.update(block.tobytes())
            prev = h.digest()
            keys.append(prev)
        return keys

    # ---------------------------------------------------------- lookup

    def match(self, keys):
        """Page ids of the longest cached run of `keys` from block 0
        (peek only — no refcount change)."""
        pages = []
        for k in keys:
            e = self._entries.get(k)
            if e is None:
                break
            pages.append(e.page)
        return pages

    def mount(self, keys):
        """Incref every entry in `keys` (a request is now holding its
        page); revives parked entries out of the LRU."""
        for k in keys:
            e = self._entries[k]
            e.refs += 1
            self._lru.pop(k, None)

    # ---------------------------------------------------------- insert

    def insert(self, key, page, parent=None):
        """Register a freshly prefilled full-block page under `key`
        with one reference (the inserting request).  Returns False —
        and takes no ownership — when the key is already cached (a
        same-batch duplicate computed its own copy; it keeps the page
        private) or the capacity bound refuses new entries.

        Caller contract: only insert a child under a `parent` the
        caller currently HOLDS (mounted or inserted this admission) —
        the engine stops publishing a chain at the first refused
        insert.  Otherwise a still-referenced child could sit under a
        refcount-0 parent, and the eviction cascade (which relies on
        child-referenced => every-ancestor-referenced) would trip its
        refcount guard."""
        if key in self._entries:
            return False
        if self.capacity is not None and len(self._entries) >= self.capacity:
            # full: insert() never evicts (freed pages belong to the
            # ENGINE's free list; only admission-time evict() may
            # reclaim) — the block simply stays private to its request
            return False
        e = _Entry(key=key, page=int(page), parent=parent, refs=1)
        self._entries[key] = e
        self._by_page[int(page)] = key
        if parent is not None and parent in self._entries:
            self._entries[parent].children.add(key)
        return True

    # --------------------------------------------------------- release

    def release_page(self, page):
        """One request stopped referencing `page` (retirement or CoW).
        At refcount 0 the page PARKS in the LRU — still cached, still
        owned by the cache — instead of returning to the free list;
        only eviction frees it (exactly once)."""
        key = self._by_page[int(page)]
        e = self._entries[key]
        if e.refs <= 0:
            raise RuntimeError(
                f"refcount underflow on page {page} (double release)")
        e.refs -= 1
        if e.refs == 0:
            self._lru[key] = None       # most-recently parked = last out

    def is_cached_page(self, page):
        return int(page) in self._by_page

    def refs_of_page(self, page):
        return self._entries[self._by_page[int(page)]].refs

    # -------------------------------------------------------- eviction

    def evictable(self, exclude=()):
        """How many parked pages could be reclaimed right now (the
        admission head-of-line check adds this to the free list before
        deciding to wait). `exclude` keys are about to be mounted —
        their whole ancestor chain is also in the hit set, so excluding
        the hits themselves suffices."""
        ex = set(exclude)
        return sum(1 for k in self._lru if k not in ex)

    def evict(self, n, exclude=(), spill=None):
        """Reclaim at least `n` parked pages (LRU-first), cascading to
        each victim's parked descendants (their chain keys are
        unreachable once an ancestor is gone).  Returns the freed page
        ids — the caller (engine) owns them again.  `spill(key, page)`,
        if given, runs for every victim BEFORE its page is unmapped —
        the host-tier hook.  The engine's hook (`_spill_wave.note`)
        only RECORDS the victims here and performs ONE batched D2H
        after evict() returns; that is safe because the engine defers
        handing out (and a fortiori writing) the freed pages until the
        batched fetch has completed — a caller that recycles freed
        pages before reading their bytes would corrupt the spill."""
        ex = set(exclude)
        freed = []
        while len(freed) < n:
            victim = next((k for k in self._lru if k not in ex), None)
            if victim is None:
                break
            freed.extend(self._evict_subtree(victim, spill=spill))
        return freed

    def _evict_subtree(self, key, spill=None):
        freed = []
        stack = [key]
        while stack:
            k = stack.pop()
            e = self._entries.pop(k, None)
            if e is None:
                continue
            if e.refs:
                raise RuntimeError(
                    f"evicting page {e.page} with refcount {e.refs}")
            if spill is not None:
                # the page's bytes are still valid here AND until the
                # caller reuses the freed ids: nobody writes a parked
                # page, so the hook may read now or batch the read
                # after the walk (the engine's _spill_wave does the
                # latter) — as long as it reads before reuse
                spill(k, e.page)
            stack.extend(e.children)
            self._lru.pop(k, None)
            del self._by_page[e.page]
            if e.parent is not None and e.parent in self._entries:
                self._entries[e.parent].children.discard(k)
            freed.append(e.page)
        return freed

    # ------------------------------------------------------------ view

    @property
    def n_pages(self):
        """Pages the cache currently owns or tracks (mounted + parked)."""
        return len(self._entries)

    @property
    def n_parked(self):
        return len(self._lru)

    def pages(self):
        """Page ids the cache currently tracks (mounted + parked) — the
        engine's audit walks these next to the slot-held pages."""
        return list(self._by_page)

    def ledger(self):
        """{page id: {"refs": r, "parked": bool}} — the audit view the
        MEM-PAGE-REFCOUNT audit (`serving.page_audit`) reads through
        the engine's page ledger."""
        return {e.page: {"refs": e.refs, "parked": e.refs == 0}
                for e in self._entries.values()}

    # ------------------------------------------------------ persistence

    def _fingerprint_hex(self, decoder):
        return hashlib.blake2b(decoder.cache_fingerprint(),
                               digest_size=16).hexdigest()

    def save(self, path, decoder=None):
        """Persist the cache so it outlives the engine: the decoder's
        pool arrays (through the `pool_state` seam — quant config
        included), the chain index (key -> page, parents, LRU order),
        and every host-tier entry's payload, keyed by a digest of
        `decoder.cache_fingerprint()`. `load()` on a decoder with a
        different fingerprint REFUSES (same contract as the
        quant-config check in `load_pool_state`): the cached bytes are
        only valid for the exact weights/arch/pool config that wrote
        them.

        `decoder` defaults to the engine-bound one (the engine attaches
        itself at construction). Every entry must be parked (refs 0) —
        drain the engine first; saving under live requests would
        snapshot pages about to diverge."""
        import json
        import os
        dec = decoder
        if dec is None and self._decoder is not None:
            dec = self._decoder()
        if dec is None:
            raise ValueError(
                "PrefixCache.save needs the decoder whose pool holds "
                "the cached pages — pass decoder=, or attach the cache "
                "to an engine first")
        live = sum(1 for e in self._entries.values() if e.refs)
        if live:
            raise RuntimeError(
                f"cannot save a prefix cache with {live} live-"
                "referenced page(s) — drain the engine (run() to "
                "completion) so every entry is parked first")
        os.makedirs(path, exist_ok=True)
        state = dec.pool_state()
        arrays, meta = {}, {}

        def add(name, arr):
            # raw bytes + JSON-carried shape/dtype (pack_array — the
            # one persisted byte format, the JAX package's too)
            arrays[name], meta[name] = pack_array(arr)

        for pool in ("k_pages", "v_pages"):
            leaves = state[pool] if isinstance(state[pool], tuple) \
                else (state[pool],)
            for i, leaf in enumerate(leaves):
                add(f"{pool}.{i}", leaf)
        entries = []                     # LRU order: oldest first, so a
        for k in self._lru:              # loaded cache evicts in the
            e = self._entries[k]         # same sequence
            entries.append([k.hex(), int(e.page),
                            e.parent.hex() if e.parent else None])
        host = []
        if self.tier is not None:
            for j, (k, te) in enumerate(self.tier.items()):
                leaves = {"k": len(te.payload["k"]),
                          "v": len(te.payload["v"])}
                for part in ("k", "v"):
                    for i, leaf in enumerate(te.payload[part]):
                        add(f"host.{j}.{part}.{i}", leaf)
                host.append([k.hex(), leaves])
        index = {"fingerprint": self._fingerprint_hex(dec),
                 "page_size": self.page_size,
                 "kv_quant": state["kv_quant"],
                 # the chain keys were computed under THIS salt — a
                 # load that rebound a different salt would hash every
                 # warm prompt to keys that never match the saved
                 # entries (0 hits, silently)
                 "salt": self.salt.hex(),
                 # bounds round-trip too: reloading a bounded cache /
                 # tier under DEFAULT bounds could silently LRU-drop
                 # part of the persisted warm set during the refill
                 "capacity": self.capacity,
                 "tier_capacity_bytes": (self.tier.capacity_bytes
                                         if self.tier is not None
                                         else None),
                 "entries": entries, "host": host, "arrays": meta}
        np.savez(os.path.join(path, "kv_pool.npz"), **arrays)
        with open(os.path.join(path, "index.json"), "w") as f:
            json.dump(index, f)
        return path

    @classmethod
    def load(cls, path, decoder, tier=None, capacity=None):
        """Rebuild a saved cache onto `decoder`: refuses on fingerprint
        mismatch (different weights, architecture, page size, pool
        dtype or quant config than the decoder that wrote it — mounted
        pages would hold another model's KV), then restores the pool
        through `load_pool_state` (which re-checks quant config and
        shapes, and refuses while any attached engine holds live
        pages), re-parks every entry in its saved LRU order, and
        refills the host tier (`tier`, or a fresh `HostKVTier` when
        the save carried host entries). Returns the cache — hand it to
        `ContinuousBatchingEngine(prefix_cache=...)`, whose free list
        excludes the cache-owned pages."""
        import json
        import os
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        salt = index.get("salt")
        me = cls(decoder.page_size,
                 # saved salt wins: the persisted chain keys were
                 # hashed under it (pre-salt saves were all written by
                 # fingerprint-salted caches, so the fallback matches)
                 salt=(bytes.fromhex(salt) if salt is not None
                       else decoder.cache_fingerprint()),
                 capacity=(index.get("capacity") if capacity is None
                           else capacity),
                 tier=tier)
        want = index["fingerprint"]
        have = me._fingerprint_hex(decoder)
        if want != have:
            raise ValueError(
                f"cached KV at {path!r} was written by a decoder with "
                f"fingerprint {want} but this decoder is {have} — "
                "different weights/architecture/pool config would "
                "mount garbage KV; delete the cache dir or rebuild "
                "the matching decoder")
        data = np.load(os.path.join(path, "kv_pool.npz"))
        meta = index["arrays"]

        def get(name):
            # unpack_array returns a tensor that owns its bytes
            return unpack_array(data[name], meta[name])

        def pool(name):
            leaves = tuple(get(f"{name}.{i}")
                           for i in range(len([k for k in meta
                                               if k.startswith(name + ".")
                                               ])))
            return leaves if len(leaves) > 1 else leaves[0]

        decoder.load_pool_state({"kv_quant": index["kv_quant"],
                                 "k_pages": pool("k_pages"),
                                 "v_pages": pool("v_pages")})
        # bind the decoder the pool was just loaded onto: the engine
        # refuses to adopt this cache with any OTHER decoder (same
        # weights or not — its pool does not hold these pages), and
        # save() can read the pool with no engine attached
        import weakref
        me._decoder = weakref.ref(decoder)
        for key_hex, page, parent_hex in index["entries"]:
            k = bytes.fromhex(key_hex)
            parent = bytes.fromhex(parent_hex) if parent_hex else None
            e = _Entry(key=k, page=int(page), parent=parent, refs=0)
            me._entries[k] = e
            me._by_page[int(page)] = k
            me._lru[k] = None
        # children links in a SECOND pass: the saved LRU order can park
        # a child before its parent (the child's holder retired first),
        # and a link dropped here would break the eviction cascade —
        # the parent would evict without cascading to its (now
        # unreachable) descendant, stranding a device page
        for e in me._entries.values():
            if e.parent is not None and e.parent in me._entries:
                me._entries[e.parent].children.add(e.key)
        if index["host"]:
            if me.tier is None:
                from .kv_tier import HostKVTier
                cap = index.get("tier_capacity_bytes")
                me.tier = HostKVTier() if cap is None else \
                    HostKVTier(capacity_bytes=cap)
            for j, (key_hex, leaves) in enumerate(index["host"]):
                payload = {part: tuple(get(f"host.{j}.{part}.{i}")
                                       for i in range(leaves[part]))
                           for part in ("k", "v")}
                me.tier.put(bytes.fromhex(key_hex), payload)
        return me
