"""MEM-PAGE-REFCOUNT audits of a serving engine's shared KV pool (the
port's own copy of `audit_page_ledger` and `audit_kv_scale_planes` from
`paddle_tpu/analysis/memory.py`: pure dict logic over the engine's page
ledger, and a scan of a quantized pool's scale planes), with a minimal
finding record in place of the analysis package's.
"""
from dataclasses import dataclass

import torch

__all__ = ["Finding", "audit_page_ledger", "audit_kv_scale_planes"]

RULE = "MEM-PAGE-REFCOUNT"


@dataclass
class Finding:
    """One audit finding: the rule, its message and, where there is one,
    the fix it suggests."""
    rule_id: str
    severity: str
    message: str
    suggested_fix: str = None

    def __str__(self):
        fix = f"\n      fix: {self.suggested_fix}" if self.suggested_fix \
            else ""
        return f"{self.severity:<7} {self.rule_id}: {self.message}{fix}"


def audit_page_ledger(ledger):
    """Invariant audit of a page ledger
    (`ContinuousBatchingEngine.page_ledger()`): with a shared (prefix-
    cached) KV pool, every allocatable page must be owned EXACTLY once —
    on the free list, XOR held by slot(s) under a covering cache refcount,
    XOR parked (refcount 0) in the cache's LRU — no page may be shared by
    slots of different adapter salts (`slot_adapters` rows), and a
    host-tier entry's device twin must be a live cache-tracked page.
    Double frees, leaks,
    refcount drift and dropped unmounts surface as findings. Returns a
    list of Finding (empty = consistent)."""
    findings = []

    def bad(msg, fix=None):
        findings.append(Finding(RULE, "ERROR", msg, suggested_fix=fix))

    num_pages = int(ledger.get("num_pages", 0))
    scratch = ledger.get("scratch")
    free = list(ledger.get("free", []))
    slots = {int(s): list(p)
             for s, p in (ledger.get("slots") or {}).items()}
    shared = {int(s): set(p)
              for s, p in (ledger.get("shared") or {}).items()}
    cache = {int(p): dict(e)
             for p, e in (ledger.get("cache") or {}).items()}

    seen = set()
    for p in free:
        if p in seen:
            bad(f"page {p} appears twice in the free list (double free)")
        seen.add(p)
        if scratch is not None and p == scratch:
            bad("the reserved scratch page is on the free list")

    holders = {}                         # page -> [slots holding it]
    for s, pages in slots.items():
        for p in pages:
            holders.setdefault(p, []).append(s)
    # multi-LoRA rows: per-slot adapter salts — a page shared across slots
    # whose salts DIFFER means one variant reads another's KV bytes (the
    # adapter's delta is part of every write). The engine prevents it by
    # folding `adapter_salt` into the chain keys; this proves it held.
    slot_adapters = {int(s): dict(e) for s, e in
                     (ledger.get("slot_adapters") or {}).items()}
    for p, hs in holders.items():
        if len(hs) > 1 and (p not in cache
                            or int(cache[p].get("refs", 0)) < len(hs)):
            bad(f"page {p} is held by slots {sorted(hs)} without a "
                "covering cache refcount (unaccounted aliasing)",
                fix="mount shared pages through the prefix cache so "
                "refcounts track every holder")
        if len(hs) > 1 and slot_adapters:
            salts = {slot_adapters.get(s, {}).get("salt", "") for s in hs}
            if len(salts) > 1:
                bad(f"page {p} is shared by slots {sorted(hs)} with "
                    "DIFFERENT adapter fingerprints — a LoRA variant is "
                    "aliasing another variant's KV bytes",
                    fix="fold the request's adapter_salt into the "
                    "prefix-cache chain keys (PrefixCache.block_keys(ids, "
                    "extra_salt=...)) so cross-variant prompts never "
                    "match the same entries")
    for p in seen:
        if p in holders:
            bad(f"page {p} is both free and held by slot(s) "
                f"{sorted(holders[p])} (double free)")
        if p in cache:
            bad(f"page {p} is both free and cache-tracked (double free: "
                "eviction must unmap before returning a page)")

    mounts = {}                          # page -> shared-mount count
    for s, sh in shared.items():
        for p in sh:
            mounts[p] = mounts.get(p, 0) + 1
            if p not in (slots.get(s) or []):
                bad(f"slot {s} marks page {p} shared but does not hold "
                    "it")
            if p not in cache:
                bad(f"slot {s} holds page {p} as shared but the cache "
                    "does not track it")
    for p, e in cache.items():
        refs = int(e.get("refs", 0))
        if refs < 0:
            bad(f"page {p} has negative refcount {refs} (double "
                "release)")
        m = mounts.get(p, 0)
        if refs != m:
            bad(f"page {p} refcount {refs} != {m} mounting slot(s) "
                "(refcount drift — the page would be freed too early "
                "or never)")
        if refs == 0 and p in holders:
            # a parked page is held by NOBODY: a slot still mapping it
            # dropped a reference without decref, and eviction would hand
            # a live-mapped page to the free list
            bad(f"page {p} is parked (refcount 0) but still held by "
                f"slot(s) {sorted(holders[p])} (reference dropped "
                "without decref)")

    owned = set(free) | set(holders) | set(cache)
    for p in range(num_pages):
        if scratch is not None and p == scratch:
            continue
        if p not in owned:
            bad(f"page {p} is unreachable: not free, not slot-held, "
                "not cached (leak)")

    # host-tier rows: a spilled entry owns NO device page unless it was
    # restored, and then its twin must be a live cache-tracked page; a
    # twin on the free list is a dropped unmount
    host = {str(k): dict(e)
            for k, e in (ledger.get("host") or {}).items()}
    free_set = set(free)
    for key, e in host.items():
        p = e.get("page")
        if p is None:
            continue
        p = int(p)
        if p in free_set:
            bad(f"host entry {key[:12]} is both host-resident and "
                f"device-free: its device twin (page {p}) sits on the "
                "free list — the unmount/spill bookkeeping dropped the "
                "backref and a later prefill would overwrite a page "
                "the tier still advertises as mounted",
                fix="clear the tier's device-twin backref "
                "(HostKVTier.note_unmounted) in the same eviction that "
                "frees the page")
        elif p not in cache:
            bad(f"host entry {key[:12]} records device twin page {p} "
                "but the cache does not track that page (stale "
                "restore backref)")
    return findings


def audit_kv_scale_planes(decoder, pages, chunk=64):
    """Scale-plane audit of a quantized KV pool: for every page in
    `pages` (slot-held or cache-tracked), a position holding nonzero
    quantized bytes must carry a positive write-time scale. The write path
    stores bytes and scales together and the floor scale is positive, so a
    zero scale under live bytes means some copy moved the page bytes but
    not its scale plane. int8 pools carry one scale per (layer, position),
    int4 pools one per (layer, position, group): there EVERY group scale
    of a written position must be positive. Reads the pool on its device,
    `chunk` pages at a time; audit-time only. Returns Finding list."""
    findings = []
    if not isinstance(decoder.k_pages, tuple):
        return findings                  # unquantized pool: nothing to check
    pages = [int(p) for p in pages]
    for name, (page_arr, scale_arr) in (("k", decoder.k_pages),
                                        ("v", decoder.v_pages)):
        for lo in range(0, len(pages), chunk):
            part = pages[lo:lo + chunk]
            idx = torch.as_tensor(part, dtype=torch.long,
                                  device=page_arr.device)
            pg = page_arr.index_select(1, idx)        # [L, n, ps, ...]
            sc = scale_arr.index_select(1, idx)
            if pg.dtype == torch.uint8:
                # int4: payload [L, n, ps, PB], scales [L, n, ps, G]
                wrote = (pg != 0).any(-1)
                orphan = wrote & (sc.amin(-1) <= 0.0)
            else:
                # int8: payload [L, n, ps, H, D], scales [L, n, ps]
                wrote = (pg != 0).flatten(3).any(-1)
                orphan = wrote & (sc <= 0.0)
            for j in orphan.any(2).any(0).nonzero().flatten().tolist():
                at = orphan[:, j].nonzero().tolist()   # [(layer, pos)]
                findings.append(Finding(
                    RULE, "ERROR",
                    f"{name}-page {part[j]} holds quantized bytes without "
                    f"write-time scales at (layer, pos) "
                    f"{[tuple(x) for x in at[:4]]}"
                    f"{'...' if len(at) > 4 else ''} — a copy moved the "
                    "page bytes but not the scale plane; the page "
                    "dequantizes to garbage",
                    suggested_fix="copy pages through "
                    "PagedGPTDecoder.copy_page (it moves bytes AND scale "
                    "planes together); never copy pool leaves "
                    "individually"))
    return findings
