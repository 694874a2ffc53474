"""Tenancy: SLO classes, preemption by page-spill, and multi-LoRA in one
ragged horizon (the port's counterpart of `paddle_tpu/serving/tenancy.py`;
numpy and the stdlib on the host side, the port's engine and decoder on the
device side).

- **SLO classes.** Requests carry a `tenant` + `slo` — "latency"
  (interactive: the queue-wait / TTFT tail is the product) or
  "throughput" (batch: aggregate tokens/s is). `TenantEngine` keeps
  latency requests at the front of the admission queue (throughput
  requests BACKFILL behind them), and `TenantScheduler` composes horizons
  per class: a latency prompt's suffix drains at the full priced chunk
  budget with the horizon clamped to the ticks it needs, and
  latency-present horizons cap at `cost_model.slo_horizon` — the
  per-class sync-overhead budget priced through the same mixed-tick
  roofline as everything else, so the per-class p99 targets
  (`slo_p99_target_s`) are roofline-derived, not hand-tuned.
- **Preemption by page-spill.** When a latency admission cannot get
  pages, a throughput victim is preempted: its full KV blocks PARK in the
  prefix cache under their adapter-salted chain keys (whence pool
  pressure spills them through the host tier), its partial tail frees,
  and the request requeues with its generated prefix as the resume
  prompt. Resume is a plain admission: the parked chain re-mounts (or
  restores from the host, or re-prefills — all byte-identical by the
  write-time (request, position) discipline), and generation continues
  with the same (seed, rid, position) sampling keys, so a
  preempted-and-resumed stream equals its never-preempted twin.
- **Multi-LoRA.** Many fine-tuned variants batch into ONE ragged horizon:
  per-row adapter ids select low-rank qkv deltas over the shared base
  weights per TOKEN (`ops.lora_delta`, a hand-written CUDA kernel on the
  card), and per-adapter `adapter_salt`s fold into the prefix-cache chain
  keys, so pages never alias across variants (audited: the page ledger's
  `slot_adapters` rows).
- **Accounting.** Per-tenant `TenantStats`, per-class pooled p50/p99 next
  to the roofline targets, Jain fairness over token shares
  (`TenantEngine.tenancy_summary`), `ServeStats.preemptions/resumes`, and
  flight-recorder tenant spans (submit records carry tenant/slo;
  `export_chrome_trace` groups request rows into one pid per tenant) with
  preempt/resume instants that `validate_chrome_trace` checks.
"""
import collections
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .engine import ContinuousBatchingEngine
from .scheduler import RaggedScheduler
from .stats import _window

__all__ = ["SLO_LATENCY", "SLO_THROUGHPUT", "TenantStats",
           "TenantScheduler", "TenantEngine", "PrecisionRoutedEngine",
           "make_lora_bank", "summarize_tenancy"]

SLO_LATENCY = "latency"
SLO_THROUGHPUT = "throughput"


def summarize_tenancy(tenants, slo_targets_s=None, preemptions=0,
                      resumes=0):
    """THE tenancy-summary math, over any {(tenant, slo):
    TenantStats} map: per-tenant ledgers (sorted keys), per-class
    pooled p50/p99 tails next to the roofline-derived targets, and
    Jain fairness over per-tenant token shares. One implementation
    for `TenantEngine.tenancy_summary` (its own `_tenants`) and the
    fleet's pooled view (`serving.fleet.FleetRouter.tenancy_summary`
    merges per-replica TenantStats first, then calls this) — a
    1-replica fleet therefore reproduces the single engine's numbers
    bit-for-bit, by construction rather than by parallel code."""
    rows = [tenants[k].summary() for k in sorted(tenants)]
    classes = {}
    for slo in (SLO_LATENCY, SLO_THROUGHPUT):
        ttft = [v for ts in tenants.values()
                if ts.slo == slo for v in ts.ttft_s]
        qw = [v for ts in tenants.values()
              if ts.slo == slo for v in ts.queue_wait_s]
        row = {}
        if ttft:
            row["ttft_p50_ms"] = round(
                float(np.percentile(ttft, 50)) * 1e3, 3)
            row["ttft_p99_ms"] = round(
                float(np.percentile(ttft, 99)) * 1e3, 3)
        if qw:
            row["queue_wait_p99_ms"] = round(
                float(np.percentile(qw, 99)) * 1e3, 3)
        if slo_targets_s is not None:
            row["roofline_target_ms"] = round(
                slo_targets_s[slo] * 1e3, 4)
        if row:
            classes[slo] = row
    # Jain's index over per-TENANT token shares (a tenant active in
    # both SLO classes is ONE entity — its ledgers merge here):
    # 1.0 = every tenant got an equal share, 1/n = one got it all
    by_tenant = {}
    for ts in tenants.values():
        if ts.requests:
            by_tenant[ts.tenant] = by_tenant.get(ts.tenant, 0) + ts.tokens
    toks = list(by_tenant.values())
    fairness = None
    if toks and sum(toks):
        fairness = round(
            (sum(toks) ** 2) / (len(toks) * sum(t * t
                                                for t in toks)), 4)
    return {"tenants": rows, "classes": classes,
            "fairness_jain": fairness,
            "preemptions": preemptions, "resumes": resumes}


def make_lora_bank(cfg, n_adapters, rank=4, seed=0, scale=0.05):
    """Random low-rank adapter bank for tests and benches: `n_adapters`
    (A [L, h, r], B [L, r, 3*H*D]) pairs over a GPT config — the shape
    `PagedGPTDecoder.attach_adapters` consumes. Deterministic in
    `seed`; `scale` keeps the deltas small enough that adapted streams
    stay coherent but distinct from the base model's."""
    rng = np.random.RandomState(seed)
    L, h = cfg.num_layers, cfg.hidden_size
    hd3 = 3 * cfg.num_heads * cfg.head_dim
    out = []
    for _ in range(int(n_adapters)):
        a = rng.randn(L, h, rank).astype(np.float32) * scale
        b = rng.randn(L, rank, hd3).astype(np.float32) * scale
        out.append((a, b))
    return out


@dataclass
class TenantStats:
    """One tenant's serving ledger (the per-tenant slice of ServeStats;
    counters lifetime, windows bounded like stats._STATS_WINDOW)."""
    tenant: str
    slo: str
    requests: int = 0
    completed: int = 0
    tokens: int = 0              # generated tokens of retired requests
    preemptions: int = 0
    resumes: int = 0
    queue_wait_s: collections.deque = field(default_factory=_window)
    ttft_s: collections.deque = field(default_factory=_window)
    occupancy: collections.deque = field(default_factory=_window)

    def summary(self):
        d = {"tenant": self.tenant, "slo": self.slo,
             "requests": self.requests, "completed": self.completed,
             "tokens": self.tokens}
        if self.preemptions or self.resumes:
            d["preemptions"] = self.preemptions
            d["resumes"] = self.resumes
        if self.occupancy:
            d["mean_slot_share"] = round(
                float(np.mean(self.occupancy)), 4)
        for name, win in (("queue_wait", self.queue_wait_s),
                          ("ttft", self.ttft_s)):
            if win:
                d[f"{name}_p50_ms"] = round(
                    float(np.percentile(win, 50)) * 1e3, 3)
                d[f"{name}_p99_ms"] = round(
                    float(np.percentile(win, 99)) * 1e3, 3)
        return d


class TenantScheduler(RaggedScheduler):
    """Class-aware horizon composition over the base chunk-admission
    scheduler: per-slot SLO classes (`set_slo`), a latency-class
    horizon cap priced by `cost_model.slo_horizon` (the latency tier
    deliberately syncs more often — admission and preemption only
    happen at horizon boundaries), and a width policy where a latency
    prefill drains at the FULL priced chunk budget while throughput
    prefills keep the base min-cover policy. The per-class p99 targets
    (`slo_targets_s`) come from `cost_model.slo_p99_target_s` — the
    same `ragged_tick_roofline_s` pricing as the chunk budget, so
    nothing here is a hand-tuned constant."""

    def __init__(self, decoder, chunk_tokens=None, k_max=None,
                 host_sync_s=None, chip=None):
        super().__init__(decoder, chunk_tokens=chunk_tokens,
                         k_max=k_max, host_sync_s=host_sync_s,
                         chip=chip)
        from ..cost_model import (measured_host_sync_s, slo_horizon,
                                  slo_p99_target_s)
        hbm = decoder.step_hbm_bytes()
        sync = (measured_host_sync_s(decoder.device) if host_sync_s is None
                else host_sync_s)
        k_lat = min(self.k_max, slo_horizon(
            hbm, SLO_LATENCY, host_sync_s=sync, chip=chip,
            chunk_tokens=self.chunk_tokens,
            flops_per_token=self.flops_per_token))
        # pow2-normalize DOWN like plan()'s k bucketing, so the clamp
        # is exactly a dispatchable horizon length
        self.k_latency = 1
        while self.k_latency * 2 <= k_lat:
            self.k_latency *= 2
        self.slo_targets_s = {
            slo: slo_p99_target_s(hbm, slo, host_sync_s=sync, chip=chip,
                                  chunk_tokens=self.chunk_tokens,
                                  flops_per_token=self.flops_per_token)
            for slo in (SLO_LATENCY, SLO_THROUGHPUT)}
        self._slo = {}               # slot -> slo class
        self._lat_queued = False

    def set_slo(self, slot, slo):
        self._slo[slot] = slo

    def retire(self, slot):
        super().retire(slot)
        self._slo.pop(slot, None)

    def note_queue(self, latency_waiting):
        """The engine's per-round signal: a latency request is WAITING
        in the queue — cap the next horizon at the latency-class K so
        its admission boundary arrives within the class target."""
        self._lat_queued = bool(latency_waiting)

    def _compose(self, live):
        lat_live = [s for s in live if self._slo.get(s) == SLO_LATENCY]
        lat_pf = [s for s in lat_live if self._pf_left[s]]
        if lat_pf:
            # latency suffixes pre-empt the chunk budget: w is sized to
            # the LATENCY streams alone (min-cover pow2, capped at the
            # priced budget — a longer throughput suffix no longer
            # stretches the drain), and the horizon clamps to the
            # ticks the latency stream needs so its first token lands
            # at the earliest sync. Throughput prefill rows BACKFILL
            # the same ticks with their min(left, w) shares.
            pf_max = max(int(self._pf_left[s]) for s in lat_pf)
            w = 1
            while w < min(self.chunk_tokens, pf_max):
                w *= 2
            k_limit = min(self.k_latency,
                          max(1, math.ceil(pf_max / w)))
            return w, k_limit
        w, k_limit = super()._compose(live)
        if lat_live or self._lat_queued:
            k_limit = min(k_limit, self.k_latency)
        return w, k_limit


class TenantEngine(ContinuousBatchingEngine):
    """Multi-tenant continuous batching: the base ragged engine with
    per-request (tenant, slo) classes, latency-first admission with
    throughput backfill, preemption by page-spill, per-tenant
    accounting, and multi-LoRA via per-request adapter ids (the
    decoder must carry a bank — `attach_adapters` — for nonzero ids).
    Always ragged: the preemption/resume discipline rides the chunked
    admission path."""

    def __init__(self, decoder, eos_token_id=None, max_new_tokens=64,
                 k_max=None, host_sync_s=None, prefix_cache=None,
                 chunk_tokens=None, scheduler=None, trace=None,
                 packed=None, host_tier=None, tier_policy="auto",
                 preemption=True):
        if scheduler is None:
            scheduler = TenantScheduler(decoder,
                                        chunk_tokens=chunk_tokens,
                                        k_max=k_max,
                                        host_sync_s=host_sync_s)
        super().__init__(decoder, eos_token_id, max_new_tokens,
                         k_max=k_max, host_sync_s=host_sync_s,
                         prefix_cache=prefix_cache, ragged=True,
                         chunk_tokens=chunk_tokens, scheduler=scheduler,
                         trace=trace, packed=packed,
                         host_tier=host_tier, tier_policy=tier_policy)
        self.preemption = bool(preemption)
        self._rid_tenant = {}        # rid -> (tenant, slo)
        self._rid_prompt = {}        # rid -> token list (resume prefix)
        self._tenants = {}           # (tenant, slo) -> TenantStats
        self._resumed = set()        # rids requeued by preemption
        self._freeze_slots = set()   # preempted slots to freeze on dev
        self._submit_meta = ("default", SLO_THROUGHPUT)
        if self.trace is not None:
            self.trace.meta["tenancy"] = True

    # ------------------------------------------------------- submission

    def submit(self, prompt_ids, tenant="default", slo=SLO_THROUGHPUT,
               adapter=None):
        """Queue one prompt under a tenant + SLO class. `slo="latency"`
        requests admit ahead of the throughput backlog (and may
        preempt throughput slots under pool pressure);
        `slo="throughput"` requests backfill. `adapter` selects a LoRA
        variant (see the base engine)."""
        if slo not in (SLO_LATENCY, SLO_THROUGHPUT):
            raise ValueError(
                f"slo must be {SLO_LATENCY!r} or {SLO_THROUGHPUT!r}, "
                f"got {slo!r}")
        self._submit_meta = (str(tenant), slo)
        return super().submit(prompt_ids, adapter=adapter)

    def _register_request(self, ids, adapter=0, trace_fields=None):
        tenant, slo = self._submit_meta
        fields = dict(trace_fields or {})
        fields.update(tenant=tenant, slo=slo)
        rid = super()._register_request(ids, adapter=adapter,
                                        trace_fields=fields)
        self._rid_tenant[rid] = (tenant, slo)
        self._rid_prompt[rid] = list(ids)
        self._tenant(tenant, slo).requests += 1
        if slo == SLO_LATENCY:
            # latency requests queue ahead of the throughput backlog
            # (FIFO among themselves)
            entry = self._queue.pop()
            self._queue.insert(self._latency_cut(), entry)
        return rid

    def _latency_cut(self):
        """Index one past the queue's latency section (latency entries
        are kept contiguous at the front)."""
        i = 0
        while i < len(self._queue) and \
                self._slo_of(self._queue[i][0]) == SLO_LATENCY:
            i += 1
        return i

    def _slo_of(self, rid):
        return self._rid_tenant.get(rid, ("", SLO_THROUGHPUT))[1]

    def _tenant(self, tenant, slo):
        key = (tenant, slo)
        ts = self._tenants.get(key)
        if ts is None:
            ts = self._tenants[key] = TenantStats(tenant=tenant, slo=slo)
        return ts

    def _tenant_of(self, rid):
        tenant, slo = self._rid_tenant.get(rid,
                                           ("default", SLO_THROUGHPUT))
        return self._tenant(tenant, slo)

    # ------------------------------------------------------- accounting

    def _note_queue_wait(self, rid, dt):
        super()._note_queue_wait(rid, dt)
        self._tenant_of(rid).queue_wait_s.append(dt)

    def _note_ttft(self, rid, dt):
        super()._note_ttft(rid, dt)
        self._tenant_of(rid).ttft_s.append(dt)

    def _note_resident(self):
        super()._note_resident()
        S = self.d.max_batch
        counts = {}
        for s in range(S):
            rid = self._slot_req[s]
            if rid is None:
                continue
            key = self._rid_tenant.get(rid)
            if key is not None:
                counts[key] = counts.get(key, 0) + 1
        for key, n in counts.items():
            self._tenant(*key).occupancy.append(n / S)

    def _retire(self, slot):
        rid = self._slot_req[slot]
        if rid is not None:
            ts = self._tenant_of(rid)
            ts.completed += 1
            ts.tokens += len(self._outputs.get(rid, ()))
            self._rid_tenant.pop(rid, None)
            self._rid_prompt.pop(rid, None)
            self._resumed.discard(rid)
        super()._retire(slot)

    def tenancy_summary(self):
        """Per-tenant ledgers + per-class pooled tails next to the
        scheduler's roofline-derived targets + fairness: the
        multi-tenant observability front door (the bench's JSON line
        and debug.serving_report read it). The math lives in
        `summarize_tenancy` — shared with the fleet's pooled view."""
        return summarize_tenancy(
            self._tenants,
            slo_targets_s=getattr(self.scheduler, "slo_targets_s",
                                  None),
            preemptions=self.stats.preemptions,
            resumes=self.stats.resumes)

    # ------------------------------------------------------- scheduling

    def _admit_ragged(self):
        # slot-exhaustion preemption: a latency head facing a fully
        # occupied slot table preempts for the SLOT itself — the
        # page-shortage path (`_admission_blocked`) never runs when
        # the admission loop finds no free slot to try
        if self.preemption and self._queue and \
                self._slo_of(self._queue[0][0]) == SLO_LATENCY and \
                all(r is not None for r in self._slot_req):
            victim = self._pick_victim()
            if victim is not None:
                self._preempt(victim)
        plans = super()._admit_ragged()
        sched = self.scheduler
        for slot, rid, _suffix in plans:
            if hasattr(sched, "set_slo"):
                sched.set_slo(slot, self._slo_of(rid))
            if rid in self._resumed:
                self._resumed.discard(rid)
                self.stats.resumes += 1
                self._tenant_of(rid).resumes += 1
                if self.trace is not None:
                    self.trace.record(
                        "resume", rid=rid, slot=slot,
                        tokens=len(self._outputs.get(rid, ())))
        if hasattr(sched, "note_queue"):
            sched.note_queue(any(self._slo_of(r) == SLO_LATENCY
                                 for r, _ in self._queue))
        return plans

    def _merge_carry_ragged(self, carry, plans):
        if carry is not None and self._freeze_slots:
            # a preempted slot's device row must FREEZE (its writes
            # route to scratch, its filler ticks stop consuming
            # budget) until a new admission revives the slot — applied
            # BEFORE the merge so a same-round re-admission into the
            # slot wins
            tokens, lens, done, rem, pend, pend_n = carry
            idx = torch.as_tensor(sorted(self._freeze_slots),
                                  dtype=torch.long, device=done.device)
            done = done.index_fill(0, idx, True)
            pend_n = pend_n.index_fill(0, idx, 0)
            carry = (tokens, lens, done, rem, pend, pend_n)
        self._freeze_slots.clear()
        return super()._merge_carry_ragged(carry, plans)

    # ------------------------------------------------------- preemption

    def _admission_blocked(self, rid, need):
        """A latency head that can't get pages preempts a throughput
        victim (pages park/spill — `_preempt`) and returns False so
        the admission replans; anything else keeps the base
        head-of-line wait."""
        if not self.preemption or self._slo_of(rid) != SLO_LATENCY:
            return True
        victim = self._pick_victim()
        if victim is None:
            return True
        self._preempt(victim)
        return False

    def _pick_victim(self):
        """The throughput-tier slot with the most remaining budget
        (fewest tokens banked — the cheapest stream to re-drive if the
        parked chain degrades), decode-phase only: a mid-prefill
        slot's device-side chunk progress is not host-observable, so
        its parkable span is unknown."""
        best = None
        for s in range(self.d.max_batch):
            rid = self._slot_req[s]
            if rid is None or self._slo_of(rid) != SLO_THROUGHPUT:
                continue
            emitted = len(self._outputs.get(rid, ())) - \
                self._emit_base.get(rid, 0)
            if emitted <= 0:
                continue                 # still prefilling
            rem = self._budget_left(s)
            if rem <= 0:
                continue                 # retiring at the next sync
            if best is None or (rem, s) > best[0]:
                best = ((rem, s), s)
        return None if best is None else best[1]

    def _preempt(self, slot):
        """Preemption by page-spill: park the victim's full KV blocks
        in the prefix cache (insert under their chain keys, then
        release — refcount-0 pages PARK, and pool pressure spills them
        through the host tier exactly like any parked page), free the
        partial tail, requeue the request with prompt+generated as its
        resume prefix, and freeze the slot's device row. The resumed
        request's continuation re-mounts (or restores, or recomputes)
        the same write-time bytes and draws with the same (seed, rid,
        position) keys, so its stream is byte-identical to the
        never-preempted twin."""
        rid = self._slot_req[slot]
        outputs = self._outputs.get(rid, [])
        # _rid_prompt holds the ORIGINAL prompt for the request's whole
        # life — the resume prompt is always original + cumulative
        # outputs, derived fresh here (storing the derived prompt back
        # would duplicate the pre-preemption prefix on a SECOND
        # preemption: full = (P+gen1) + (gen1+gen2) — test-pinned)
        full = self._rid_prompt[rid] + list(outputs)
        L = int(self._lens[slot])        # consumed positions (host)
        ps = self.d.page_size
        n_full = L // ps
        pages = self._slot_pages[slot]
        shared = self._slot_shared[slot]
        parked = 0
        freed = []
        if self.cache is not None:
            keys = self.cache.block_keys(
                full[:L], extra_salt=self.d.adapter_salt(
                    self._rid_adapter.get(rid, 0)))
            # pass 1: INSERT private full blocks under their chain
            # keys while every parent is still held (mounted shared,
            # or inserted just above) — publish-stop at the first
            # refusal, exactly like _publish_blocks
            owned = []                   # pages to release in pass 2
            stopped = False
            for b in range(n_full):
                p = pages[b]
                if p in shared:
                    owned.append(p)
                elif not stopped and self.cache.insert(
                        keys[b], p, parent=keys[b - 1] if b else None):
                    owned.append(p)
                else:
                    stopped = True
                    freed.append(p)
            # pass 2: drop this request's references — every parked
            # block is now reclaimable (and spillable) cache property
            for p in owned:
                self.cache.release_page(p)
            parked = len(owned)
        else:
            freed.extend(pages[:n_full])
        freed.extend(pages[n_full:])     # partial tail: recomputed at
        self._free.extend(freed)         # resume, byte-identically
        # requeue at the front of the throughput section, AFTER any
        # earlier-preempted victims already waiting there (FIFO among
        # victims: first interrupted, first resumed)
        self._emit_base[rid] = len(outputs)
        i = self._latency_cut()
        while i < len(self._queue) and \
                self._queue[i][0] in self._resumed:
            i += 1
        self._resumed.add(rid)
        self._queue.insert(i, (rid, full))
        # release the slot (NOT _retire: the request is not done — no
        # completed count, rid bookkeeping kept) and freeze its device
        # row until a new admission revives it
        self._release_slot(slot)
        self._freeze_slots.add(slot)
        self.stats.preemptions += 1
        ts = self._tenant_of(rid)
        ts.preemptions += 1
        if self.trace is not None:
            self.trace.record("preempt", rid=rid, slot=slot,
                              tenant=self._rid_tenant[rid][0],
                              tokens=len(outputs), parked=parked,
                              freed=len(freed))


class PrecisionRoutedEngine:
    """Per-SLO-class KV precision policy: ONE logical engine whose
    latency and throughput tiers run pools of DIFFERENT quant widths —
    e.g. ``kv_precision={"latency": "int8", "throughput": "int4"}``
    serves interactive traffic from the wider (more accurate) pool
    while the batch tier banks the nibble-packed pool's ~1.65x extra
    KV capacity. KV capacity-vs-quality becomes a scheduler knob, not
    a build flag.

    Mechanics: each distinct precision gets its own `PagedGPTDecoder`
    (its own physical pool) + `PrefixCache` salted by that decoder's
    `cache_fingerprint()` + `TenantEngine` (whose `TenantScheduler`
    prices the class horizon cap and p99 targets from THAT pool's
    `step_hbm_bytes()` — per-class admission capacity reflects the
    real byte stream, not a shared average). Classes sharing a
    precision share one engine. Pages can never alias across
    precision classes: the pools are physically separate arrays AND
    the fingerprint salt differs (`kv_quant` + pool leaf dtype are
    folded in), so even an external shared tier keys them apart.

    Request identity: ONE global rid counter spans the classes and is
    stamped into the owning engine's allocator before each submit
    (the `FleetRouter` idiom) — rid is the sampling-key id, so a
    request's stream is byte-identical to what a single-class engine
    would emit for the same (seed, rid, position) draws.

    The port's decoder is built from (cfg, state_dict), so those two take
    the place of the JAX engine's `model`; every other keyword keeps its
    JAX name (`dec_kw` goes to each `PagedGPTDecoder` — `device="cpu"`
    there for a CPU run; the card by default)."""

    def __init__(self, cfg, state_dict, kv_precision=None,
                 eos_token_id=None, max_new_tokens=64, num_pages=32,
                 page_size=16, max_batch=2, k_max=None, chunk_tokens=None,
                 prefix_cache=True, dec_kw=None, eng_kw=None):
        from .decoder import PagedGPTDecoder
        from .prefix_cache import PrefixCache
        kv_precision = dict(kv_precision or {})
        unknown = set(kv_precision) - {SLO_LATENCY, SLO_THROUGHPUT}
        if unknown:
            raise ValueError(
                f"kv_precision keys must be SLO classes "
                f"({SLO_LATENCY!r}/{SLO_THROUGHPUT!r}), got "
                f"{sorted(unknown)!r}")
        for slo in (SLO_LATENCY, SLO_THROUGHPUT):
            kv_precision.setdefault(slo, None)
        self.kv_precision = kv_precision
        self.decoders = {}           # slo -> PagedGPTDecoder
        self.engines = {}            # slo -> TenantEngine
        by_quant = {}                # quant -> engine (shared pools)
        for slo in (SLO_LATENCY, SLO_THROUGHPUT):
            quant = kv_precision[slo]
            if quant in by_quant:
                eng = by_quant[quant]
                self.decoders[slo] = eng.d
                self.engines[slo] = eng
                continue
            dec = PagedGPTDecoder(cfg, state_dict, num_pages=num_pages,
                                  page_size=page_size,
                                  max_batch=max_batch, kv_quant=quant,
                                  **(dec_kw or {}))
            cache = PrefixCache(dec.page_size,
                                salt=dec.cache_fingerprint()) \
                if prefix_cache else None
            eng = TenantEngine(dec, eos_token_id=eos_token_id,
                               max_new_tokens=max_new_tokens,
                               k_max=k_max, chunk_tokens=chunk_tokens,
                               prefix_cache=cache, **(eng_kw or {}))
            by_quant[quant] = eng
            self.decoders[slo] = dec
            self.engines[slo] = eng
        self._next_rid = 0           # global rid: THE sampling identity
        self._rid_slo = {}

    def submit(self, prompt_ids, tenant="default", slo=SLO_THROUGHPUT,
               adapter=None):
        """Queue one prompt on its class's engine; returns the GLOBAL
        request id (unique across classes — streams keyed by it)."""
        if slo not in self.engines:
            raise ValueError(
                f"slo must be {SLO_LATENCY!r} or {SLO_THROUGHPUT!r}, "
                f"got {slo!r}")
        eng = self.engines[slo]
        gid = self._next_rid
        self._next_rid = gid + 1
        eng._next_id = gid           # rid IS the sampling key id
        rid = eng.submit(prompt_ids, tenant=tenant, slo=slo,
                         adapter=adapter)
        assert rid == gid, (rid, gid)
        self._rid_slo[gid] = slo
        return gid

    def _unique_engines(self):
        seen, order = set(), []
        for slo in (SLO_LATENCY, SLO_THROUGHPUT):
            eng = self.engines[slo]
            if id(eng) not in seen:
                seen.add(id(eng))
                order.append(eng)
        return order

    def run(self, on_sync=None):
        """Drain every class engine (latency first, then throughput,
        looped until no churn — `on_sync(router, engine)` callbacks
        may submit more work mid-run). Returns {global rid: token
        list} across all classes."""
        outputs = {}
        hookof = (lambda e: (lambda en: on_sync(self, en))) \
            if on_sync is not None else (lambda e: None)
        while True:
            progressed = False
            for eng in self._unique_engines():
                if eng._queue:
                    outputs.update(eng.run(on_sync=hookof(eng)))
                    progressed = True
            if not progressed:
                return outputs

    def class_capacity(self):
        """Per-class admission economics, each priced from its OWN
        pool: quant mode, per-token/per-step bytes, pool capacity in
        tokens, and the scheduler's roofline-derived latency horizon
        cap + p99 target. The observability hook the capacity bench
        and tests pin the policy through."""
        out = {}
        for slo in (SLO_LATENCY, SLO_THROUGHPUT):
            dec, eng = self.decoders[slo], self.engines[slo]
            out[slo] = {
                "kv_quant": dec.kv_quant,
                "kv_token_bytes": int(dec.kv_token_bytes *
                                      dec.cfg.num_layers),
                "step_hbm_bytes": dec.step_hbm_bytes(),
                "pool_tokens": (dec.num_pages - 1) * dec.page_size,
                "k_latency": eng.scheduler.k_latency,
                "slo_target_s": eng.scheduler.slo_targets_s[slo],
            }
        return out

    def tenancy_summary(self):
        """Pooled tenancy view over the class engines — the same
        merge-then-`summarize_tenancy` math as the fleet, with each
        class's roofline target taken from ITS OWN scheduler (they
        differ when the pools do: that asymmetry is the policy)."""
        merged = {}
        for eng in self._unique_engines():
            for key, ts in eng._tenants.items():
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
        targets = {
            slo: self.engines[slo].scheduler.slo_targets_s[slo]
            for slo in (SLO_LATENCY, SLO_THROUGHPUT)}
        return summarize_tenancy(
            merged, slo_targets_s=targets,
            preemptions=sum(e.stats.preemptions
                            for e in self._unique_engines()),
            resumes=sum(e.stats.resumes
                        for e in self._unique_engines()))
