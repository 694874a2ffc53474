"""Continuous-batching engine over the paged decoder (counterpart of
`paddle_tpu/serving/engine.py` `ContinuousBatchingEngine`): slot
scheduling, ragged chunked-prefill horizons and the per-tick loop.

Ported: the ragged packed horizon loop (`_run_ragged`, the default for
k_max > 1) and the per-tick loop (`step` / `_run_per_tick`, k_max=1),
which is the in-port oracle for it. Not ported yet: the prefix cache,
the host KV tier, the flight recorder, the dispatch-separate baseline
(`ragged=False` with k_max > 1), LoRA adapters, tenancy hooks and the
speculative engine.
"""
import time

import numpy as np
import torch

from .decoder import PagedGPTDecoder, _not_ported
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
    (`cost_model.decode_horizon`)."""

    def __init__(self, decoder: PagedGPTDecoder, eos_token_id=None,
                 max_new_tokens=64, k_max=None, prefix_cache=None,
                 ragged=None, chunk_tokens=None, trace=None,
                 host_tier=None):
        if max_new_tokens < 1:
            raise ValueError(
                "max_new_tokens must be >= 1 (the prefill forward always "
                f"produces one token), got {max_new_tokens}")
        if prefix_cache:
            raise _not_ported("the prefix cache (prefix_cache=)")
        if host_tier:
            raise _not_ported("the host KV tier (host_tier=)")
        if trace:
            raise _not_ported("the flight recorder (trace=)")
        self.d = decoder
        self.eos = eos_token_id
        self.max_new = max_new_tokens
        # page 0..num_pages-2 allocatable; last page reserved as scratch
        self._free = list(range(decoder.num_pages - 2, -1, -1))
        S = decoder.max_batch
        self._slot_req = [None] * S          # request id per slot
        self._slot_pages = [[] for _ in range(S)]
        # int32 end to end: the decoder feeds these to the kernel as int32
        self._lens = np.zeros(S, np.int32)
        self._tokens = np.zeros(S, np.int32)
        # per-slot admission generation: a block dispatched for an earlier
        # occupancy of the slot must never book-keep against a later one
        self._slot_gen = [0] * S
        self._table_cache = None             # rebuilt on admit/retire only
        self._queue = []                     # (req_id, ids)
        self._outputs = {}                   # req_id -> [generated ids]
        self._next_id = 0
        self.steps = 0
        self.k_max = max(1, int(k_max)) if k_max is not None else None
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
        self._submit_t = {}                  # rid -> submit wall time
        _ENGINES.add(self)

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
        firsts = self.d.prefill_suffix_batch(
            [(ids, 0, pages) for _, _, ids, pages in admitted])
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
            live.append(slot)
        return live

    def _gather_admissions(self):
        """Bind queued requests to free slots in order while their pages
        fit (head-of-line: a request that does not fit waits, and so do
        the ones behind it)."""
        admitted = []
        for slot in range(self.d.max_batch):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            rid, ids = self._queue[0]
            need = self._pages_for(len(ids) + self.max_new)
            if need > self.d.max_pages or need > len(self._free):
                break
            self._queue.pop(0)
            pages = [self._free.pop() for _ in range(need)]
            self._slot_req[slot] = rid
            self._slot_gen[slot] += 1
            self._slot_pages[slot] = pages
            admitted.append((slot, rid, ids, pages))
        return admitted

    def _retire(self, slot):
        """Free the slot's pages and clear every per-slot field (the
        generation bump makes any in-flight block of this occupancy
        stale)."""
        self._free.extend(self._slot_pages[slot])
        self.stats.completed += 1
        self._slot_req[slot] = None
        self._slot_pages[slot] = []
        self._slot_gen[slot] += 1
        self._lens[slot] = 0
        self._tokens[slot] = 0
        self._prompt_len[slot] = 0
        if self.scheduler is not None:
            self.scheduler.retire(slot)
        self._table_cache = None

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
        nxt = self.d.decode(self._tokens, self._lens,
                            self._table_cache).cpu().numpy()
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
        """Admission without a prefill dispatch: allocate pages and hand
        the prompt to the SCHEDULER — it streams into the horizon w
        tokens per tick from the device-resident pend carry. Returns
        [(slot, rid, prompt), ...] for the carry merge."""
        admitted = self._gather_admissions()
        if not admitted:
            return []
        self._note_queue_waits(admitted)
        self._table_cache = None
        plans = []
        for slot, rid, ids, _pages in admitted:
            self._outputs[rid] = []
            self._lens[slot] = 0
            self._tokens[slot] = 0
            self._prompt_len[slot] = len(ids)
            self.scheduler.admit(slot, len(ids))
            self.stats.prefill_chunk_tokens += len(ids)
            plans.append((slot, rid, ids))
        return plans

    def _first_token(self, rid, slot):
        """A request's FIRST token just landed on the host: stamp TTFT
        (submit -> first token, however many horizons the prefill
        spanned)."""
        t0 = self._submit_t.pop(rid, None)
        if t0 is not None:
            self.stats.ttft_s.append(time.perf_counter() - t0)
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
                    plan.k, plan.w, pend_d, pend_n_d, done=done_d,
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
