"""Ragged chunk-admission scheduling: token-budgeted prefill chunks
inside the decode horizon (counterpart of
`paddle_tpu/serving/scheduler.py`, with the tiered-KV restore price the
flight recorder's horizon pricing drains).

The dispatch-separate engine paid for prompt admission with a
HOST-BLOCKING prefill: one big forward over the whole (uncached)
prompt, synced before the next decode horizon could dispatch — one
long prompt stalled every decoding slot in the batch (the ROADMAP's
"single biggest lever on serving throughput-under-load"). Ragged
serving (arxiv 2604.15464) removes the separate dispatch entirely:
the uncached suffix rides the SAME K-tick device-resident horizon as
the running decode slots (`PagedGPTDecoder.ragged_multi` — every tick
serves decode rows and w-token prefill-chunk rows through one body),
and this module owns the POLICY half:

- **Chunk budget w** — how many prompt tokens one tick may consume per
  prefilling slot. Priced by `cost_model.ragged_chunk_tokens`: the
  largest power of two whose compute leg hides under the decode tick's
  HBM roofline (`cost_model.ragged_tick_roofline_s` — while the chunk
  stays under the HBM leg, prompt tokens stream in at near-zero
  marginal tick time and the decode rows' latency jitter is bounded by
  one chunk, not one prompt).
- **Horizon K** — how many ticks to fuse per host sync, the
  `cost_model.decode_horizon` pricing extended with the mixed-tick
  roofline. Bucketed to powers of two (bounded compile count).
- **Per-slot tick accounting** — a prefilling slot's first
  ceil(suffix/w) - 1 ticks consume chunks without emitting a token
  (the tick that consumes the LAST chunk also samples the first
  generated token); the scheduler tracks how many of a dispatched
  horizon's ticks can EMIT per slot, so the engine's
  budget/inflight invariants (device `remaining` == host budget minus
  in-flight emissions) hold exactly as they did for pure decode.
"""
import math

import numpy as np

__all__ = ["RaggedScheduler", "HorizonPlan"]


class HorizonPlan:
    """One horizon's dispatch decision: `k` ticks at chunk width `w`,
    with `emit_ticks[slot]` = how many of the k ticks can emit a token
    for that slot (k minus its leading chunk-consuming ticks),
    `n_chunks` = prompt chunks consumed across all slots (the
    ServeStats ledger), and `t_tokens` = the PACKED dispatch bucket:
    the smallest power of two covering the horizon's largest per-tick
    token total (live decode rows pay 1, prefilling rows min(left, w);
    tick 0 is the max — per-row shares only shrink as prompts drain),
    floored at the slot count so pure-decode horizons always dispatch
    one stable [S] bucket. The packed engine's jit key is (k,
    t_tokens); the dense twin's is (k, w) — total-token bucketing is
    what collapses the 2-D (S, w) dispatch grid."""

    __slots__ = ("k", "w", "emit_ticks", "n_chunks", "prefill_rows",
                 "t_tokens")

    def __init__(self, k, w, emit_ticks, n_chunks, prefill_rows,
                 t_tokens=None):
        self.k = k
        self.w = w
        self.emit_ticks = emit_ticks
        self.n_chunks = n_chunks
        self.prefill_rows = prefill_rows
        self.t_tokens = t_tokens


class RaggedScheduler:
    """Chunk-admission scheduler for the mixed ragged horizon (see
    module docstring). Owns per-slot suffix accounting (`admit` /
    `retire`) and per-round planning (`plan`); the ENGINE owns pool,
    cache and output state and executes the plan."""

    def __init__(self, decoder, chunk_tokens=None, k_max=None,
                 host_sync_s=None, chip=None):
        from ..cost_model import (decode_horizon, ragged_chunk_tokens)
        self.d = decoder
        hbm = decoder.step_hbm_bytes()
        # matmul FLOPs one prompt token costs (the 2*params GPT rule —
        # same constant bench.py and prefill_ttft_s use)
        self.flops_per_token = 2.0 * decoder.cfg.num_params()
        if chunk_tokens is None:
            chunk_tokens = ragged_chunk_tokens(
                hbm, self.flops_per_token, chip=chip)
        # normalize the budget DOWN to a power of two: plan() buckets
        # the per-dispatch width to pow2, and rounding UP there would
        # exceed the per-tick token budget this parameter exists to
        # bound (the priced default is already pow2)
        ct = max(1, int(chunk_tokens))
        self.chunk_tokens = 1
        while self.chunk_tokens * 2 <= ct:
            self.chunk_tokens *= 2
        if k_max is None:
            k_max = decode_horizon(hbm, host_sync_s=host_sync_s,
                                   chip=chip, device=decoder.device,
                                   chunk_tokens=self.chunk_tokens,
                                   flops_per_token=self.flops_per_token)
        self.k_max = max(1, int(k_max))
        self._pf_left = np.zeros(decoder.max_batch, np.int64)
        self._restore_s = 0.0       # in-flight tiered-KV H2D (seconds)

    # ------------------------------------------------- tiered-KV restores

    def note_restore(self, seconds):
        """Admission just dispatched a host-tier page restore priced at
        `seconds` of H2D (`cost_model.kv_restore_s`). The mount is
        ordered on the decoder's stream before the NEXT horizon's reads,
        so that horizon's wall time carries the wire cost —
        `take_restore_s` hands the accumulated price to the engine's
        horizon pricing so the drift ledger compares like with like."""
        self._restore_s += float(seconds)

    def take_restore_s(self):
        """Drain the pending restore price (called once per dispatched
        horizon — the H2D lands inside exactly one measured window)."""
        s, self._restore_s = self._restore_s, 0.0
        return s

    # ------------------------------------------------------ accounting

    def admit(self, slot, suffix_len):
        """Slot now owes `suffix_len` uncached prompt tokens to the
        horizon (post prefix-cache mount: cached spans never get
        here)."""
        self._pf_left[slot] = int(suffix_len)

    def retire(self, slot):
        self._pf_left[slot] = 0

    def prefilling(self, slot):
        return self._pf_left[slot] > 0

    def suffix_left(self, slot):
        """Uncached suffix tokens of `slot` not yet covered by a
        dispatched horizon (part of the scheduler's public surface —
        the engine's `_table_width` position bound consumes it, so a
        custom `scheduler=` override only needs admit/retire/
        prefilling/suffix_left/plan plus chunk_tokens/k_max)."""
        return int(self._pf_left[slot])

    def stall_ticks(self, slot, w=None):
        """Ticks of slot's horizon share that CANNOT emit yet: its
        chunk-consuming ticks minus the final one (which consumes the
        last chunk AND samples the first token)."""
        w = w or self.chunk_tokens
        left = int(self._pf_left[slot])
        return max(0, math.ceil(left / w) - 1) if left else 0

    # ---------------------------------------------------------- policy

    def _compose(self, live):
        """(w, k_limit) of the next horizon — the COMPOSITION half of
        `plan`, split out so class-aware schedulers
        (`tenancy.TenantScheduler`) can re-price it per SLO class
        without touching the budget/inflight accounting below.

        Width policy: a mixed horizon's w is the smallest power of two
        covering the longest pending suffix, capped at the priced
        chunk budget — EVERY row of a tick pays w-wide compute, so a
        5-token prompt must not inflate the whole batch to the cap.
        Length policy: a mixed horizon is clamped to the chunk ticks
        it actually needs (pure-decode horizons revert to w=1 and the
        full k_max), so decode rows never ride wide windows longer
        than the prompt stream requires."""
        pf_max = max((int(self._pf_left[s]) for s in live), default=0)
        if pf_max:
            w = 1
            while w < min(self.chunk_tokens, pf_max):
                w *= 2
            # just enough ticks to finish the longest pending stream
            k_limit = min(self.k_max,
                          max(max(math.ceil(int(self._pf_left[s]) / w)
                                  for s in live if self._pf_left[s]), 1))
        else:
            w = 1
            k_limit = self.k_max
        return w, k_limit

    def plan(self, live, budgets, inflight):
        """Plan one horizon. `live` maps slot -> rid for occupied
        slots, `budgets` slot -> tokens the slot may still emit (host
        view, excluding in-flight emissions — see the engine's
        `_budget_left`), `inflight` per-slot in-flight EMISSION ticks.
        Returns a HorizonPlan, or None when no slot can make progress
        (everything emittable is already in flight). Consumes the
        planned chunk spans from the per-slot accounting. Composition
        (w, k_limit) comes from `_compose` — see its docstring for the
        width/length policy; class-aware schedulers override it."""
        w, k_limit = self._compose(live)
        avail = {}
        for s in live:
            # useful ticks = non-emitting chunk ticks + emittable ticks
            # (the tick consuming the LAST chunk also emits, so it
            # counts once, under the budget — not under pf)
            a = self.stall_ticks(s, w) + budgets[s] - inflight[s]
            if a > 0:
                avail[s] = a
        if not avail:
            return None
        k = 1
        while k * 2 <= min(min(avail.values()), k_limit):
            k *= 2
        # PACKED dispatch bucket: tick 0's token total is the horizon
        # max (per-row shares only shrink as prompts drain to decode),
        # floored at the slot count — pure-decode horizons then always
        # dispatch the one [S] bucket the dense twin's [S, 1] layout
        # costs, instead of churning variants with the live count
        from .decoder import pow2_at_least
        total = sum(min(int(self._pf_left[s]), w) if self._pf_left[s]
                    else 1 for s in live)
        t_tokens = pow2_at_least(max(total, self.d.max_batch))
        emit_ticks, n_chunks, prefill_rows = {}, 0, 0
        for s in live:
            stall = self.stall_ticks(s, w)
            # capped at the slot's remaining budget so inflight tracks
            # the device's possible emissions EXACTLY (the invariant
            # `device remaining == budget - inflight` for live slots;
            # k can exceed a slot's own avail when another slot set it)
            emit_ticks[s] = min(max(0, k - stall),
                                max(0, budgets[s] - inflight[s]))
            left = int(self._pf_left[s])
            if left:
                prefill_rows += 1
                n_chunks += min(math.ceil(left / w), k)
                self._pf_left[s] = max(0, left - k * w)
        return HorizonPlan(k, w, emit_ticks, n_chunks, prefill_rows,
                           t_tokens=t_tokens)
