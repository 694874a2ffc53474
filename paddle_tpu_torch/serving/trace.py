"""Flight recorder: a bounded, off-by-default structured event log of
the serving engines (the port's own copy of `paddle_tpu/serving/trace.py`,
stdlib only).

The aggregate `ServeStats` counters say WHAT happened (tokens, syncs,
hit rates); the flight recorder says WHY a given horizon was composed
the way it was and what one request experienced:

- **request lifecycle spans** — submit → admit (with prefix-cache
  mount detail) → first token → per-N-token progress → retire, keyed
  by request id;
- **per-tick scheduler decision records** — one event per dispatched
  horizon with its row composition (k, w, decode/prefill rows), the
  roofline-PREDICTED cost (`cost_model.ragged_tick_legs` per tick plus
  one host sync, priced for the H100) and the MEASURED wall time, with
  pool events (CoW copies, evictions) folded in;
- **drift accounting** — a rolling predicted-vs-measured ratio per
  dispatch shape (`drift_report()`), the data behind
  `debug.serving_report()`: a shape whose measured tick departs from
  the priced max(compute, HBM) by more than a configurable factor is a
  mispriced schedule, surfaced instead of silently absorbed. The
  tiered-KV path rides the same machinery: "spill" events mark pages
  demoted to the host tier, and restores record ("h2d_restore",)
  ticks whose predicted (`cost_model.kv_restore_s`) vs measured H2D
  feeds this ledger.

Non-perturbation is a hard contract: the recorder only ever touches
host-side values the engine already fetched (never a device tensor),
so streams are byte-identical with tracing on, and with tracing off
every hook is a dead `if engine.trace is not None` branch — zero
allocations per tick (test-pinned via `FlightRecorder.total_events`).
Memory is O(1): events and per-shape drift samples live in bounded
deques.

Timestamps are raw `time.perf_counter()` seconds. The port has no
`profiler` module yet, so `export_chrome_trace(profiler=...)` raises;
the request spans and tick records export alone. Token VALUES are never
recorded (counts and ids only): traces are shareable without leaking
prompt content.
"""
import collections
import json
import os
import time

__all__ = ["FlightRecorder", "export_chrome_trace",
           "validate_chrome_trace"]

# bounded windows: a long-lived engine's trace stays O(1) memory
_EVENT_WINDOW = 4096
_DRIFT_WINDOW = 256

# drift verdict default: measured/predicted beyond this factor (either
# direction) marks a dispatch shape as mispriced
DRIFT_FACTOR = 3.0


class FlightRecorder:
    """One engine's structured event log. Construct and pass as
    `ContinuousBatchingEngine(..., trace=recorder)` (or `trace=True` for
    a default one).

    `events` is a bounded deque of dicts, each carrying `kind`, `ts`
    (perf_counter seconds) and kind-specific fields; `tick` events
    additionally feed the per-shape drift windows. `total_events` is a
    CLASS-level counter of every record() across the process — the
    tracing-off tests pin that a run without a recorder leaves it
    untouched (the hooks must be dead branches, not cheap branches)."""

    total_events = 0          # class-wide: the dead-branch test's probe

    def __init__(self, capacity=_EVENT_WINDOW, drift_window=_DRIFT_WINDOW,
                 drift_factor=DRIFT_FACTOR, progress_every=16):
        self.events = collections.deque(maxlen=int(capacity))
        self.drift_window = int(drift_window)
        self.drift_factor = float(drift_factor)
        self.progress_every = max(1, int(progress_every))
        self.meta = {}                   # engine-stamped context (quant
        # config, k_max, page size): exported once as trace metadata
        self._drift = {}                 # shape tuple -> deque[(pred, meas)]

    # ------------------------------------------------------------ record

    def record(self, kind, ts=None, **fields):
        """Append one structured event; returns the (mutable) event
        dict so two-phase callers (tick_dispatch/tick_complete) can
        fill measured fields in place without a second allocation."""
        ev = {"kind": kind,
              "ts": time.perf_counter() if ts is None else float(ts)}
        ev.update(fields)
        self.events.append(ev)
        FlightRecorder.total_events += 1
        return ev

    # ------------------------------------------------- scheduler ticks

    def tick_dispatch(self, track, shape, predicted_s=None, ts=None,
                      **fields):
        """Open one scheduler decision record at dispatch time.
        `track` names the timeline ("serve"/"train"), `shape` the
        dispatch shape the drift accounting keys on (e.g.
        ("ragged", k, w)), `predicted_s` the roofline-priced horizon
        cost. Complete it with `tick_complete` once the measured wall
        time is known (the engines call complete at block-processing
        time, where the fetch-overlap window closes)."""
        return self.record("tick", ts=ts, track=str(track),
                           shape=list(shape), predicted_s=predicted_s,
                           measured_s=None, **fields)

    def tick_complete(self, ev, measured_s, drift=True, **fields):
        """Close a dispatched tick record with its measured wall
        seconds (and any late fields, e.g. pool-event deltas); feeds
        the per-shape drift window when the dispatch was priced.
        `drift=False` keeps the record but skips the ledger — for
        windows the caller knows are polluted (a prefill landed inside
        the measured span), mirroring the engines' token-percentile
        exclusions.  A `predicted_serial_s` field on the record (the
        SERIAL sum of the priced legs, vs `predicted_s`'s overlapped
        max) rides into the window: `drift_report` uses the band to
        tell a mispriced leg from a serialized schedule."""
        ev["measured_s"] = float(measured_s)
        ev.update(fields)
        pred = ev.get("predicted_s")
        if drift and pred and pred > 0:
            key = tuple(ev["shape"])
            win = self._drift.get(key)
            if win is None:
                win = self._drift[key] = collections.deque(
                    maxlen=self.drift_window)
            serial = ev.get("predicted_serial_s")
            win.append((float(pred), float(measured_s),
                        float(serial) if serial else None))
        return ev

    def tick(self, track, shape, measured_s, predicted_s=None, ts=None,
             drift=True, **fields):
        """One-shot dispatch+complete (the restore tick's form);
        `drift=False` records the tick but keeps its window out of the
        ledger (see tick_complete)."""
        return self.tick_complete(
            self.tick_dispatch(track, shape, predicted_s=predicted_s,
                               ts=ts, **fields), measured_s, drift=drift)

    # ------------------------------------------------------------- drift

    def drift_report(self, factor=None):
        """Rolling predicted-vs-measured accounting per dispatch
        shape: [{shape, n, predicted_s, measured_s, ratio, drifting
        [, predicted_serial_s, serial_ratio, verdict]}].
        `ratio` is mean(measured)/mean(predicted) over the shape's
        window; `drifting` marks shapes whose ratio departs from 1 by
        more than `factor` (default: the recorder's drift_factor) in
        either direction (`debug.serving_report` lists them).

        When the ticks also carried `predicted_serial_s` (the serial
        sum of the priced legs — the engines stamp it next
        to the overlapped `predicted_s`), an over-drifting shape gets a
        VERDICT: "serialized" when the measured mean still sits within
        `factor` of the serial prediction (the legs are priced right —
        the schedule just never overlapped them), else "mispriced" (the
        measured time escapes even the serial sum — some pricing INPUT
        is wrong). Under-drifting shapes stay "overpriced"."""
        factor = self.drift_factor if factor is None else float(factor)
        out = []
        for key in sorted(self._drift, key=str):
            win = self._drift[key]
            if not win:
                continue
            pred = sum(s[0] for s in win) / len(win)
            meas = sum(s[1] for s in win) / len(win)
            ratio = meas / pred if pred > 0 else float("inf")
            drifting = bool(ratio > factor or ratio < 1.0 / factor)
            entry = {"shape": list(key), "n": len(win),
                     "predicted_s": pred, "measured_s": meas,
                     "ratio": ratio, "drifting": drifting}
            serials = [s[2] for s in win
                       if len(s) > 2 and s[2] is not None]
            if serials:
                serial = sum(serials) / len(serials)
                entry["predicted_serial_s"] = serial
                entry["serial_ratio"] = (meas / serial if serial > 0
                                         else float("inf"))
            if drifting:
                if ratio < 1.0:
                    entry["verdict"] = "overpriced"
                elif entry.get("serial_ratio") is not None and \
                        entry["serial_ratio"] <= factor:
                    entry["verdict"] = "serialized"
                else:
                    entry["verdict"] = "mispriced"
            out.append(entry)
        return out

    def summary(self):
        kinds = collections.Counter(ev["kind"] for ev in self.events)
        return {"events": len(self.events), "kinds": dict(kinds),
                "drift": self.drift_report(), **(
                    {"meta": dict(self.meta)} if self.meta else {})}

    # ----------------------------------------------------- chrome trace

    # request-lifecycle milestones -> the span segment each one CLOSES
    _SEGMENTS = (("submit", "admit", "queued"),
                 ("admit", "first_token", "prefill"),
                 ("first_token", "retire", "decode"))

    def chrome_events(self, pid=1, label="serving"):
        """Render this recorder's log as chrome-trace events: request
        spans as per-request "X" slices (tid = request id, one Perfetto
        row per request), progress/preempt/resume marks as instants,
        tick records as "X" slices on a per-track scheduler row with
        predicted vs measured in args. Timestamps are perf_counter
        microseconds.

        TENANT grouping (serving.tenancy): requests whose submit
        record carries a `tenant` field render under one pid PER
        TENANT (pids after the tick row, sorted by tenant name), so a
        multi-tenant trace reads as one Perfetto process per tenant;
        untenanted requests keep the base `pid`."""
        out = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"{label} requests",
                         **({"meta": dict(self.meta)} if self.meta
                            else {})}}]
        spans = {}                       # rid -> {milestone: ts}
        ticks = []
        rid_tenant = {}                  # rid -> tenant (span grouping)
        for ev in self.events:
            kind = ev["kind"]
            if kind == "tick":
                ticks.append(ev)
            elif "rid" in ev:
                spans.setdefault(ev["rid"], []).append(ev)
                if "tenant" in ev:
                    rid_tenant.setdefault(ev["rid"], str(ev["tenant"]))
        # tenant pids live PAST the tick row (pid + 1), so adding a
        # tenant never renumbers the tick track
        tenant_pid = {t: pid + 2 + i for i, t in
                      enumerate(sorted(set(rid_tenant.values())))}
        for t, tp in sorted(tenant_pid.items()):
            out.append({"name": "process_name", "ph": "M", "pid": tp,
                        "tid": 0,
                        "args": {"name": f"{label} requests — "
                                 f"tenant={t}"}})
        for rid, evs in sorted(spans.items()):
            rpid = tenant_pid.get(rid_tenant.get(rid), pid)
            marks = {}
            for ev in evs:
                marks.setdefault(ev["kind"], ev)
                if ev["kind"] in ("progress", "preempt", "resume"):
                    args = {k: v for k, v in ev.items()
                            if k not in ("kind", "ts", "rid")}
                    out.append({"name": f"req{rid}:{ev['kind']}",
                                "ph": "i", "s": "t",
                                "ts": ev["ts"] * 1e6, "pid": rpid,
                                "tid": int(rid), "args": args})
            for start, end, seg in self._SEGMENTS:
                if start in marks and end in marks:
                    t0, t1 = marks[start]["ts"], marks[end]["ts"]
                    args = {k: v for k, v in marks[start].items()
                            if k not in ("kind", "ts")}
                    # dur from the CONVERTED endpoints, so consecutive
                    # segments abut exactly in µs (t0*1e6 + (t1-t0)*1e6
                    # can exceed t1*1e6 by ulps and read as overlap)
                    out.append({"name": f"req{rid}:{seg}", "ph": "X",
                                "ts": t0 * 1e6,
                                "dur": max(t1 * 1e6 - t0 * 1e6, 0.0),
                                "pid": rpid, "tid": int(rid),
                                "args": args})
        # MULTIPLE lanes per track: the engines close a tick's
        # measured window AFTER the next horizon is dispatched
        # (fetch-overlap), so consecutive slices genuinely overlap in
        # time — chrome "X" slices on one tid must nest or abut, never
        # partially overlap. Pipelined horizons alone need two lanes,
        # but ONE-SHOT ticks landing between them (h2d_restore, a
        # Trainer tick) can desync any fixed alternation — so lanes
        # are assigned GREEDILY: each slice takes the first lane whose
        # previous slice has ended, growing the lane set only when
        # every lane is still busy (interval-graph coloring; in
        # practice 2, occasionally 3). Lane tids are allocated per
        # track as they appear — sorted tick processing keeps the
        # assignment deterministic.
        tracks = {}                      # track -> [lane_end_ts, ...]
        track_base = {}                  # track -> first tid
        tick_pid = pid + 1
        next_tid = 0
        # ts order, NOT recording order: a one-shot tick (h2d_restore)
        # records mid-round, after the horizon record whose ts is the
        # round START — greedy lane packing needs sorted starts
        for ev in sorted(ticks, key=lambda e: e["ts"]):
            track = ev.get("track", "serve")
            if track not in tracks:
                tracks[track] = []
                # reserve a generous tid block per track so a track
                # growing a third lane never collides with the next
                track_base[track] = next_tid
                next_tid += 16
            lanes = tracks[track]
            ts = ev["ts"] * 1e6
            dur = max(ev.get("measured_s") or 0.0, 0.0) * 1e6
            lane = None
            for li, lane_end in enumerate(lanes):
                # same sub-µs tolerance as the validator's abut rule
                if ts >= lane_end - 0.5:
                    lane = li
                    break
            if lane is None:
                lane = len(lanes)
                lanes.append(0.0)
                out.append({"name": "thread_name", "ph": "M",
                            "pid": tick_pid,
                            "tid": track_base[track] + lane,
                            "args": {"name": f"{label} {track} "
                                     f"ticks/{lane}"}})
            lanes[lane] = max(lanes[lane], ts + dur)
            shape = ev.get("shape") or []
            # per-tick args carry the tick fields only: the constant
            # recorder meta rides the process_name metadata event once,
            # not 4096 times
            args = {k: v for k, v in ev.items() if k not in ("kind", "ts")}
            out.append({"name": "tick " + "x".join(str(s) for s in shape),
                        "ph": "X", "ts": ts, "dur": dur,
                        "pid": tick_pid,
                        "tid": track_base[track] + lane,
                        "args": args})
        return out


def export_chrome_trace(path, recorders=(), profiler=None):
    """Write ONE chrome-trace JSON merging every given recorder's
    request spans + tick records on the shared perf_counter time base,
    sorted so each (pid, tid) track is ts-monotonic (the schema
    `validate_chrome_trace` checks). Load in Perfetto /
    chrome://tracing.

    `recorders` may be one FlightRecorder, a sequence of them, or a
    LABELED collection — a {label: recorder} dict or (label, recorder)
    pairs. Labels flow into every process_name/thread_name the recorder
    emits, so an N-replica fleet (`serving.fleet.FleetRouter.
    export_trace` passes {"replica0": rec0, ...}) lands on ONE timeline
    with distinct pids per (replica, tenant): each recorder claims a
    contiguous pid block (requests row, tick track, then one pid per
    tenant), and the next one starts past the largest pid the previous
    one actually emitted. `profiler` (a profiler's host timeline in
    the JAX package) raises NotImplementedError: the port has no
    profiler module yet."""
    if profiler is not None:
        raise NotImplementedError(
            "export_chrome_trace(profiler=...): the profiler module is not "
            "ported to paddle_tpu_torch yet")
    events = []
    if isinstance(recorders, FlightRecorder):
        recorders = (recorders,)
    if hasattr(recorders, "items"):
        recorders = list(recorders.items())
    next_pid = 1
    for item in recorders:
        if isinstance(item, (tuple, list)) and len(item) == 2 and \
                not isinstance(item, FlightRecorder):
            label, rec = item
            evs = rec.chrome_events(pid=next_pid, label=str(label))
        else:
            evs = item.chrome_events(pid=next_pid)
        events.extend(evs)
        # the next recorder starts after the largest pid emitted
        next_pid = 1 + max((int(e.get("pid", next_pid)) for e in evs),
                           default=next_pid)
    meta = [e for e in events if e.get("ph") == "M"]
    rest = sorted((e for e in events if e.get("ph") != "M"),
                  key=lambda e: (e["pid"], e["tid"], e["ts"]))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + rest,
                   "displayTimeUnit": "ms"}, f)
    return path


def validate_chrome_trace(data):
    """Schema check of an exported trace: returns a list of problem
    strings (empty = well-formed). Checks the chrome-trace contract
    the exporters promise: a `traceEvents` list, required keys per
    event (`name`/`ph`/`pid`/`tid`, numeric `ts` on non-metadata
    events, non-negative `dur` on "X" slices), ts-monotonicity per
    (pid, tid) track, and no PARTIALLY overlapping "X" slices on one
    track ("X" slices must nest or abut — Perfetto infers depth from
    containment and renders partial overlap at wrong depths or drops
    it) — the properties that make Perfetto render slices instead of
    silently mangling them. PREEMPTION instants (tenancy:
    `req<id>:preempt` / `req<id>:resume` "i" events) must fall inside
    their request row's overall span — a preempt stamped outside the
    slices it supposedly interrupted is mis-attributed lifecycle
    bookkeeping. `data` may be the parsed dict or a path."""
    if isinstance(data, (str, os.PathLike)):
        with open(data) as f:
            data = json.load(f)
    problems = []
    if not isinstance(data, dict) or "traceEvents" not in data:
        return ["top-level object must carry a 'traceEvents' list"]
    events = data["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' is not a list"]
    # pre-pass: each track's overall "X" span — preemption instants
    # are checked against it below (they can sort before the slice
    # that covers them, so a single pass can't judge containment)
    span_lo, span_hi = {}, {}
    for ev in events:
        if isinstance(ev, dict) and ev.get("ph") == "X" and \
                isinstance(ev.get("ts"), (int, float)) and \
                isinstance(ev.get("dur"), (int, float)):
            track = (ev.get("pid"), ev.get("tid"))
            span_lo[track] = min(span_lo.get(track, ev["ts"]), ev["ts"])
            span_hi[track] = max(span_hi.get(track,
                                             ev["ts"] + ev["dur"]),
                                 ev["ts"] + ev["dur"])
    last_ts = {}
    open_slices = {}                     # track -> stack of (end, name)
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing required key "
                                f"'{key}'")
        ph = ev.get("ph")
        if ph == "M":
            continue                     # metadata: no timing contract
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} ({ev.get('name')}): 'ts' must "
                            "be a non-negative number")
            continue
        track = (ev.get("pid"), ev.get("tid"))
        if ph == "i":
            name = str(ev.get("name", ""))
            if name.endswith(":preempt") or name.endswith(":resume"):
                lo, hi = span_lo.get(track), span_hi.get(track)
                # sub-µs tolerance, like the overlap rule below
                if lo is None or ts < lo - 0.5 or ts > hi + 0.5:
                    problems.append(
                        f"event {i} ({name}): preemption instant at "
                        f"ts={ts} lies outside its request row's span "
                        f"[{lo}, {hi}] on track pid={track[0]} "
                        f"tid={track[1]} — preempt/resume must happen "
                        "inside the request's lifecycle")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} ({ev.get('name')}): 'X' "
                                "event needs a non-negative 'dur'")
            else:
                # same-track "X" slices must nest or abut: a slice
                # starting inside an open one must also END inside it.
                # Sub-µs tolerance: abutting host timestamps can land
                # ulps apart after the seconds→µs conversion, and a
                # <1µs overlap is below the trace's own resolution —
                # the real defect class (pipelined ticks) overlaps by
                # milliseconds
                stack = open_slices.setdefault(track, [])
                while stack and ts >= stack[-1][0] - 0.5:
                    stack.pop()
                if stack and ts + dur > stack[-1][0] + 0.5:
                    problems.append(
                        f"event {i} ({ev.get('name')}): partially "
                        f"overlaps '{stack[-1][1]}' on track "
                        f"pid={track[0]} tid={track[1]} — 'X' slices "
                        "must nest or abut")
                stack.append((ts + dur, ev.get("name")))
        if track in last_ts and ts < last_ts[track]:
            problems.append(f"event {i} ({ev.get('name')}): ts not "
                            f"monotonic on track pid={track[0]} "
                            f"tid={track[1]}")
        last_ts[track] = ts
    return problems
