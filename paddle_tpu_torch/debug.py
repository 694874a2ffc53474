"""Serving observability front doors (counterpart of the serving half of
`paddle_tpu/debug.py`: `serving_stats`, `serving_report` and
`fleet_report`). The JAX module's numerics checks and other reports are not
ported."""
from .serving.stats import live_engines

__all__ = ["serving_stats", "serving_report", "fleet_report"]


def serving_stats():
    """Telemetry of every live serving engine (`ContinuousBatchingEngine`
    / `SpeculativeEngine`): queue wait, slot occupancy, tokens/s,
    per-token p50/p99 latency and host syncs per generated token (1.0 on
    the per-tick path, <= 1/K with a K-tick horizon). One summary dict
    per engine, deterministically ordered."""
    return [e.stats.summary() for e in live_engines()]


def serving_report(drift_factor=None, print_report=False):
    """Deep serving observability, one dict per live engine (ordered as
    `serving_stats`): the `ServeStats` summary, the recent scheduling
    decisions summarized (horizons, prefill syncs, stalled ones) and —
    when the engine carries a flight recorder (`trace=`) — the rolling
    roofline-drift ledger per dispatch shape with its drifting shapes
    flagged (`FlightRecorder.drift_report`) and the pad ledger of the
    recorder's tick window. Drift > 1 means ticks run slower than priced
    (the scheduler fuses too few ticks per sync), drift < 1 that the
    model overprices. Multi-tenant engines (`TenantEngine`) add their
    `tenancy_summary` (per-tenant ledgers, per-class p99 beside the
    roofline targets, fairness, preemptions)."""
    report = []
    for eng in live_engines():
        entry = {"stats": eng.stats.summary()}
        if hasattr(eng, "tenancy_summary"):
            entry["tenancy"] = eng.tenancy_summary()
        events = eng.serve_schedule()
        if events:
            entry["schedule"] = {
                "horizons": sum(ev.get("kind") == "horizon"
                                for ev in events),
                "prefill_syncs": sum(ev.get("kind") == "prefill_sync"
                                     for ev in events),
                "stalled_prefill_syncs": sum(
                    ev.get("kind") == "prefill_sync"
                    and ev.get("decode_active", 0) > 0 for ev in events),
            }
        rec = eng.trace
        if rec is not None:
            drift = rec.drift_report(factor=drift_factor)
            entry["drift"] = drift
            entry["drifting_shapes"] = [d["shape"] for d in drift
                                        if d["drifting"]]
            entry["trace_events"] = len(rec.events)
            # pad ledger over the recorder's tick window (the lifetime
            # view is stats.pad_fraction)
            ticks = [ev for ev in rec.events if ev["kind"] == "tick"
                     and ev.get("tokens_dispatched")]
            disp = sum(ev["tokens_dispatched"] for ev in ticks)
            if disp:
                padded = sum(ev.get("tokens_padded") or 0
                             for ev in ticks)
                entry["pad"] = {
                    "tokens_dispatched": disp, "tokens_padded": padded,
                    "pad_fraction": round(padded / disp, 4)}
        report.append(entry)
    if print_report:
        for entry in report:
            s = entry["stats"]
            print(f"== {s['engine']}#{s['engine_id']} ==")
            for key in ("stats", "tenancy", "schedule", "pad"):
                if key in entry:
                    print(f"  {key}: {entry[key]}")
            for d in entry.get("drift", ()):
                flag = "  << DRIFTING" if d["drifting"] else ""
                print(f"  drift {d['shape']}: predicted "
                      f"{d['predicted_s'] * 1e3:.3f} ms measured "
                      f"{d['measured_s'] * 1e3:.3f} ms ratio "
                      f"{d['ratio']:.2f} (n={d['n']}){flag}")
    return report


def fleet_report(router, print_report=False):
    """Fleet-wide serving observability (`serving.FleetRouter`): the
    `ServeStats.merge()` summary over every replica (counters summed,
    latency windows pooled in replica order — the fleet p50/p99 is the
    pooled math, not an average of averages), the merged per-tenant/SLO
    ledgers, per-replica one-line stats and the shared host tier's
    occupancy."""
    merged = router.merged_stats().summary()
    tier = getattr(router.engines[0], "cache", None)
    tier = getattr(tier, "tier", None)
    report = {
        "stats": merged,
        "tenancy": router.tenancy_summary(),
        "replicas": [e.stats.summary() for e in router.engines],
    }
    if tier is not None and getattr(tier, "shared", False):
        report["shared_tier"] = {"entries": tier.n_entries,
                                 "bytes": tier.bytes_used,
                                 "path": str(tier.path)}
    if print_report:
        print(f"== fleet of {len(router.engines)} ==")
        print(f"  merged: {merged}")
        for i, r in enumerate(report["replicas"]):
            print(f"  replica{i}: requests {r.get('requests', 0)}, "
                  f"tokens {r.get('tokens', 0)}, hit_rate "
                  f"{r.get('prefix_hit_rate', 0.0)}")
        if "shared_tier" in report:
            print(f"  shared_tier: {report['shared_tier']}")
    return report
