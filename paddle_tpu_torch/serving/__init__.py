"""Serving stack of the port (counterpart of `paddle_tpu/serving`): the
paged GPT decoder, the ragged scheduler, the continuous-batching and
speculative engines, the prefix cache and its host KV tier, the flight
recorder and the engines' telemetry, multi-tenant serving (SLO classes,
preemption by page-spill, multi-LoRA, per-class KV precision) and the
fleet router over a shared host KV tier."""
from .decoder import (MultiDecodeOut, PagedGPTDecoder, RaggedMultiOut,
                      _spec_accept, pool_token_bytes, pow2_at_least)
from .engine import ContinuousBatchingEngine, SpeculativeEngine
from .fleet import FleetRouter, SharedHostKVTier
from .kv_tier import HostKVTier, restore_beats_recompute
from .prefix_cache import PrefixCache
from .scheduler import HorizonPlan, RaggedScheduler
from .stats import ServeStats, serving_stats
from .tenancy import (SLO_LATENCY, SLO_THROUGHPUT, PrecisionRoutedEngine,
                      TenantEngine, TenantScheduler, TenantStats,
                      make_lora_bank, summarize_tenancy)
from .trace import FlightRecorder, export_chrome_trace, validate_chrome_trace

__all__ = ["PagedGPTDecoder", "MultiDecodeOut", "RaggedMultiOut",
           "pool_token_bytes", "pow2_at_least", "ContinuousBatchingEngine",
           "SpeculativeEngine", "_spec_accept", "HorizonPlan",
           "RaggedScheduler", "ServeStats", "serving_stats", "PrefixCache",
           "HostKVTier", "restore_beats_recompute", "SharedHostKVTier",
           "FleetRouter", "FlightRecorder", "export_chrome_trace",
           "validate_chrome_trace", "SLO_LATENCY", "SLO_THROUGHPUT",
           "TenantEngine", "PrecisionRoutedEngine", "TenantScheduler",
           "TenantStats", "make_lora_bank", "summarize_tenancy"]
