"""Serving stack of the port (counterpart of `paddle_tpu/serving`): the
paged GPT decoder, the ragged scheduler, the continuous-batching and
speculative engines, the prefix cache and its host KV tier, the flight
recorder and the engines' telemetry."""
from .decoder import (MultiDecodeOut, PagedGPTDecoder, RaggedMultiOut,
                      _spec_accept, pool_token_bytes, pow2_at_least)
from .engine import ContinuousBatchingEngine, SpeculativeEngine
from .kv_tier import HostKVTier, restore_beats_recompute
from .prefix_cache import PrefixCache
from .scheduler import HorizonPlan, RaggedScheduler
from .stats import ServeStats, serving_stats
from .trace import FlightRecorder, export_chrome_trace, validate_chrome_trace

__all__ = ["PagedGPTDecoder", "MultiDecodeOut", "RaggedMultiOut",
           "pool_token_bytes", "pow2_at_least", "ContinuousBatchingEngine",
           "SpeculativeEngine", "_spec_accept", "HorizonPlan",
           "RaggedScheduler", "ServeStats", "serving_stats", "PrefixCache",
           "HostKVTier", "restore_beats_recompute", "FlightRecorder",
           "export_chrome_trace", "validate_chrome_trace"]
