"""Serving stack of the port (counterpart of `paddle_tpu/serving`): the
paged GPT decoder, the ragged scheduler, the continuous-batching engine,
the prefix cache and its host KV tier, and the engine's telemetry."""
from .decoder import (MultiDecodeOut, PagedGPTDecoder, RaggedMultiOut,
                      pool_token_bytes, pow2_at_least)
from .engine import ContinuousBatchingEngine
from .kv_tier import HostKVTier, restore_beats_recompute
from .prefix_cache import PrefixCache
from .scheduler import HorizonPlan, RaggedScheduler
from .stats import ServeStats, serving_stats

__all__ = ["PagedGPTDecoder", "MultiDecodeOut", "RaggedMultiOut",
           "pool_token_bytes", "pow2_at_least", "ContinuousBatchingEngine",
           "HorizonPlan", "RaggedScheduler", "ServeStats", "serving_stats",
           "PrefixCache", "HostKVTier", "restore_beats_recompute"]
