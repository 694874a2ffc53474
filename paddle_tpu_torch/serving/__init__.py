"""Serving stack of the port (counterpart of `paddle_tpu/serving`): the
paged GPT decoder, the ragged scheduler, the continuous-batching engine
and its telemetry."""
from .decoder import (MultiDecodeOut, PagedGPTDecoder, RaggedMultiOut,
                      pool_token_bytes, pow2_at_least)
from .engine import ContinuousBatchingEngine
from .scheduler import HorizonPlan, RaggedScheduler
from .stats import ServeStats, serving_stats

__all__ = ["PagedGPTDecoder", "MultiDecodeOut", "RaggedMultiOut",
           "pool_token_bytes", "pow2_at_least", "ContinuousBatchingEngine",
           "HorizonPlan", "RaggedScheduler", "ServeStats", "serving_stats"]
