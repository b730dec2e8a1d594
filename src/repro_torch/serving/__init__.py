"""Continuous-batching serving over dense or paged KV (the port's serving
stack)."""
from repro_torch.serving.engine import (PrefillCursor, Request, SamplingParams,
                                        ServingEngine)
from repro_torch.serving.kvcache import KVBlockPool, OutOfBlocks, PagedKVCache
from repro_torch.serving.metrics import ServingMetrics, atomic_write_json
from repro_torch.serving.prefix_cache import PrefixCache, PrefixCacheStats
from repro_torch.serving.profiling import RecompilationTracker, StepProfiler
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.slo import SLOConfig, SLOMonitor, SLOPolicy
from repro_torch.serving.tracing import EVENT_KINDS, Tracer

__all__ = [
    "EVENT_KINDS", "KVBlockPool", "OutOfBlocks", "PagedKVCache",
    "PrefillCursor", "PrefixCache", "PrefixCacheStats",
    "RecompilationTracker", "Request", "SLOConfig", "SLOMonitor",
    "SLOPolicy", "SamplingParams", "Scheduler", "ServingEngine",
    "ServingMetrics", "StepProfiler", "Tracer", "atomic_write_json",
]
