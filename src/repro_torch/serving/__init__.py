"""Continuous-batching serving over dense or paged KV, and the fleet
around it: the prefix-affine gateway with health, faults and failover,
and the cross-process fabric (the port's serving stack; its exports
mirror ``repro.serving``'s, less ``make_serve_step``, the reference's
jitted step, whose counterpart is the engine's captured round programs).
"""
from repro_torch.serving.engine import (PrefillCursor, Request, SamplingParams,
                                        ServingEngine)
from repro_torch.serving.fabric import (CapacityError, ClusterRegistry,
                                        LocalProcessBackend, Mailbox,
                                        MailboxError, MockBackend,
                                        RemoteScheduler, ReplicaWorker,
                                        SchedulerBackend, SlurmBackend,
                                        WorkerSpec, collect_fabric_traces,
                                        launch_fabric_replicas,
                                        shutdown_fabric)
from repro_torch.serving.faults import (FAULT_KINDS, FAULT_SITES,
                                        FaultInjector, FaultPlan, FaultSpec,
                                        InjectedFault, ReplicaCrashed)
from repro_torch.serving.gateway import (CapsuleReplica, DegradationPolicy,
                                         Overloaded, ReplicaGateway,
                                         RequestFailed, RetryPolicy,
                                         launch_capsule_replicas)
from repro_torch.serving.health import (DEAD, DEGRADED, HEALTHY, QUARANTINED,
                                        HealthConfig, HealthMonitor)
from repro_torch.serving.kvcache import KVBlockPool, OutOfBlocks, PagedKVCache
from repro_torch.serving.metrics import (ServingMetrics, atomic_write_json,
                                         merge_summaries)
from repro_torch.serving.prefix_cache import PrefixCache, PrefixCacheStats
from repro_torch.serving.profiling import (RecompilationTracker, StepProfiler,
                                           profile_kernel,
                                           profile_paged_kernels)
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.slo import (SLOConfig, SLOMonitor, SLOPolicy,
                                     SlidingWindow, TenantStats,
                                     merge_tenant_summaries,
                                     merge_window_summaries)
from repro_torch.serving.tracing import (EVENT_KINDS, FAULT_EVENT_KINDS,
                                         Tracer, export_chrome_trace,
                                         export_jsonl, merge_traces,
                                         to_chrome_trace, validate_event)

__all__ = [
    "CapacityError", "CapsuleReplica", "ClusterRegistry", "DEAD",
    "DEGRADED", "DegradationPolicy", "EVENT_KINDS", "FAULT_EVENT_KINDS",
    "FAULT_KINDS", "FAULT_SITES", "FaultInjector", "FaultPlan", "FaultSpec",
    "HEALTHY", "HealthConfig", "HealthMonitor", "InjectedFault",
    "KVBlockPool", "LocalProcessBackend", "Mailbox", "MailboxError",
    "MockBackend", "OutOfBlocks", "Overloaded", "PagedKVCache",
    "PrefillCursor", "PrefixCache", "PrefixCacheStats", "QUARANTINED",
    "RecompilationTracker", "RemoteScheduler", "ReplicaCrashed",
    "ReplicaGateway", "ReplicaWorker", "Request", "RequestFailed",
    "RetryPolicy", "SLOConfig", "SLOMonitor", "SLOPolicy", "SamplingParams",
    "Scheduler", "SchedulerBackend", "ServingEngine", "ServingMetrics",
    "SlidingWindow", "SlurmBackend", "StepProfiler", "TenantStats", "Tracer",
    "WorkerSpec", "atomic_write_json", "collect_fabric_traces",
    "export_chrome_trace", "export_jsonl", "launch_capsule_replicas",
    "launch_fabric_replicas", "merge_summaries", "merge_tenant_summaries",
    "merge_traces", "merge_window_summaries", "profile_kernel",
    "profile_paged_kernels", "shutdown_fabric", "to_chrome_trace",
    "validate_event",
]
