"""Cross-process capsule replica fabric (the port's copy of
``repro.serving.fabric``; see the reference's serving/README.md).

Pluggable :class:`SchedulerBackend` adapters launch replica workers
(Slurm script rendering, real subprocesses, or a deterministic mock),
a shared-filesystem mailbox carries submit/result/heartbeat messages,
and :class:`RemoteScheduler` makes each worker look like an in-process
replica to :class:`~repro_torch.serving.gateway.ReplicaGateway` — so health,
failover, salvage-resume, and retry carry over unchanged.
"""
from repro_torch.serving.fabric.backends import (COMPLETED, FAILED,
                                                 PENDING, RUNNING, JobHandle,
                                                 LocalProcessBackend,
                                                 MockBackend,
                                                 SchedulerBackend,
                                                 SlurmBackend, WorkerSpec)
from repro_torch.serving.fabric.mailbox import Mailbox, MailboxError
from repro_torch.serving.fabric.registry import (CapacityError,
                                                 ClusterRegistry, Partition)
from repro_torch.serving.fabric.remote import (RemoteScheduler,
                                               collect_fabric_traces,
                                               launch_fabric_replicas,
                                               shutdown_fabric)
from repro_torch.serving.fabric.worker import (DEFAULT_MODEL_SPEC,
                                               ReplicaWorker, build_engine)

__all__ = [
    "COMPLETED", "FAILED", "PENDING", "RUNNING",
    "CapacityError", "ClusterRegistry", "Partition",
    "DEFAULT_MODEL_SPEC", "JobHandle", "LocalProcessBackend",
    "Mailbox", "MailboxError", "MockBackend", "RemoteScheduler",
    "ReplicaWorker", "SchedulerBackend", "SlurmBackend", "WorkerSpec",
    "build_engine", "collect_fabric_traces", "launch_fabric_replicas",
    "shutdown_fabric",
]
