"""Pluggable scheduler backends: how the fabric launches replica workers.

The port's copy of ``repro.serving.fabric.backends``.  Its subprocess
workers run ``python -m repro_torch.serving.fabric.worker`` with the
port's source directory on ``PYTHONPATH``; on a machine with one card
every worker process opens its own CUDA context on it.  Workers that
start together may build the CUDA kernels together: each ``nvcc`` writes
a per-process temporary file that is renamed into place
(``kernels/_build.py``), so no worker loads a half-written library.

One abstraction, three adapters, mirroring how production
container-on-HPC stacks separate *what* to launch from *who* launches
it:

* :class:`SlurmBackend` — renders a real sbatch script through
  :func:`repro_torch.launch.slurm.render_script` (the paper's submission
  pattern: ``ch-run`` inside an exclusive allocation) into the spool's
  ``jobs/`` directory and tracks the job lifecycle
  PENDING -> RUNNING -> COMPLETED / FAILED off the worker's heartbeat
  and status files — the only signals an air-gapped login node gets.
* :class:`LocalProcessBackend` — real ``subprocess`` workers on this
  host: the integration path (kill one mid-burst and watch failover).
* :class:`MockBackend` — drives :class:`~repro_torch.serving.fabric.worker.
  ReplicaWorker` objects in-process and deterministically, so the whole
  fabric (mailbox included, byte for byte the same code) is testable
  hermetically.

Every submit validates against the :class:`~repro_torch.serving.fabric.
registry.ClusterRegistry` *before* any job state exists
(validate-before-submit), and terminal jobs release their nodes.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.serving.fabric.mailbox import Mailbox
from repro_torch.serving.fabric.registry import ClusterRegistry
from repro_torch.serving.fabric.worker import ReplicaWorker, spec_to_args

PENDING = "PENDING"
RUNNING = "RUNNING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"


@dataclass(frozen=True)
class WorkerSpec:
    """Everything a backend needs to launch one replica worker."""
    replica: str
    spool: Path
    model_spec: Optional[Dict[str, Any]] = None
    image_dir: Optional[str] = None
    partition: str = "general"
    nodes: int = 1
    threads_per_rank: int = 2
    walltime: str = "08:00:00"


@dataclass
class JobHandle:
    """One submitted worker job.  ``state`` is backend-maintained; the
    gateway proxy only ever reads it through :meth:`SchedulerBackend.
    poll`."""
    job_id: str
    spec: WorkerSpec
    state: str = PENDING
    error: str = ""
    _released: bool = field(default=False, repr=False)


class SchedulerBackend(ABC):
    """ABC every adapter implements.  ``synchronous`` marks backends
    whose workers only progress inside :meth:`poll` (the mock) — the
    gateway proxy then skips its wall-clock wait loop."""

    synchronous = False

    def __init__(self, registry: Optional[ClusterRegistry] = None):
        self.registry = registry or ClusterRegistry.single_partition()
        self.jobs: List[JobHandle] = []
        self._next_job = 0

    def submit(self, spec: WorkerSpec) -> JobHandle:
        """Validate capacity, then launch.  CapacityError propagates
        before any job exists; a launch failure releases the nodes."""
        self.registry.commit(spec.partition, spec.nodes)
        self._next_job += 1
        handle = JobHandle(job_id=f"{self._next_job}", spec=spec)
        try:
            self._launch(handle)
        except Exception:
            self.registry.release(spec.partition, spec.nodes)
            raise
        self.jobs.append(handle)
        return handle

    def _release(self, handle: JobHandle) -> None:
        if not handle._released:
            handle._released = True
            self.registry.release(handle.spec.partition,
                                  handle.spec.nodes)

    @abstractmethod
    def _launch(self, handle: JobHandle) -> None:
        """Start the worker for ``handle`` (state stays PENDING until
        poll observes it running)."""

    @abstractmethod
    def poll(self, handle: JobHandle) -> str:
        """Current lifecycle state; releases nodes on terminal states."""

    @abstractmethod
    def cancel(self, handle: JobHandle) -> None:
        """Hard-stop the job (scancel / SIGKILL analogue)."""

    # -- shared status-file plumbing -----------------------------------------

    @staticmethod
    def _read_status(spec: WorkerSpec) -> Optional[Dict[str, Any]]:
        path = Path(spec.spool) / spec.replica / "status.json"
        try:
            return json.loads(path.read_text())
        except (OSError, ValueError):
            return None


class MockBackend(SchedulerBackend):
    """Deterministic in-process adapter: each "job" is a real
    :class:`ReplicaWorker` advanced ``iterations_per_poll`` pumps every
    time the gateway polls it — no wall clock, no processes, the exact
    mailbox/worker code the subprocess path runs.

    ``engine_factory`` (replica name -> engine) lets tests share model
    params across workers; without it each worker builds from its model
    spec.  ``fault_plan`` wires a
    :class:`~repro_torch.serving.faults.FaultInjector` into every worker's
    scheduler + engine, extending the in-process chaos harness across the
    (simulated) process boundary."""

    synchronous = True

    def __init__(self, registry: Optional[ClusterRegistry] = None, *,
                 engine_factory=None, fault_plan=None,
                 iterations_per_poll: int = 1):
        super().__init__(registry)
        self.engine_factory = engine_factory
        self.fault_plan = fault_plan
        self.iterations_per_poll = iterations_per_poll
        self.workers: Dict[str, ReplicaWorker] = {}
        self._stalled: set = set()

    def _launch(self, handle: JobHandle) -> None:
        spec = handle.spec
        engine = (self.engine_factory(spec.replica)
                  if self.engine_factory is not None else None)
        worker = ReplicaWorker(spec.spool, spec.replica, engine=engine,
                               model_spec=spec.model_spec)
        if self.fault_plan is not None:
            inj = self.fault_plan.injector_for(spec.replica)
            worker.sched.fault_injector = inj
            worker.sched.engine.fault_injector = inj
        self.workers[handle.job_id] = worker

    def stall(self, handle: JobHandle) -> None:
        """Wedge the worker: it stays RUNNING but stops iterating, so
        its heartbeat seq freezes — the stale-heartbeat failure mode
        (a hung process, a dead filesystem client) as a chaos lever."""
        self._stalled.add(handle.job_id)

    def resume(self, handle: JobHandle) -> None:
        self._stalled.discard(handle.job_id)

    def poll(self, handle: JobHandle) -> str:
        if handle.state in (COMPLETED, FAILED):
            return handle.state
        if handle.job_id in self._stalled:
            return handle.state
        worker = self.workers[handle.job_id]
        for _ in range(self.iterations_per_poll):
            if worker.finished:
                break
            try:
                worker.iterate()
            except Exception as e:  # noqa: BLE001 — the worker crashed
                worker.fail(e)
                handle.state = FAILED
                handle.error = repr(e)
                self._release(handle)
                return handle.state
        if worker.finished:
            status = self._read_status(handle.spec) or {}
            failed = status.get("state") == "failed"
            handle.state = FAILED if failed else COMPLETED
            handle.error = status.get("error", "")
            self._release(handle)
        else:
            handle.state = RUNNING
        return handle.state

    def cancel(self, handle: JobHandle) -> None:
        worker = self.workers.get(handle.job_id)
        if worker is not None and not worker.finished:
            worker.stopped = True
            worker.finished = True     # hard kill: no status, no trace
        if handle.state not in (COMPLETED, FAILED):
            handle.state = FAILED
            handle.error = handle.error or "cancelled"
        self._release(handle)

    def kill(self, handle: JobHandle) -> None:
        """Crash simulation: the worker dies mid-flight — heartbeats
        simply stop, exactly like a SIGKILLed process."""
        self.cancel(handle)


class LocalProcessBackend(SchedulerBackend):
    """Real subprocess workers: ``python -m repro_torch.serving.fabric.worker``
    per replica, talking through the same spool.  The integration
    backend — kill(-9)able, genuinely concurrent."""

    def __init__(self, registry: Optional[ClusterRegistry] = None):
        super().__init__(registry)
        self.procs: Dict[str, subprocess.Popen] = {}

    def _worker_env(self) -> Dict[str, str]:
        import repro_torch
        # namespace-package safe: __path__ always exists, __file__ may
        # be None
        src = str(Path(list(repro_torch.__path__)[0]).resolve().parent)
        env = dict(os.environ)
        prev = env.get("PYTHONPATH")
        env["PYTHONPATH"] = src + (os.pathsep + prev if prev else "")
        return env

    def _launch(self, handle: JobHandle) -> None:
        spec = handle.spec
        argv = [sys.executable] + spec_to_args(
            spec.spool, spec.replica, spec.model_spec, spec.image_dir)
        self.procs[handle.job_id] = subprocess.Popen(
            argv, env=self._worker_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def poll(self, handle: JobHandle) -> str:
        if handle.state in (COMPLETED, FAILED):
            return handle.state
        proc = self.procs[handle.job_id]
        rc = proc.poll()
        if rc is None:
            mb = Mailbox(handle.spec.spool, handle.spec.replica)
            if handle.state == PENDING and mb.heartbeat_path.exists():
                handle.state = RUNNING
            return handle.state
        if rc == 0:
            status = self._read_status(handle.spec) or {}
            failed = status.get("state") == "failed"
            handle.state = FAILED if failed else COMPLETED
            handle.error = status.get("error", "")
        else:
            handle.state = FAILED
            handle.error = f"worker exited with code {rc}"
        self._release(handle)
        return handle.state

    def cancel(self, handle: JobHandle) -> None:
        proc = self.procs.get(handle.job_id)
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        if handle.state not in (COMPLETED, FAILED):
            handle.state = FAILED
            handle.error = handle.error or "cancelled"
        self._release(handle)

    def kill(self, handle: JobHandle) -> None:
        """SIGKILL the worker — the chaos lever the fabric benchmark
        pulls mid-burst."""
        self.cancel(handle)


class SlurmBackend(SchedulerBackend):
    """Renders and "submits" sbatch scripts.  On a real cluster the
    rendered script is what ``sbatch`` consumes; here submission means
    the script lands in ``spool/jobs/`` with a job id, and the
    lifecycle is tracked off the worker's spool signals: heartbeat
    appears -> RUNNING, status file -> COMPLETED / FAILED.  That is
    also exactly what a login-node poller can observe on an air-gapped
    system where ``squeue`` is the only other window."""

    def __init__(self, registry: Optional[ClusterRegistry] = None):
        super().__init__(registry)
        self.scripts: Dict[str, Path] = {}

    def _launch(self, handle: JobHandle) -> None:
        import shlex

        from repro_torch.launch import slurm
        spec = handle.spec
        argv = spec_to_args(spec.spool, spec.replica, spec.model_spec,
                            spec.image_dir)
        # the model spec is a JSON blob — every arg must survive the
        # shell line the template interpolates it into
        script = slurm.render_script(
            job_name=f"fabric-{spec.replica}",
            image_dir=spec.image_dir or "/tmp/capsules/serving",
            entrypoint="python", nodes=spec.nodes,
            threads_per_rank=spec.threads_per_rank,
            walltime=spec.walltime, partition=spec.partition,
            script=" ".join(shlex.quote(a) for a in argv),
            env={"REPRO_FABRIC_SPOOL": str(spec.spool),
                 "REPRO_FABRIC_REPLICA": spec.replica})
        jobs = Path(spec.spool) / "jobs"
        jobs.mkdir(parents=True, exist_ok=True)
        path = jobs / f"{handle.job_id}-{spec.replica}.sbatch"
        path.write_text(script)
        self.scripts[handle.job_id] = path

    def poll(self, handle: JobHandle) -> str:
        if handle.state in (COMPLETED, FAILED):
            return handle.state
        status = self._read_status(handle.spec)
        if status is not None:
            handle.state = (FAILED if status.get("state") == "failed"
                            else COMPLETED)
            handle.error = status.get("error", "")
            self._release(handle)
            return handle.state
        mb = Mailbox(handle.spec.spool, handle.spec.replica)
        if mb.heartbeat_path.exists():
            handle.state = RUNNING
        return handle.state

    def cancel(self, handle: JobHandle) -> None:
        if handle.state not in (COMPLETED, FAILED):
            handle.state = FAILED        # scancel analogue
            handle.error = handle.error or "cancelled"
        self._release(handle)
