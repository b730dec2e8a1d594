"""Replica worker: one ``Scheduler`` + ``ServingEngine`` behind a mailbox.

The port's copy of ``repro.serving.fabric.worker``: the same messages,
heartbeat and status files, byte for byte.  The engine is the port's, on
the card unless the model spec's engine kwargs ask for the CPU
(``{"engine": {"device": "cpu"}}``, the reference's kwargs path); it
raises without a card and never falls back.  Several workers on one
machine share its one card, each process with its own CUDA context.  The
subprocess driver warms the engine (``ServingEngine.warm_up``: both round
programs captured) before its first heartbeat, so no gateway step after
that first heartbeat waits on a capture.

This is what a fabric backend launches — as a real subprocess
(``python -m repro_torch.serving.fabric.worker``, the ``LocalProcessBackend``
path and the payload of a rendered sbatch script), or as an in-process
object the ``MockBackend`` drives deterministically.  Either way the
code path is identical: consume submit/drain/stop messages from the
inbox, advance the scheduler, publish results to the outbox, and write
a monotonically-sequenced heartbeat carrying the progress counters the
gateway's health ladder feeds on plus the emitted-so-far tokens that
make cross-process salvage-resume bit-identical.

The subprocess path runs the serve loop inside
:meth:`repro_torch.core.container.CapsuleRuntime.run` when an unpacked image
directory is supplied — the paper's shape: every replica is one
unprivileged ``ch-run`` capsule of the same immutable image, launched
by the batch scheduler.

The engine is rebuilt from a declarative *model spec* (smoke-config
name + seed + engine kwargs): parameter init is deterministic (the port's
``init_params`` on ``torch.Generator().manual_seed(seed)``, as the port's
launcher seeds it), so every worker process holds bit-identical weights
and greedy outputs match across process boundaries.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.serving.engine import (Request, SamplingParams,
                                        ServingEngine)
from repro_torch.serving.fabric.mailbox import Mailbox, _atomic_write
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.tracing import Tracer

DEFAULT_MODEL_SPEC: Dict[str, Any] = {
    "config": "qwen2-0.5b", "seed": 0,
    "engine": {"max_seq_len": 48, "max_slots": 3, "kv_block_size": 8,
               "prefill_chunk": 8, "prefill_batch": 2},
}


def build_engine(model_spec: Optional[Dict[str, Any]]) -> ServingEngine:
    """Deterministic engine from a declarative spec — both ends of a
    process boundary build bit-identical weights from it.  The engine's
    device comes from the spec's engine kwargs (``"device"``), by default
    the engine's own: the card."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import resolve_device
    spec = dict(DEFAULT_MODEL_SPEC, **(model_spec or {}))
    engine_kw = dict(spec.get("engine", {}))
    device = resolve_device(engine_kw.pop("device", "cuda"))
    cfg = get_smoke_config(spec["config"])
    params = T.init_params(cfg, torch.Generator().manual_seed(
        int(spec["seed"])), device=device)
    return ServingEngine(cfg, params, device=device, **engine_kw)


class ReplicaWorker:
    """The serve loop, factored so subprocess and mock execution share
    every line: ``iterate()`` is one pump (messages -> step -> results
    -> heartbeat); ``serve_forever()`` is the subprocess driver."""

    def __init__(self, spool, replica: str,
                 engine: Optional[ServingEngine] = None,
                 model_spec: Optional[Dict[str, Any]] = None,
                 tracing: bool = True):
        self.mailbox = Mailbox(spool, replica)
        self.replica = replica
        self.tracer = Tracer(enabled=tracing, name=replica)
        self.sched = Scheduler(engine or build_engine(model_spec),
                               tracer=self.tracer)
        # gateway rid <-> local rid (the worker's scheduler numbers its
        # own; results and heartbeats always speak gateway rids)
        self._local_of: Dict[int, int] = {}
        self._gateway_of: Dict[int, int] = {}
        self.draining = False
        self.stopped = False
        self.finished = False
        self._hb_seq = 0

    # -- message handling ----------------------------------------------------

    def _handle(self, msg: Dict[str, Any]) -> None:
        kind = msg["kind"]
        if kind == "submit":
            req = Request(np.asarray(msg["prompt"], np.int32),
                          SamplingParams(**msg.get("params", {})),
                          tenant=msg.get("tenant", "default"))
            local = self.sched.submit(
                req, resume_emitted=msg.get("resume_emitted") or None,
                retry=bool(msg.get("retry")), admit_while_draining=True)
            grid = int(msg["rid"])
            self._local_of[grid] = local
            self._gateway_of[local] = grid
        elif kind == "drain":
            self.draining = True
            self.sched.draining = True
        elif kind == "stop":
            self.stopped = True
        # unknown kinds are ignored: a newer gateway may speak additions
        # an older worker does not know — forward-compatible no-op

    def _publish_results(self) -> None:
        for local, grid in list(self._gateway_of.items()):
            if local in self.sched.done:
                toks = self.sched.output(local)
                self.mailbox.post_to_gateway(
                    "result", rid=grid,
                    tokens=[int(t) for t in np.asarray(toks)])
                del self._gateway_of[local]
                del self._local_of[grid]

    def _emitted_map(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        states = list(self.sched.queue)
        states += list(self.sched.active.values())
        states += list(self.sched.prefilling.values())
        for st in states:
            grid = self._gateway_of.get(st.rid)
            if grid is not None:
                out[str(grid)] = [int(t) for t in st.emitted]
        return out

    def _heartbeat(self) -> None:
        self._hb_seq += 1
        eng = self.sched.engine
        live = {self._gateway_of[st.rid]
                for st in self.sched.active.values()
                if st.rid in self._gateway_of}
        pre = {self._gateway_of[st.rid]
               for st in self.sched.prefilling.values()
               if st.rid in self._gateway_of}
        queued = {g for g in self._local_of if g not in live | pre}
        self.mailbox.write_heartbeat({
            "seq": self._hb_seq,
            "replica": self.replica,
            "decode_steps": int(eng.decode_steps),
            "prefill_tokens": int(eng.prefill_tokens_executed),
            "completed": int(self.sched.metrics.requests_completed),
            "preemptions": int(self.sched.preemptions),
            "queued": sorted(queued),
            "active": sorted(live),
            "prefilling": sorted(pre),
            "emitted": self._emitted_map(),
            "draining": self.draining,
        })

    # -- lifecycle -----------------------------------------------------------

    def iterate(self) -> bool:
        """One pump.  Returns True when anything observable happened
        (message consumed, scheduler work done, result published)."""
        msgs = self.mailbox.collect_inbox()
        for msg in msgs:
            self._handle(msg)
        stepped = False
        if not self.stopped and self.sched.has_work:
            self.sched.step()
            stepped = True
        before = len(self._gateway_of)
        self._publish_results()
        published = len(self._gateway_of) != before
        self._heartbeat()
        # only an explicit stop ends the worker: an idle draining
        # replica must stay up, because the gateway may still route a
        # salvaged request to it (failover retries admit while draining)
        if self.stopped:
            self._finalize("completed")
        return bool(msgs) or stepped or published

    def _write_status(self, state: str, error: str = "") -> None:
        _atomic_write(self.mailbox.home / "status.json",
                      json.dumps({"state": state, "error": error,
                                  "replica": self.replica},
                                 sort_keys=True))

    def _finalize(self, state: str, error: str = "") -> None:
        if self.finished:
            return
        self.finished = True
        self._write_status(state, error)
        self.mailbox.post_to_gateway("status", state=state, error=error)
        try:
            self.tracer.export_jsonl(self.mailbox.trace_path)
        except OSError:
            pass                       # trace export is best-effort

    def fail(self, error: BaseException) -> None:
        """Crash path: record the typed failure for the backend and the
        gateway, then mark the worker finished."""
        self._finalize("failed", error=repr(error))

    def serve_forever(self, poll_interval_s: float = 0.005) -> int:
        """Subprocess driver: warm the engine (both round programs built,
        on the card captured) before the first heartbeat, then pump until
        drained or stopped.  Returns the process exit code (0 clean, 1
        crashed)."""
        try:
            self.sched.engine.warm_up()
            while not self.finished:
                if not self.iterate():
                    time.sleep(poll_interval_s)
            return 0
        except BaseException as e:     # noqa: BLE001 — crash reporting
            self.fail(e)
            traceback.print_exc()
            return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fabric replica worker (mailbox transport)")
    ap.add_argument("--spool", required=True)
    ap.add_argument("--replica", required=True)
    ap.add_argument("--model-spec", default=None,
                    help="JSON model spec (config/seed/engine kwargs)")
    ap.add_argument("--image-dir", default=None,
                    help="unpacked capsule image; when given the serve "
                         "loop runs inside CapsuleRuntime.run (ch-run)")
    ap.add_argument("--poll-interval-s", type=float, default=0.005)
    args = ap.parse_args(argv)
    model_spec = json.loads(args.model_spec) if args.model_spec else None
    worker = ReplicaWorker(Path(args.spool), args.replica,
                           model_spec=model_spec)

    def loop() -> int:
        return worker.serve_forever(args.poll_interval_s)

    if args.image_dir:
        from repro_torch.core.container import CapsuleRuntime
        res = CapsuleRuntime().run(
            Path(args.image_dir), loop,
            env={"REPRO_FABRIC_REPLICA": args.replica,
                 "REPRO_FABRIC_SPOOL": str(args.spool)})
        return int(res.value)
    return loop()


def spec_to_args(spool, replica: str,
                 model_spec: Optional[Dict[str, Any]] = None,
                 image_dir: Optional[str] = None) -> List[str]:
    """The worker argv (minus the interpreter) for a given spec — shared
    by LocalProcessBackend's Popen and SlurmBackend's script payload."""
    argv = ["-m", "repro_torch.serving.fabric.worker",
            "--spool", str(spool), "--replica", replica]
    if model_spec:
        argv += ["--model-spec", json.dumps(model_spec, sort_keys=True)]
    if image_dir:
        argv += ["--image-dir", str(image_dir)]
    return argv


if __name__ == "__main__":
    sys.exit(main())
