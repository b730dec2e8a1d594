"""Shared-filesystem mailbox transport for the cross-process fabric.

The port's copy of ``repro.serving.fabric.mailbox``, byte for byte in what
it writes and reads: the same spool layout, file names, JSON
(``sort_keys``) and atomic-write idiom, so either package's gateway reads
either package's worker.

The paper's clusters are air-gapped — compute nodes have no external
network and sites routinely firewall node-to-node sockets — but every
allocation sees the same parallel filesystem.  The fabric therefore
speaks *files*: each replica owns a spool directory with an inbox
(gateway -> worker), an outbox (worker -> gateway), and a heartbeat
file.  Every write is atomic (same-directory ``.tmp`` + ``os.replace``,
the same idiom as :func:`repro_torch.serving.metrics.atomic_write_json`), so a
reader can never observe a half-written message: a ``*.tmp`` file is
in-flight and skipped; a ``*.json`` file is complete by construction.
A ``*.json`` file that nonetheless fails to parse means the spool
itself was corrupted (disk fault, manual tampering) and surfaces as a
typed :class:`MailboxError`, never a raw ``JSONDecodeError``.

Message files are named ``{seq:08d}.{nonce}.json`` — lexicographic
order is FIFO per sender, and the nonce (sender pid) keeps two writers
from colliding.  Consuming a message unlinks it, so re-delivery cannot
happen through the transport; duplicate *results* (a slow worker
finishing a request the gateway already salvaged elsewhere) are handled
idempotently one layer up, in the gateway-side proxy.

Spool layout (one fleet)::

    spool/
      <replica>/
        inbox/          submit / drain / stop   (gateway -> worker)
        outbox/         result / status         (worker -> gateway)
        heartbeat.json  monotonic seq + progress counters + emitted map
        trace.jsonl     worker tracer export, written at exit
      jobs/             rendered sbatch scripts (SlurmBackend)
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional


class MailboxError(RuntimeError):
    """Typed transport failure: a completed message file that cannot be
    parsed (spool corruption).  Callers treat it like any other replica
    failure — the health ladder, not a traceback, decides what happens."""


def _atomic_write(path: Path, text: str) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


class Mailbox:
    """One replica's spool endpoints.  Both ends construct one over the
    same ``(root, replica)``; the gateway posts to the inbox and
    collects the outbox, the worker does the reverse."""

    def __init__(self, root, replica: str):
        self.root = Path(root)
        self.replica = replica
        self.home = self.root / replica
        self.inbox = self.home / "inbox"
        self.outbox = self.home / "outbox"
        self.inbox.mkdir(parents=True, exist_ok=True)
        self.outbox.mkdir(parents=True, exist_ok=True)
        self._seq = 0

    # -- messages ------------------------------------------------------------

    def _post(self, box: Path, kind: str, payload: Dict[str, Any]) -> Path:
        self._seq += 1
        name = f"{self._seq:08d}.{os.getpid()}.json"
        path = box / name
        _atomic_write(path, json.dumps({"kind": kind, **payload},
                                       sort_keys=True))
        return path

    def post_to_worker(self, kind: str, **payload) -> Path:
        return self._post(self.inbox, kind, payload)

    def post_to_gateway(self, kind: str, **payload) -> Path:
        return self._post(self.outbox, kind, payload)

    @staticmethod
    def _collect(box: Path) -> List[Dict[str, Any]]:
        paths = sorted(box.glob("*.json"))
        out: List[Dict[str, Any]] = []
        for path in paths:
            try:
                msg = json.loads(path.read_text())
            except (OSError, ValueError) as e:
                raise MailboxError(
                    f"corrupt mailbox message {path}: {e}") from e
            if not isinstance(msg, dict) or "kind" not in msg:
                raise MailboxError(
                    f"malformed mailbox message {path}: no 'kind'")
            out.append(msg)
        # parse-then-consume: nothing is unlinked until every pending
        # message parsed, so a corrupt file surfaces as a typed error
        # without silently eating the valid messages sorted before it
        for path in paths:
            path.unlink()
        return out

    def collect_inbox(self) -> List[Dict[str, Any]]:
        """Worker side: consume pending gateway messages, FIFO."""
        return self._collect(self.inbox)

    def collect_outbox(self) -> List[Dict[str, Any]]:
        """Gateway side: consume pending worker messages, FIFO."""
        return self._collect(self.outbox)

    # -- heartbeat -----------------------------------------------------------

    @property
    def heartbeat_path(self) -> Path:
        return self.home / "heartbeat.json"

    def write_heartbeat(self, payload: Dict[str, Any]) -> None:
        _atomic_write(self.heartbeat_path,
                      json.dumps(payload, sort_keys=True))

    def read_heartbeat(self) -> Optional[Dict[str, Any]]:
        """The worker's latest heartbeat, or None before the first one.
        A heartbeat that fails to parse is spool corruption — typed, like
        a corrupt message (the file is atomically replaced, so a normal
        race cannot produce this)."""
        try:
            text = self.heartbeat_path.read_text()
        except OSError:
            return None
        try:
            hb = json.loads(text)
        except ValueError as e:
            raise MailboxError(
                f"corrupt heartbeat {self.heartbeat_path}: {e}") from e
        if not isinstance(hb, dict):
            raise MailboxError(
                f"corrupt heartbeat {self.heartbeat_path}: not an object")
        return hb

    @property
    def trace_path(self) -> Path:
        return self.home / "trace.jsonl"
