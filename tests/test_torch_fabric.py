"""The port's cross-process fabric (``serving/fabric/``) against the
reference's, on the CPU.

- The mailbox transport cases of ``tests/test_faults.py:673-713`` on the
  port's ``Mailbox``; the port writes a message byte for byte as the
  reference does.
- One spool, two packages: a port worker driven through the reference's
  ``Mailbox`` (and a reference worker through the port's) answers the same
  submits with the same result messages and byte-identical heartbeat
  files, step for step, on the same bridged weights.
- The ``MockBackend`` cases of ``tests/test_faults.py:535-671, 715-782``
  through both packages (``engine_factory`` building each package's
  engines from the same weights): the same handles, tokens, fleet
  counters and final health states.
- ``SlurmBackend``'s rendered script is the reference's byte for byte but
  for the worker module; capacity is validated before submit.
- One real ``LocalProcessBackend`` run: two worker processes on the CPU
  (``{"engine": {"device": "cpu"}}``), one SIGKILLed once its heartbeat
  shows in-flight work; every request completes equal to the in-process
  oracle, and every wait has a timeout.
"""
from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.serving as R
import repro.serving.fabric as RF
import repro_torch.serving as P
import repro_torch.serving.fabric as PF
from repro.checkpoint.ckpt import _flatten_with_paths
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import transformer as RT
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.serving.health import DEAD, HEALTHY, QUARANTINED

torch.set_num_threads(2)

TIE_EPS = 1e-2


@pytest.fixture(scope="module")
def weights():
    cfg = ref_smoke_config("qwen2-0.5b")
    params = jax.jit(RT.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return SimpleNamespace(
        ref=(cfg, params),
        port=(port_smoke_config("qwen2-0.5b"), bridge.from_flat(flat)))


def _pkg(which, weights):
    ns, fab = (R, RF) if which == "ref" else (P, PF)
    cfg, params = getattr(weights, which)
    extra = {} if which == "ref" else {"device": "cpu"}

    def engine(**kw):
        return ns.ServingEngine(cfg, params, max_seq_len=48, max_slots=3,
                                kv_block_size=8, prefill_chunk=8,
                                prefill_batch=2, **extra, **kw)

    return SimpleNamespace(ns=ns, fab=fab, cfg=cfg, engine=engine)


def _requests(pkg, rng, n, max_new):
    return [pkg.ns.Request(rng.integers(0, pkg.cfg.vocab_size,
                                        int(rng.integers(3, 12)),
                                        dtype=np.int32),
                           pkg.ns.SamplingParams(max_new_tokens=max_new,
                                                 greedy=True))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the mailbox
# ---------------------------------------------------------------------------

def test_mailbox_truncated_message_is_typed_and_lossless(tmp_path):
    mb = P.Mailbox(tmp_path / "spool", "r0")
    mb.post_to_worker("drain")
    (mb.inbox / "00000002.99.json").write_text('{"kind": "sub')
    with pytest.raises(P.MailboxError, match="corrupt"):
        mb.collect_inbox()
    with pytest.raises(P.MailboxError):
        mb.collect_inbox()
    (mb.inbox / "00000002.99.json").unlink()
    assert [m["kind"] for m in mb.collect_inbox()] == ["drain"]
    (mb.inbox / "00000003.99.json").write_text('{"rid": 1}')
    with pytest.raises(P.MailboxError, match="no 'kind'"):
        mb.collect_inbox()


def test_mailbox_inflight_tmp_files_are_invisible(tmp_path):
    mb = P.Mailbox(tmp_path / "spool", "r0")
    (mb.inbox / "00000001.99.json.tmp").write_text('{"kind": "sub')
    assert mb.collect_inbox() == []
    mb.post_to_worker("stop")
    assert [m["kind"] for m in mb.collect_inbox()] == ["stop"]


def test_mailbox_corrupt_heartbeat_is_typed(tmp_path):
    mb = P.Mailbox(tmp_path / "spool", "r0")
    assert mb.read_heartbeat() is None
    mb.write_heartbeat({"seq": 1})
    assert mb.read_heartbeat() == {"seq": 1}
    mb.heartbeat_path.write_text('{"seq": ')
    with pytest.raises(P.MailboxError, match="corrupt heartbeat"):
        mb.read_heartbeat()
    mb.heartbeat_path.write_text('[1, 2]')
    with pytest.raises(P.MailboxError, match="not an object"):
        mb.read_heartbeat()


def test_mailbox_writes_the_reference_bytes(tmp_path):
    """The same messages and heartbeat from both packages' mailboxes: the
    same file names and the same bytes."""
    boxes = {name: mod.Mailbox(tmp_path / name, "replica0")
             for name, mod in (("port", P), ("ref", R))}
    for mb in boxes.values():
        mb.post_to_worker("submit", rid=3, prompt=[1, 2], params={"a": 1},
                          tenant="t", resume_emitted=[], retry=False)
        mb.post_to_gateway("result", rid=3, tokens=[5, 6])
        mb.write_heartbeat({"seq": 1, "emitted": {"3": [5]}})
    for sub in ("inbox", "outbox", "."):
        files = {name: sorted(p.name for p in (mb.home / sub).glob("*.json"))
                 for name, mb in boxes.items()}
        assert files["port"] == files["ref"]
        for f in files["port"]:
            assert ((boxes["port"].home / sub / f).read_bytes()
                    == (boxes["ref"].home / sub / f).read_bytes())


def _lockstep(weights, tmp_path, a, b):
    """A worker of package ``a`` on its own spool, fed by package ``b``'s
    mailbox: [(heartbeat bytes, results)] after each pump."""
    pa = _pkg(a, weights)
    spool = tmp_path / f"{a}-worker"
    worker = pa.fab.ReplicaWorker(spool, "replica0",
                                  engine=pa.engine(greedy_tie_eps=TIE_EPS))
    gate = (R if b == "ref" else P).Mailbox(spool, "replica0")
    rng = np.random.default_rng(51)
    for rid in range(4):
        prompt = rng.integers(0, pa.cfg.vocab_size, int(rng.integers(3, 12)))
        gate.post_to_worker(
            "submit", rid=rid, prompt=[int(t) for t in prompt],
            params={"temperature": 1.0, "greedy": True, "max_new_tokens": 5,
                    "eos_token": None},
            tenant="default", resume_emitted=[], retry=False)
    trail = []
    for _ in range(40):
        worker.iterate()
        trail.append((gate.heartbeat_path.read_bytes(),
                      gate.collect_outbox()))
        if not worker.sched.has_work and not worker._gateway_of:
            break
    gate.post_to_worker("stop")
    worker.iterate()
    status = json.loads((spool / "replica0" / "status.json").read_text())
    return trail, status


def test_either_gateway_reads_either_worker(weights, tmp_path):
    """A port worker read through the reference's mailbox and a reference
    worker read through the port's: the same result messages and
    byte-identical heartbeat files at every pump, and a clean exit."""
    port_trail, port_status = _lockstep(weights, tmp_path, "port", "ref")
    ref_trail, ref_status = _lockstep(weights, tmp_path, "ref", "port")
    assert port_trail == ref_trail
    assert sum(len(r) for _, r in port_trail) == 4
    assert port_status == ref_status == {"state": "completed", "error": "",
                                         "replica": "replica0"}


# ---------------------------------------------------------------------------
# MockBackend fleets through both packages
# ---------------------------------------------------------------------------

def _mock_fleet(pkg, tmp_path, n=2, *, backend_kw=None, **gateway_kw):
    backend = pkg.fab.MockBackend(
        engine_factory=lambda name: pkg.engine(greedy_tie_eps=TIE_EPS),
        **(backend_kw or {}))
    gateway_kw.setdefault("tracing", True)
    gw = pkg.fab.launch_fabric_replicas(n, backend, tmp_path / "spool",
                                        **gateway_kw)
    return backend, gw


def _kill_when_inflight(gw, victim, action):
    for _ in range(100):
        gw.step()
        if victim.active or victim.prefilling:
            action(victim.handle)
            return
    pytest.fail("victim never reported in-flight work")


def _outcome(pkg, gw, handles):
    results = []
    for h in handles:
        out = gw.result(h)
        results.append(("failed", out.reason)
                       if isinstance(out, pkg.ns.RequestFailed)
                       else [int(t) for t in np.asarray(out)])
    fleet = gw.stats()["fleet"]
    return {"handles": [(int(a), int(b)) for a, b in handles],
            "results": results,
            "fleet": {k: fleet[k] for k in ("failovers", "requests_failed",
                                            "requests_retried")},
            "health": {k: (v["state"], v["rejoins"])
                       for k, v in fleet["health"].items()}}


def _round_trip(pkg, tmp_path):
    backend, gw = _mock_fleet(pkg, tmp_path)
    free0 = backend.registry.free_nodes("general")
    handles = [gw.submit(r) for r in _requests(
        pkg, np.random.default_rng(21), 5, 4)]
    gw.drain()
    out = _outcome(pkg, gw, handles)
    pkg.fab.shutdown_fabric(gw)
    out["free"] = (free0, backend.registry.free_nodes("general"))
    out["status"] = all((tmp_path / "spool" / rep.name / "status.json")
                        .exists() for rep in gw.replicas)
    return out


def _crash(pkg, tmp_path):
    backend, gw = _mock_fleet(pkg, tmp_path)
    handles = [gw.submit(r) for r in _requests(
        pkg, np.random.default_rng(23), 6, 5)]
    _kill_when_inflight(gw, gw.replicas[0].scheduler, backend.kill)
    gw.drain()
    return _outcome(pkg, gw, handles)


def _stale(pkg, tmp_path):
    backend, gw = _mock_fleet(
        pkg, tmp_path, health=pkg.ns.HealthConfig(
            degraded_after=2, quarantine_after=4, auto_rejoin=False))
    handles = [gw.submit(r) for r in _requests(
        pkg, np.random.default_rng(25), 5, 4)]
    _kill_when_inflight(gw, gw.replicas[0].scheduler, backend.stall)
    gw.drain()
    return _outcome(pkg, gw, handles)


def _respawn(pkg, tmp_path):
    rng = np.random.default_rng(27)
    backend, gw = _mock_fleet(
        pkg, tmp_path, health=pkg.ns.HealthConfig(
            degraded_after=2, quarantine_after=3, rejoin_cooldown_steps=2))
    handles = [gw.submit(r) for r in _requests(pkg, rng, 4, 4)]
    old_job = gw.replicas[0].scheduler.handle.job_id
    _kill_when_inflight(gw, gw.replicas[0].scheduler, backend.stall)
    gw.drain()
    for _ in range(10):
        if gw.health[0].state == HEALTHY:
            break
        gw.step()
    new_job = gw.replicas[0].scheduler.handle.job_id
    gw.draining = False
    for rep in gw.replicas:
        rep.scheduler.draining = False
    handles.append(gw.submit(pkg.ns.Request(
        rng.integers(0, pkg.cfg.vocab_size, 5, dtype=np.int32),
        pkg.ns.SamplingParams(max_new_tokens=3, greedy=True))))
    gw.drain()
    out = _outcome(pkg, gw, handles)
    out["jobs"] = (old_job, new_job)
    return out


def _plan_crash(pkg, tmp_path):
    plan = pkg.ns.FaultPlan([pkg.ns.FaultSpec(kind="crash",
                                              replica="replica0",
                                              at_step=2)])
    backend, gw = _mock_fleet(pkg, tmp_path,
                              backend_kw={"fault_plan": plan})
    handles = [gw.submit(r) for r in _requests(
        pkg, np.random.default_rng(29), 4, 4)]
    gw.drain()
    out = _outcome(pkg, gw, handles)
    out["error"] = "crash" in gw.replicas[0].scheduler.handle.error.lower()
    return out


def _corrupt(pkg, tmp_path):
    backend, gw = _mock_fleet(
        pkg, tmp_path, health=pkg.ns.HealthConfig(
            degraded_after=2, quarantine_after=4, auto_rejoin=False))
    handles = [gw.submit(r) for r in _requests(
        pkg, np.random.default_rng(31), 4, 4)]
    victim = gw.replicas[0].scheduler
    (victim.mailbox.outbox / "00000000.0.json").write_text("garbage")
    gw.drain()
    out = _outcome(pkg, gw, handles)
    out["last_error"] = "MailboxError" in gw.health[0].last_error
    return out


MOCK_CASES = {"round_trip": _round_trip, "crash": _crash, "stale": _stale,
              "respawn": _respawn, "plan_crash": _plan_crash,
              "corrupt": _corrupt}
WANT_HEALTH = {"crash": DEAD, "stale": QUARANTINED, "respawn": HEALTHY,
               "plan_crash": DEAD, "corrupt": QUARANTINED}
_REF_RUNS = {}


@pytest.mark.parametrize("name", list(MOCK_CASES))
def test_mock_fabric_matches_the_reference(weights, tmp_path, name):
    """Each MockBackend case through both packages on the same weights:
    the same handles, tokens, fleet counters and health states."""
    if name not in _REF_RUNS:
        _REF_RUNS[name] = MOCK_CASES[name](_pkg("ref", weights),
                                           tmp_path / "ref")
    want = _REF_RUNS[name]
    got = MOCK_CASES[name](_pkg("port", weights), tmp_path / "port")
    assert got == want
    assert not any(isinstance(r, tuple) for r in got["results"])
    if name in WANT_HEALTH:
        assert got["health"]["replica0"][0] == WANT_HEALTH[name]
    if name == "round_trip":
        assert got["free"] == (6, 8) and got["status"]
    if name == "respawn":
        assert got["jobs"][0] != got["jobs"][1]
        assert got["health"]["replica0"] == (HEALTHY, 1)


def test_duplicate_result_is_idempotent(weights, tmp_path):
    pkg = _pkg("port", weights)
    backend, gw = _mock_fleet(pkg, tmp_path, n=1)
    h = gw.submit(_requests(pkg, np.random.default_rng(33), 1, 4)[0])
    gw.drain()
    out1 = np.asarray(gw.result(h))
    rs = gw.replicas[0].scheduler
    rs.mailbox.post_to_gateway("result", rid=0, tokens=[1, 2, 3])
    rs.step()
    np.testing.assert_array_equal(rs.done[0], out1)
    np.testing.assert_array_equal(gw.result(h), out1)


# ---------------------------------------------------------------------------
# registry + the Slurm backend (no engine)
# ---------------------------------------------------------------------------

def test_capacity_validated_before_submit(tmp_path):
    reg = P.ClusterRegistry()
    reg.add(PF.Partition("tiny", nodes=2))
    backend = P.SlurmBackend(registry=reg)
    spool = tmp_path / "spool"
    for i in range(2):
        backend.submit(P.WorkerSpec(replica=f"replica{i}", spool=spool,
                                    partition="tiny"))
    with pytest.raises(P.CapacityError, match="0 free of 2"):
        backend.submit(P.WorkerSpec(replica="replica2", spool=spool,
                                    partition="tiny"))
    assert len(backend.jobs) == 2
    with pytest.raises(P.CapacityError, match="unknown partition"):
        backend.submit(P.WorkerSpec(replica="replica3", spool=spool,
                                    partition="gpu"))
    assert reg.summary() == [{"partition": "tiny", "nodes": 2,
                              "committed": 2, "free": 0}]


@pytest.mark.parametrize("image_dir", [None, "/tmp/caps/img"])
def test_slurm_script_is_the_reference_s_but_for_the_module(tmp_path,
                                                            image_dir):
    """The port's rendered sbatch script equals the reference's byte for
    byte once the worker module is named alike, and its lifecycle is read
    off the spool in the same way."""
    spec = dict(replica="replica0", spool=tmp_path / "spool",
                model_spec={"seed": 3, "engine": {"device": "cpu"}},
                image_dir=image_dir)
    scripts = {}
    for name, mod in (("port", P), ("ref", R)):
        backend = mod.SlurmBackend()
        h = backend.submit(mod.WorkerSpec(**spec))
        scripts[name] = backend.scripts[h.job_id].read_text()
    assert "-m repro_torch.serving.fabric.worker" in scripts["port"]
    assert scripts["port"].replace("repro_torch.serving", "repro.serving") \
        == scripts["ref"]
    backend = P.SlurmBackend()
    h = backend.submit(P.WorkerSpec(**spec))
    assert backend.poll(h) == PF.PENDING
    mb = P.Mailbox(spec["spool"], "replica0")
    mb.write_heartbeat({"seq": 1})
    assert backend.poll(h) == PF.RUNNING
    (mb.home / "status.json").write_text(
        json.dumps({"state": "completed", "error": ""}))
    assert backend.poll(h) == PF.COMPLETED
    backend.cancel(h)
    assert backend.poll(h) == PF.COMPLETED


def test_worker_argv_and_env_name_the_port(tmp_path):
    argv = PF.worker.spec_to_args(tmp_path, "replica0", {"seed": 1}, "/img")
    assert argv[:2] == ["-m", "repro_torch.serving.fabric.worker"]
    assert argv == ["-m", "repro_torch.serving.fabric.worker"] + \
        RF.worker.spec_to_args(tmp_path, "replica0", {"seed": 1},
                               "/img")[2:]
    env = P.LocalProcessBackend()._worker_env()
    import repro_torch
    src = str(os.path.dirname(os.path.dirname(repro_torch.__file__)))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == os.path.realpath(src)


# ---------------------------------------------------------------------------
# real worker processes
# ---------------------------------------------------------------------------

def test_local_process_fabric_survives_a_kill(tmp_path, monkeypatch):
    """Two worker processes on the CPU through the model spec; one is
    SIGKILLed once its heartbeat shows in-flight work: it is declared
    DEAD, and every request completes equal to the in-process oracle
    built from the same spec.  Every wait is bounded."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    spec = {"engine": dict(PF.DEFAULT_MODEL_SPEC["engine"], device="cpu")}
    pkg = SimpleNamespace(ns=P, cfg=port_smoke_config("qwen2-0.5b"))
    # enough work (4 requests of 24 new tokens a worker, 3 slots) that
    # the victim is still decoding when the gateway first reads it
    reqs = _requests(pkg, np.random.default_rng(61), 8, 24)
    oracle = P.Scheduler(PF.build_engine(spec))
    rids = [oracle.submit(r) for r in reqs]
    oracle.run()
    want = [oracle.output(r).tolist() for r in rids]

    backend = P.LocalProcessBackend()
    gw = P.launch_fabric_replicas(
        2, backend, tmp_path / "spool", model_spec=spec,
        health=P.HealthConfig(degraded_after=20, quarantine_after=40,
                              auto_rejoin=False))
    try:
        from repro_torch.benchmarks.fabric import wait_for_workers
        wait_for_workers(gw, timeout_s=120.0)
        handles = [gw.submit(r) for r in reqs]
        victim = gw.replicas[1].scheduler
        deadline = time.monotonic() + 180
        killed = False
        while time.monotonic() < deadline:
            gw.step()
            if victim.active or victim.prefilling:
                backend.kill(victim.handle)
                killed = True
                break
        assert killed, "the victim never reported in-flight work"
        t0 = time.monotonic()
        gw.drain()
        assert time.monotonic() - t0 < 180
        assert gw.health[1].state == DEAD
        assert gw.stats()["fleet"]["failovers"] == 1
        got = [np.asarray(gw.result(h)).tolist() for h in handles]
        assert got == want
        assert any(r.attempts > 0 for r in gw._requests.values())
    finally:
        P.shutdown_fabric(gw, timeout_s=30)
    assert all(p.poll() is not None for p in backend.procs.values())
