"""The fleet layers of the port (``serving/{faults,health,gateway}.py``)
against the reference's, on the CPU.

- The pure cases of ``tests/test_faults.py`` (fault specs, plans,
  injectors, the health ladder, the retry backoff) on the port's classes;
  ``FaultPlan.random`` gives the same specs in both packages for seeds
  0-3, and the same plan fires at the same steps and sites in both.
- The reference's gateway scenarios (crash failover, stall quarantine and
  drain, quarantine rejoin, overload shedding and degradation, the
  degraded cap, the chaos plans at seeds 0 and 1), run through both
  gateways on the same bridged weights (qwen2-0.5b smoke), the same
  requests and the same ``FaultPlan`` at tie-eps 1e-2: the same handles,
  the same tokens in every result, the same ``RequestFailed`` records,
  the same fleet counters, totals, fault-event counts and final health
  states, and the port's survivors leak no slot, block or prefix pin.
  Each reference run is made once per module.
- The routing cases of ``tests/test_prefix_cache.py``,
  ``tests/test_serving.py`` and ``tests/test_interleaved.py`` on the
  port's gateway, including capsule replicas launched through the port's
  ``core/deploy.py`` (image ``serving-replica``).
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.serving as R
import repro_torch.serving as P
from repro.checkpoint.ckpt import _flatten_with_paths
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import transformer as RT
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.serving.health import (DEAD, DEGRADED, HEALTHY,
                                        QUARANTINED)

torch.set_num_threads(2)

TIE_EPS = 1e-2
FAULT_KINDS_TRACED = ("replica_health", "replica_failover", "replica_retry",
                      "replica_rejoin", "request_failed", "overload_shed",
                      "overload_cap")


@pytest.fixture(scope="module")
def weights():
    """The reference's smoke qwen2 weights (jitted init, seed 0) and the
    same weights bridged into the port."""
    cfg = ref_smoke_config("qwen2-0.5b")
    params = jax.jit(RT.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return SimpleNamespace(
        ref=(cfg, params),
        port=(port_smoke_config("qwen2-0.5b"), bridge.from_flat(flat)))


def _pkg(which, weights):
    """The package's serving classes and an engine factory with the fault
    tests' engine (3 slots of 48, block 8, chunk 8, prefill batch 2)."""
    ns = R if which == "ref" else P
    cfg, params = getattr(weights, which)
    extra = {} if which == "ref" else {"device": "cpu"}

    def engine(*, slots=3, seq=48, block=8, chunk=8, prefill_batch=2,
               **kw):
        return ns.ServingEngine(cfg, params, max_seq_len=seq, max_slots=slots,
                                kv_block_size=block, prefill_chunk=chunk,
                                prefill_batch=prefill_batch, **extra, **kw)

    return SimpleNamespace(ns=ns, cfg=cfg, engine=engine, which=which)


def _requests(pkg, rng, n, max_new=6):
    return [pkg.ns.Request(rng.integers(0, pkg.cfg.vocab_size,
                                        int(rng.integers(3, 12)),
                                        dtype=np.int32),
                           pkg.ns.SamplingParams(max_new_tokens=max_new,
                                                 greedy=True))
            for _ in range(n)]


def _outcome(pkg, gw, handles):
    """Everything the two gateways must agree on after a scenario."""
    results = []
    for h in handles:
        if h is None:
            results.append("shed")
            continue
        out = gw.result(h)
        if isinstance(out, pkg.ns.RequestFailed):
            results.append(("failed", tuple(int(x) for x in out.handle),
                            int(out.rid), out.reason, int(out.attempts),
                            out.last_error))
        else:
            results.append([int(t) for t in np.asarray(out)])
    st = gw.stats()
    fleet, tot = st["fleet"], st["totals"]
    kinds = [e["kind"] for e in gw.trace_events()]
    return {
        "handles": [None if h is None else (int(h[0]), int(h[1]))
                    for h in handles],
        "results": results,
        "fleet": {k: fleet[k] for k in (
            "failovers", "requests_failed", "requests_retried",
            "retries_pending", "shed_requests", "capped_requests",
            "degraded", "degraded_transitions")},
        "health": {name: (h["state"], h["failures"], h["stalls"],
                          h["rejoins"], h["transitions"])
                   for name, h in fleet["health"].items()},
        "totals": {k: tot[k] for k in (
            "requests_submitted", "requests_completed", "requests_retried",
            "requests_failed", "requests_shed", "total_new_tokens")},
        "routed": [rep.routed for rep in gw.replicas],
        "fault_events": {k: kinds.count(k) for k in FAULT_KINDS_TRACED},
    }


# --- the reference's scenarios, written once for either package -----------

def _crash(pkg):
    """test_faults.py:178-219: replica1 of three crashes at its step 3."""
    ns = pkg.ns
    plan = ns.FaultPlan([ns.FaultSpec(kind="crash", replica="replica1",
                                      at_step=3)])
    gw = ns.ReplicaGateway.from_engines(
        [pkg.engine(greedy_tie_eps=TIE_EPS) for _ in range(3)],
        tracing=True, fault_plan=plan)
    reqs = _requests(pkg, np.random.default_rng(3), 6)
    handles = [gw.submit(r) for r in reqs]
    gw.drain()
    return gw, handles, {}


def _stall(pkg):
    """test_faults.py:252-275: replica0 wedges; quarantine; drain."""
    ns = pkg.ns
    plan = ns.FaultPlan([ns.FaultSpec(kind="stall", replica="replica0",
                                      at_step=1, duration=200)])
    gw = ns.ReplicaGateway.from_engines(
        [pkg.engine(greedy_tie_eps=TIE_EPS) for _ in range(2)],
        tracing=True, fault_plan=plan,
        health=ns.HealthConfig(degraded_after=2, quarantine_after=4,
                               auto_rejoin=False))
    reqs = _requests(pkg, np.random.default_rng(7), 4, max_new=4)
    handles = [gw.submit(r) for r in reqs]
    gw.drain()
    return gw, handles, {}


def _rejoin(pkg):
    """test_faults.py:328-374: a transient stall quarantines replica0,
    which rejoins after the cooldown and serves again."""
    ns = pkg.ns
    rng = np.random.default_rng(9)
    plan = ns.FaultPlan([ns.FaultSpec(kind="stall", replica="replica0",
                                      at_step=1, duration=6)])
    gw = ns.ReplicaGateway.from_engines(
        [pkg.engine(greedy_tie_eps=TIE_EPS) for _ in range(2)],
        tracing=True, fault_plan=plan,
        health=ns.HealthConfig(degraded_after=2, quarantine_after=3,
                               rejoin_cooldown_steps=2))
    reqs = _requests(pkg, rng, 3, max_new=4)
    handles = [gw.submit(r) for r in reqs]
    gw.drain()
    for _ in range(10):
        if gw.health[0].state == HEALTHY:
            break
        gw.step()
    seen = {"after_cooldown": (gw.health[0].state, gw.health[0].rejoins)}
    gw.draining = False
    for rep in gw.replicas:
        rep.scheduler.draining = False
    handles.append(gw.submit(ns.Request(
        rng.integers(0, pkg.cfg.vocab_size, 5, dtype=np.int32),
        ns.SamplingParams(max_new_tokens=3, greedy=True))))
    gw.drain()
    return gw, handles, seen


def _overload(pkg):
    """test_faults.py:380-405: the queue-depth ladder sheds a submit,
    shrinks the prefill budget and restores it when the queue empties."""
    ns = pkg.ns
    gw = ns.ReplicaGateway.from_engines(
        [pkg.engine()], tracing=True,
        degradation=ns.DegradationPolicy(shed_queue_depth=3,
                                         recover_steps=2,
                                         budget_shrink=0.5),
        prefill_token_budget=8)
    reqs = _requests(pkg, np.random.default_rng(13), 6, max_new=2)
    handles = [gw.submit(r) for r in reqs]
    gw.step()
    seen = {"degraded_after_step": gw.degraded,
            "budget_after_step": gw.replicas[0].scheduler.prefill_token_budget}
    try:
        handles.append(gw.submit(reqs[0]))
    except ns.Overloaded:
        handles.append(None)
    gw.drain()
    seen["budget_after_drain"] = gw.replicas[0].scheduler.prefill_token_budget
    seen["overload_active"] = [e["active"] for e in gw.trace_events()
                               if e["kind"] == "overload_shed"]
    return gw, handles, seen


def _cap(pkg):
    """test_faults.py:408-428: a breached tenant's max_new is capped."""
    ns = pkg.ns
    gw = ns.ReplicaGateway.from_engines(
        [pkg.engine()], tracing=True,
        degradation=ns.DegradationPolicy(max_new_cap=3))
    gw.degraded = True
    gw._breached_tenants = lambda: {"bulk"}
    handles = [gw.submit(ns.Request(
        np.array([1, 2, 3], np.int32),
        ns.SamplingParams(max_new_tokens=12, greedy=True), tenant="bulk"))]
    gw.drain()
    caps = [(e["orig_max_new"], e["capped_max_new"])
            for e in gw.trace_events() if e["kind"] == "overload_cap"]
    return gw, handles, {"caps": caps}


def _chaos(pkg, seed):
    """test_faults.py:461-533: a random seeded plan over two replicas,
    submits interleaved with steps."""
    ns = pkg.ns
    rng = np.random.default_rng(100 + seed)
    plan = ns.FaultPlan.random(seed=seed, replicas=["replica0", "replica1"],
                               n_faults=3, max_step=8)
    gw = ns.ReplicaGateway.from_engines(
        [pkg.engine(greedy_tie_eps=TIE_EPS) for _ in range(2)],
        tracing=True, fault_plan=plan,
        health=ns.HealthConfig(degraded_after=2, quarantine_after=3,
                               rejoin_cooldown_steps=4))
    handles = []
    for i, r in enumerate(_requests(pkg, rng, 5, max_new=5)):
        try:
            handles.append(gw.submit(r))
        except ns.Overloaded:
            handles.append(None)
        if i % 2:
            gw.step()
    gw.drain()
    fired = {rep.name: list(rep.scheduler.fault_injector.fired)
             for rep in gw.replicas}
    return gw, handles, {"fired": fired}


SCENARIOS = {
    "crash": _crash, "stall": _stall, "rejoin": _rejoin,
    "overload": _overload, "cap": _cap,
    "chaos0": lambda pkg: _chaos(pkg, 0),
    "chaos1": lambda pkg: _chaos(pkg, 1),
}
_REF_RUNS = {}


def _assert_no_leaks(sched):
    eng = sched.engine
    assert not sched.queue and not sched.active and not sched.prefilling
    assert not eng._inflight
    assert eng.kv.pool.in_use == 0
    assert eng.kv.free_slot_count == eng.max_slots
    if eng.prefix_cache is not None:
        eng.prefix_cache.evict(10 ** 9)
        assert eng.kv.prefix_pool.in_use == 0, "leaked prefix pins"


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_gateway_scenario_matches_the_reference(weights, name):
    """The same scenario through both gateways on the same weights: the
    same handles, tokens, typed failures, counters, health states and
    fault events; the port's routable replicas leak nothing."""
    if name not in _REF_RUNS:
        gw, handles, seen = SCENARIOS[name](_pkg("ref", weights))
        _REF_RUNS[name] = (_outcome(_pkg("ref", weights), gw, handles),
                           seen)
    want, want_seen = _REF_RUNS[name]
    pkg = _pkg("port", weights)
    gw, handles, seen = SCENARIOS[name](pkg)
    got = _outcome(pkg, gw, handles)
    for key in want:
        assert got[key] == want[key], (name, key, got[key], want[key])
    assert seen == want_seen
    for i, rep in enumerate(gw.replicas):
        if gw.health[i].routable:
            _assert_no_leaks(rep.scheduler)
    if name == "crash":
        assert gw.health[1].state == DEAD and got["fleet"]["failovers"] == 1
        assert got["totals"]["requests_completed"] == 6
    elif name == "stall":
        assert gw.health[0].state == QUARANTINED
    elif name == "rejoin":
        assert seen["after_cooldown"] == (HEALTHY, 1)
        assert got["fault_events"]["replica_rejoin"] >= 1
    elif name == "overload":
        assert seen["degraded_after_step"] and seen["budget_after_step"] == 4
        assert handles[-1] is None and seen["budget_after_drain"] == 8
        assert seen["overload_active"] == [True, False]
    elif name == "cap":
        assert got["results"][0] != "shed" and len(got["results"][0]) == 3
        assert seen["caps"] == [(12, 3)]


# ---------------------------------------------------------------------------
# the pure cases of tests/test_faults.py on the port's classes
# ---------------------------------------------------------------------------

def test_fault_spec_validation():
    with pytest.raises(ValueError, match="probability"):
        P.FaultSpec(kind="raise", probability=1.5)
    with pytest.raises(ValueError, match="kind"):
        P.FaultSpec(kind="explode")
    with pytest.raises(ValueError, match="site"):
        P.FaultSpec(kind="stall", site="decode")
    with pytest.raises(ValueError, match="latency_s"):
        P.FaultSpec(kind="slow", latency_s=0.0)
    with pytest.raises(ValueError, match="duration"):
        P.FaultSpec(kind="raise", duration=0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fault_plan_random_matches_the_reference(seed):
    """The same seed draws the same specs in both packages (and a plan is
    deterministic, and another seed differs)."""
    reps = ["replica0", "replica1", "replica2"]
    a = P.FaultPlan.random(seed=seed, replicas=reps)
    b = R.FaultPlan.random(seed=seed, replicas=reps)
    assert [vars(s) for s in a.specs] == [vars(s) for s in b.specs]
    assert a.seed == b.seed == seed
    assert a.specs == P.FaultPlan.random(seed=seed, replicas=reps).specs
    assert a.specs != P.FaultPlan.random(seed=seed + 10,
                                         replicas=reps).specs


def _drive(ns, plan, replica, steps=30):
    """Fire an injector of ``plan`` for ``replica`` through a fixed
    sequence of hooks; the outcome of each (or the exception's type)."""
    inj = plan.injector_for(replica)
    trail = []
    for _ in range(steps):
        for hook in (lambda: inj.on_step(),
                     lambda: inj.on_engine_op("prefill"),
                     lambda: inj.on_engine_op("decode")):
            try:
                trail.append(hook())
            except (ns.InjectedFault, ns.ReplicaCrashed) as e:
                trail.append(type(e).__name__)
    return trail, list(inj.fired)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fault_plans_fire_alike_in_both_packages(seed):
    """One random plan (with probabilistic specs added) per package: every
    replica's injector fires at the same steps and sites, with the same
    outcomes, in both — the per-replica zlib-seeded streams included."""
    reps = ["replica0", "replica1"]
    extra = dict(kind="raise", replica="*", probability=0.3, duration=3,
                 site="decode")
    plans = {}
    for ns in (P, R):
        base = ns.FaultPlan.random(seed=seed, replicas=reps, max_step=12)
        plans[ns] = ns.FaultPlan(tuple(base.specs) + (ns.FaultSpec(**extra),),
                                 seed=seed)
    for rep in reps:
        assert _drive(P, plans[P], rep) == _drive(R, plans[R], rep)


def test_injector_stall_crash_and_replay():
    inj = P.FaultInjector([P.FaultSpec(kind="stall", at_step=1,
                                       duration=2)], replica="r0")
    assert [inj.on_step() for _ in range(4)] == \
        ["ok", "stall", "stall", "ok"]
    assert inj.fired == [(1, "stall", "step"), (2, "stall", "step")]
    inj.reset()
    assert [inj.on_step() for _ in range(4)] == \
        ["ok", "stall", "stall", "ok"]
    inj = P.FaultInjector([P.FaultSpec(kind="crash", at_step=0)],
                          replica="r0")
    with pytest.raises(P.ReplicaCrashed):
        inj.on_step()
    with pytest.raises(P.ReplicaCrashed):
        inj.on_step()
    inj = P.FaultInjector([P.FaultSpec(kind="raise", at_step=0,
                                       site="prefill")], replica="r0")
    assert inj.on_step() == "ok"
    inj2 = P.FaultInjector([P.FaultSpec(kind="raise", at_step=0,
                                        site="prefill")], replica="r0")
    with pytest.raises(P.InjectedFault):
        inj2.on_engine_op("prefill")


def test_plan_filters_by_replica():
    plan = P.FaultPlan([P.FaultSpec(kind="stall", replica="r1", at_step=0),
                        P.FaultSpec(kind="raise", replica="*", at_step=5)])
    assert len(plan.injector_for("r0").specs) == 1
    assert len(plan.injector_for("r1").specs) == 2


def test_health_ladder_and_recovery():
    m = P.HealthMonitor(P.HealthConfig(degraded_after=2, quarantine_after=4))
    assert m.state == HEALTHY and m.routable
    assert m.record_step(False) is None
    tr = m.record_step(False)
    assert tr == {"from": HEALTHY, "to": DEGRADED,
                  "reason": "no_progress", "consecutive_bad": 2}
    assert m.routable
    tr = m.record_step(True)
    assert tr["to"] == HEALTHY and m.consecutive_bad == 0
    for _ in range(3):
        m.record_step(False)
    tr = m.record_step(False)
    assert tr["to"] == QUARANTINED and not m.routable and m.alive
    tr = m.mark_rejoined()
    assert tr["to"] == HEALTHY and m.rejoins == 1
    tr = m.record_failure("ReplicaCrashed()", fatal=True)
    assert tr["to"] == DEAD and not m.alive and m.failures == 1


def test_health_config_validation_and_defaults():
    with pytest.raises(ValueError):
        P.HealthConfig(degraded_after=0)
    with pytest.raises(ValueError):
        P.HealthConfig(degraded_after=4, quarantine_after=4)
    assert vars(P.HealthConfig()) == vars(R.HealthConfig())
    assert P.health.HEALTH_STATES == R.health.HEALTH_STATES


def test_retry_backoff_schedule():
    p = P.RetryPolicy(max_retries=3, backoff_base_steps=2, backoff_factor=3)
    assert [p.backoff_steps(a) for a in (1, 2, 3)] == [2, 6, 18]
    assert vars(P.RetryPolicy()) == vars(R.RetryPolicy())


# ---------------------------------------------------------------------------
# the port's gateway alone: routing, drain, typed errors, capsules
# ---------------------------------------------------------------------------

SYS = np.arange(1, 68, dtype=np.int32) % 50            # 67-token prompt


def test_gateway_routes_shared_prefix_to_owner(weights):
    """test_prefix_cache.py:308-322 on the port."""
    pkg = _pkg("port", weights)
    gw = P.ReplicaGateway.from_engines(
        [pkg.engine(slots=2, seq=128, rng_seed=s, prefix_cache_blocks=64)
         for s in (0, 1)])
    sp = P.SamplingParams(max_new_tokens=2, greedy=True)
    handles = []
    for i in range(4):
        handles.append(gw.submit(P.Request(np.concatenate(
            [SYS, np.array([70 + i], np.int32)]), sp)))
        gw.run()
    owners = {h[0] for h in handles}
    assert len(owners) == 1
    s = gw.replicas[owners.pop()].scheduler.metrics.summary()["prefix_cache"]
    assert s["hits"] == 3
    tot = gw.stats()["totals"]["prefix_cache"]
    assert tot["hits"] == 3 and tot["cached_tokens_served"] > 0


def test_gateway_affinity_yields_to_load(weights):
    """test_prefix_cache.py:325-335 on the port."""
    pkg = _pkg("port", weights)
    gw = P.ReplicaGateway.from_engines(
        [pkg.engine(slots=2, seq=128, rng_seed=s, prefix_cache_blocks=64)
         for s in (0, 1)], affinity_slack=0)
    sp = P.SamplingParams(max_new_tokens=2, greedy=True)
    mk = lambda t: P.Request(np.concatenate([SYS, np.array([t], np.int32)]),
                             sp)
    first = gw.submit(mk(1))[0]
    routed = {gw.submit(mk(2 + i))[0] for i in range(3)}
    assert routed - {first}, "affinity never yielded to load"
    gw.drain()
    for rep in gw.replicas:
        _assert_no_leaks(rep.scheduler)


def test_gateway_least_loaded_and_drain(weights):
    """test_serving.py:289-308 on the port."""
    pkg = _pkg("port", weights)
    gw = P.ReplicaGateway.from_engines(
        [pkg.engine(slots=2, rng_seed=s) for s in (0, 1)])
    handles = [gw.submit(P.Request(np.array([1 + i, 2, 3], np.int32),
                                   P.SamplingParams(max_new_tokens=4,
                                                    greedy=True)))
               for i in range(6)]
    assert {h[0] for h in handles} == {0, 1}
    assert [r.routed for r in gw.replicas] == [3, 3]
    gw.drain()
    for h in handles:
        assert len(gw.result(h)) == 4
    assert not gw.has_work
    with pytest.raises(RuntimeError):
        gw.submit(P.Request(np.array([1], np.int32)))
    tot = gw.stats()["totals"]
    assert tot["requests_completed"] == 6 and tot["total_new_tokens"] == 24


def test_gateway_capsule_replicas(weights, tmp_path):
    """test_serving.py:311-322 on the port: replicas launched through the
    ch-run analogue of the port's deployment carry the image name and the
    uid map."""
    pkg = _pkg("port", weights)
    gw, dep = P.launch_capsule_replicas(2, lambda: pkg.engine(), tmp_path)
    assert all(r.capsule and r.capsule["image"] == "serving-replica"
               and "user namespace" in r.capsule["uid_map"]
               for r in gw.replicas)
    h = gw.submit(P.Request(np.array([1, 2, 3], np.int32),
                            P.SamplingParams(max_new_tokens=2, greedy=True)))
    gw.drain()
    assert len(gw.result(h)) == 2


def test_launch_capsule_replicas_error_paths(weights, tmp_path):
    pkg = _pkg("port", weights)
    with pytest.raises(ValueError, match="at least one replica"):
        P.launch_capsule_replicas(0, lambda: pkg.engine(), tmp_path)
    with pytest.raises(TypeError, match="callable"):
        P.launch_capsule_replicas(1, "not-a-factory", tmp_path)

    def exploding_factory():
        raise RuntimeError("model weights missing")

    with pytest.raises(RuntimeError, match="model weights missing"):
        P.launch_capsule_replicas(1, exploding_factory, tmp_path)


def test_gateway_drain_completes_inflight_prefills(weights):
    """test_interleaved.py:363-381 on the port (paged, budgeted)."""
    pkg = _pkg("port", weights)
    rng = np.random.default_rng(5)
    gw = P.ReplicaGateway.from_engines([pkg.engine(paged=True)],
                                       prefill_token_budget=8)
    prompt = lambda n: rng.integers(0, pkg.cfg.vocab_size, n, dtype=np.int32)
    h1 = gw.submit(P.Request(prompt(4), P.SamplingParams(max_new_tokens=4,
                                                         greedy=True)))
    gw.step()
    h2 = gw.submit(P.Request(prompt(33), P.SamplingParams(max_new_tokens=2,
                                                          greedy=True)))
    gw.step()
    sched = gw.replicas[0].scheduler
    assert sched.prefilling and sched.load >= 2
    gw.drain()
    assert len(gw.result(h1)) == 4 and len(gw.result(h2)) == 2
    _assert_no_leaks(sched)


def test_result_handles_watchdog_and_typed_failures(weights):
    """Unknown, malformed and unfinished handles; the watchdog raises when
    health cannot quarantine; a lone crashed replica fails its request
    typed and refuses new submits."""
    pkg = _pkg("port", weights)
    gw = P.ReplicaGateway.from_engines([pkg.engine()])
    with pytest.raises(KeyError, match="unknown request handle"):
        gw.result((0, 99))
    with pytest.raises(KeyError, match="malformed request handle"):
        gw.result("nope")
    h = gw.submit(P.Request(np.array([1, 2, 3], np.int32),
                            P.SamplingParams(max_new_tokens=2, greedy=True)))
    with pytest.raises(RuntimeError, match="not finished"):
        gw.result(h)
    gw.drain()
    assert len(gw.result(h)) == 2

    plan = P.FaultPlan([P.FaultSpec(kind="stall", replica="replica0",
                                    at_step=0, duration=10 ** 6)])
    gw = P.ReplicaGateway.from_engines(
        [pkg.engine()], fault_plan=plan, stall_patience=6,
        health=P.HealthConfig(degraded_after=10 ** 6,
                              quarantine_after=10 ** 6 + 1))
    gw.submit(P.Request(np.array([1, 2, 3], np.int32),
                        P.SamplingParams(max_new_tokens=2, greedy=True)))
    with pytest.raises(RuntimeError, match="no progress"):
        gw.run()

    plan = P.FaultPlan([P.FaultSpec(kind="crash", replica="replica0",
                                    at_step=2)])
    gw = P.ReplicaGateway.from_engines([pkg.engine()], tracing=True,
                                       fault_plan=plan)
    h = gw.submit(P.Request(np.array([1, 2, 3, 4], np.int32),
                            P.SamplingParams(max_new_tokens=8, greedy=True)))
    gw.drain()
    out = gw.result(h)
    assert isinstance(out, P.RequestFailed)
    assert out.reason in ("no_routable_replica", "retry_budget_exhausted")
    assert gw.stats()["totals"]["requests_failed"] == 1
    gw.draining = False
    with pytest.raises(P.Overloaded):
        gw.submit(P.Request(np.array([1], np.int32)))


def test_prefill_site_fault_leaves_the_programs_valid(weights):
    """A prefill-site fault fires inside the engine's all-or-nothing block
    after a round's inputs may have been fed: the slots come back, the
    next round feeds its own block table, and the request completes with
    the fault-free tokens (paged, one program of each kind, built once)."""
    pkg = _pkg("port", weights)
    rng = np.random.default_rng(41)
    reqs = _requests(pkg, rng, 3, max_new=4)
    clean = P.Scheduler(pkg.engine(paged=True, greedy_tie_eps=TIE_EPS))
    rids = [clean.submit(r) for r in reqs]
    clean.run()
    want = [clean.output(r).tolist() for r in rids]
    plan = P.FaultPlan([P.FaultSpec(kind="raise", replica="replica0",
                                    at_step=1, site="prefill",
                                    duration=2)])
    gw = P.ReplicaGateway.from_engines(
        [pkg.engine(paged=True, greedy_tie_eps=TIE_EPS)], fault_plan=plan)
    handles = [gw.submit(r) for r in reqs]
    gw.drain()
    assert [gw.result(h).tolist() for h in handles] == want
    eng = gw.replicas[0].scheduler.engine
    assert gw.replicas[0].scheduler.fault_injector.fired
    assert all(p.captures == 1 for p in eng.programs.values())
    _assert_no_leaks(gw.replicas[0].scheduler)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_warm_up_builds_the_programs_and_leaves_the_cache(weights,
                                                                  paged):
    """``warm_up`` (what a fabric worker runs before its first heartbeat)
    builds both round programs of the engine's mode once, leaves every
    cache leaf as it was, and the engine then serves the same tokens as
    one that was not warmed, building nothing more."""
    from repro_torch.serving.kvcache import _leaves
    pkg = _pkg("port", weights)
    reqs = _requests(pkg, np.random.default_rng(43), 3, max_new=4)
    outs = []
    for warm in (False, True):
        eng = pkg.engine(paged=paged, greedy_tie_eps=TIE_EPS)
        if warm:
            before = [t.clone() for _, t in _leaves(eng.kv.cache)]
            eng.warm_up()
            assert sorted(eng.programs) == sorted(
                ["decode_step", "prefill_paged" if paged else "prefill_chunk"])
            assert all(p.captures == 1 and p.replays == 0
                       for p in eng.programs.values())
            assert all(torch.equal(t, b) for (_, t), b in
                       zip(_leaves(eng.kv.cache), before))
            eng.warm_up()                        # a no-op once built
        sched = P.Scheduler(eng)
        rids = [sched.submit(r) for r in reqs]
        sched.run()
        outs.append([sched.output(r).tolist() for r in rids])
        assert all(p.captures == 1 for p in eng.programs.values())
    assert outs[0] == outs[1]
