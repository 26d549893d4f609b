"""The port's fleet router held against the JAX package's, and driven end to
end on the CPU (the 5-component demo model, 32-lane pools, quantum 5,
``record="full"``, plain versions).

Over the JAX tests' own fake pools (tests/test_rpc.py), each pin of the
router half of that file, for the port's router: load and round-robin
placement, a stale snapshot placing a pool whose status times out, an
unreachable pool skipped, failover rebinding a spooled victim and
replaying an unspooled one, a severed stream counted as a victim,
``_retryable``'s generation re-check, cost-aware placement and its
tie-break, queued-migration replay, the status caches invalidated and
fenced by a migration, rebalance steals and skips, the poisoned handle and
the migration latch. Beside them, the port's router and the JAX router
driven through the same scripts: the placement sequence and every
``explain`` record, the shed's ``RetryAfter`` fields and counters, the
failover's outcome, and the whole ``fleet_status()`` snapshot (the
``router`` block and every key) are equal. ``ProcPool`` spawns
``gibbs_student_t_tpu_torch.serve.pool_main`` and leaves the child's
device to its spec.

End to end:

- a fleet of two in-process port servers (``LocalPool``, one serial and
  one pipelined) with round-robin placement: every tenant bitwise its run
  on one server; the router's HTTP wire (``/status`` valid against the
  port's ``fleet_status`` schema, ``/healthz``, ``/metrics`` from
  ``prometheus_labeled``, ``/trace`` stitched over the router and both
  pools); the repository's unchanged ``tools/fleet_status.py`` and
  ``tools/serve_top.py --url`` (which load the JAX ``obs/aggregate.py``
  by path) read the port router's ``/status`` and render its router block;
- two in-process servers each behind a real ``RpcServer`` pair, on each
  executor: a running spooled tenant migrated when its source has served
  exactly two quanta (the source's driver held at that counted quantum
  until the cancel lands) and a queued tenant migrated by replay, each
  bitwise its uninterrupted run, a caller blocked in ``result()`` riding
  through, both pools' status caches dropped;
- ``on_converged="evict"`` frees lanes for a queued tenant on each
  executor (the JAX pin of that name, confirmed to fail on the JAX
  pipelined executor only because its dispatch runs ahead of the drain);
- one test spawns two worker processes (``spawn_fleet``, ``device="cpu"``):
  the same stream bitwise across the wire and the processes, placements
  spread, the fleet snapshot schema-valid, the stitched trace carrying
  both workers' clocks, each worker retired with exit 0.

The dead-worker failover, killed by ``pool_kill`` and recovered through
its manifest, is slow, as the JAX package's is.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.serve import router as jax_router
from gibbs_student_t_tpu.serve.scheduler import RetryAfter as JaxRetryAfter
from gibbs_student_t_tpu.serve.scheduler import TenantRequest as JaxRequest
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.obs import aggregate as port_agg
from gibbs_student_t_tpu_torch.obs import schema as obs_schema
from gibbs_student_t_tpu_torch.serve import (
    ChainServer,
    MonitorSpec,
    RemoteChainServer,
    RetryAfter,
    RpcServer,
    TenantRequest,
)
from gibbs_student_t_tpu_torch.serve import router as port_router
from gibbs_student_t_tpu_torch.serve.router import (
    FleetRouter,
    LocalPool,
    ProcPool,
    PoolSpec,
    RoutedHandle,
    spawn_fleet,
    teardown_fleet,
)
from test_rpc import _DyingPool, _FakePool, _MigFakePool, _StubHandle

torch.set_num_threads(1)

pytestmark = pytest.mark.fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("chain", "bchain", "zchain", "thetachain", "alphachain",
          "poutchain", "dfchain")
EXECUTORS = [False, True]
IDS = ["serial", "pipelined"]
RUN_TIMEOUT_S = 180.0
SOCK_S = 30.0
Q = 5
POOL_KW = dict(nlanes=32, quantum=Q, record="full")
SCHEMAS = obs_schema.load_schemas()
STREAM = [dict(niter=10, nchains=16, seed=s, name=f"t{s}") for s in range(5)]
PKGS = {"port": (port_router, TenantRequest),
        "jax": (jax_router, JaxRequest)}


def _valid(doc, name, label):
    obs_schema.assert_valid(doc, SCHEMAS[name], label, defs=SCHEMAS)


def _bitwise(got, want, rows=None):
    for f in FIELDS:
        a = getattr(want, f)
        np.testing.assert_array_equal(getattr(got, f),
                                      a if rows is None else a[:rows],
                                      err_msg=f)
    for k in ("acc_white", "acc_hyper"):
        a = want.stats[k]
        np.testing.assert_array_equal(got.stats[k],
                                      a if rows is None else a[:rows],
                                      err_msg=k)


def _drive(srv, on_quantum=None):
    """``srv.run()`` on a thread of its own; fails when it does not end in
    time, and re-raises what it raised."""
    box = []

    def target():
        try:
            srv.run(on_quantum=on_quantum)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(RUN_TIMEOUT_S)
    if th.is_alive():
        srv._stop.set()
        th.join(10.0)
        pytest.fail(f"the server's run did not end in {RUN_TIMEOUT_S} s")
    if box:
        raise box[0]


def _wait_for(cond, what):
    t_end = time.monotonic() + RUN_TIMEOUT_S
    while not cond():
        if time.monotonic() > t_end:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.005)


def _get(url, timeout=SOCK_S):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def demo():
    return make_demo_model_arrays(components=5), GibbsConfig(model="mixture")


def _server(demo, pipeline=False, **kw):
    ma, cfg = demo
    return ChainServer(ma, cfg, device="cpu", pipeline=pipeline,
                       **POOL_KW, **kw)


@pytest.fixture(scope="module")
def refs(demo):
    """The stream's tenants and the migration pair's, each served in
    process on one serial server: results by name."""
    ma = demo[0]
    srv = _server(demo)
    reqs = [TenantRequest(ma=ma, **s) for s in STREAM]
    reqs += [TenantRequest(ma=ma, niter=40, nchains=16, seed=7, name="R"),
             TenantRequest(ma=ma, niter=20, nchains=16, seed=3, name="Q")]
    hs = [srv.submit(r) for r in reqs]
    try:
        _drive(srv)
    finally:
        srv.close()
    return {h.request.name: h.result(timeout=0) for h in hs}


def _router(pkg, pools, **kw):
    kw.setdefault("failover", False)
    return pkg.FleetRouter(pools, **kw)


def _req(name, cls=TenantRequest, **kw):
    return cls(**{"ma": {}, "niter": 5, "nchains": 4, "name": name, **kw})


# --- the router half of the JAX wire tests, over fakes -----------------------

def test_router_places_by_load_and_counts():
    light = _FakePool("light", queue_depth=0, free_groups=3, occupancy=0.2)
    heavy = _FakePool("heavy", queue_depth=5, free_groups=0, occupancy=0.9)
    r = _router(port_router, [heavy, light])
    for _ in range(3):
        r.submit(_req("a"))
    assert len(light.submitted) == 3 and not heavy.submitted
    assert r.placements == {"light": 3}
    snap = r.fleet_status()
    assert snap["router"]["placements"] == {"light": 3}
    assert snap["n_reachable"] == 2
    _valid(snap, "fleet_status", "fleet snapshot over fakes")
    assert r.healthz()["ok"] is True
    r.close()


def test_router_round_robin_spreads_deterministically():
    a, b = _FakePool("a"), _FakePool("b")
    r = _router(port_router, [a, b], placement="round_robin")
    for i in range(4):
        r.submit(_req(f"t{i}"))
    assert len(a.submitted) == 2 and len(b.submitted) == 2
    with pytest.raises(ValueError, match="placement"):
        _router(port_router, [a], placement="fastest")
    with pytest.raises(ValueError, match="at least one pool"):
        _router(port_router, [])
    r.close()


def test_router_uses_stale_snapshot_for_busy_pool():
    """A pool whose status times out is still placed on through its
    cached snapshot (bumped a placement), until the cache expires."""
    busy = _FakePool("busy", queue_depth=0, free_groups=4)
    other = _FakePool("other", queue_depth=1, free_groups=4)
    r = _router(port_router, [busy, other])
    r.submit(_req("warm"))
    assert len(busy.submitted) == 1

    def timeout_now():
        raise TimeoutError("server lock held mid-quantum")

    busy.status = timeout_now
    r.submit(_req("a"))
    r.submit(_req("b"))
    assert len(busy.submitted) + len(other.submitted) == 3
    assert len(other.submitted) >= 1
    ev = r._placement_tail[-2]
    cand = {c["pool"]: c for c in ev["candidates"]}
    assert cand["busy"]["reachable"] and cand["busy"]["cache_age_s"] >= 0
    r.status_stale_s = 0.0
    r.submit(_req("c"))
    assert len(other.submitted) >= 2
    rows = {p["source"]: p["reachable"] for p in r.fleet_status()["pools"]}
    assert rows == {"busy": False, "other": True}
    r.close()


def test_router_skips_unreachable_pool():
    ok, down = _FakePool("ok"), _FakePool("down")

    def boom():
        raise ConnectionError("refused")

    down.status = boom
    r = _router(port_router, [down, ok])
    r.submit(_req("x"))
    assert len(ok.submitted) == 1 and not down.submitted
    rows = {p["source"]: p["reachable"] for p in r.fleet_status()["pools"]}
    assert rows == {"down": False, "ok": True}
    r.close()


def _failover_run(pkg):
    """The JAX failover unit's script on ``pkg``'s router; its outcome."""
    mod, cls = PKGS[pkg]
    dying = _DyingPool("dying")
    healthy = _FakePool("healthy", queue_depth=9)
    r = _router(mod, [dying, healthy], watch_poll_s=0.02, failover=True)
    try:
        spooled = r.submit(_req("spooled", cls, trace_id="s"))
        mem = r.submit(_req("mem", cls, trace_id="m"))
        dying.queue_depth = 99
        bystander = r.submit(_req("by", cls, trace_id="b"))
        by_inner = bystander._inner
        dying.proc.dead = True
        _wait_for(lambda: r.failovers == 1, "the failover")
        _wait_for(lambda: mem._rebound.is_set(), "the replay's rebind")
        return dict(
            failovers=r.failovers, resubmitted=r.resubmitted,
            spooled_tid=spooled._inner.tenant_id,
            spooled_pool=spooled.pool_idx, mem_pool=mem.pool_idx,
            bystander_pool=bystander.pool_idx,
            bystander_untouched=bystander._inner is by_inner,
            replayed_on=[q.name for q in healthy.submitted],
            recovered_got=[q.name for q in dying.recovered_into.submitted],
            pool0_is_recovered=r.pools[0] is dying.recovered_into,
            placements=dict(r.placements),
            reasons=[e["reason"] for e in r._placement_tail],
            router=r.fleet_status()["router"])
    finally:
        r.close()


def test_router_failover_rebinds_and_resubmits():
    """Victims on the dead pool rebind (spooled: the recovered pool's
    advertised id; unspooled: replayed on a healthy pool); the bystander
    and its pool are untouched; the JAX router does exactly the same."""
    port = _failover_run("port")
    assert port["failovers"] == 1 and port["resubmitted"] == 1
    assert port["spooled_tid"] == 77 and port["spooled_pool"] == 0
    assert "mem" in port["replayed_on"] + port["recovered_got"]
    assert port["bystander_pool"] == 1 and port["bystander_untouched"]
    assert "by" not in port["recovered_got"]
    assert port["pool0_is_recovered"]
    assert port["router"]["failovers"] == 1
    assert port["reasons"].count("resubmit") == 1
    assert port == _failover_run("jax")


def test_finished_counts_severed_stream_as_victim():
    req = _req("v")
    done = _StubHandle(1, req)
    done._finish({"ok": True})
    assert FleetRouter._finished(RoutedHandle(None, req, 0, done)) is True
    severed = _StubHandle(2, req)
    severed._error = ConnectionError("stream severed")
    severed._done.set()
    assert FleetRouter._finished(RoutedHandle(None, req, 0, severed)) is False
    failed = _StubHandle(3, req)
    failed._error = RuntimeError("rejected")
    failed._done.set()
    assert FleetRouter._finished(RoutedHandle(None, req, 0, failed)) is True
    assert FleetRouter._finished(RoutedHandle(None, req, 0, "opaque")) is False


def test_retryable_rechecks_generation_after_wait_timeout():
    """A rebind landing between the generation check and ``clear()`` has
    its ``set()`` discarded: after the wait times out the handle re-checks
    the generation and retries on the rebound inner."""

    class _Router:
        failover_timeout = 0.05

    rh = RoutedHandle(_Router(), _req("r"), 0, "old")

    class _RacingEvent:
        def clear(self):
            RoutedHandle._rebind(rh, 1, "new")

        def wait(self, timeout=None):
            return False

        def set(self):
            pass

    rh._rebound = _RacingEvent()
    calls = []

    def fn(inner):
        calls.append(inner)
        if inner == "old":
            raise ConnectionError("severed")
        return "served"

    assert rh._retryable(fn) == "served"
    assert calls == ["old", "new"]
    # no rebind at all: the wait times out and the severed wire raises
    rh2 = RoutedHandle(_Router(), _req("r2"), 0, "old")
    with pytest.raises(ConnectionError, match="no failover within"):
        rh2._retryable(fn)


def _tenant_entry(niter, sweeps_done, nchains, est=None, eff=None):
    t = {"niter": niter, "sweeps_done": sweeps_done, "nchains": nchains,
         "cost": {"ess_per_core_s": eff}}
    if est is not None:
        t["est_sweeps_to_target"] = est
    return t


def test_cost_aware_placement_prefers_draining_pool():
    near, far = _FakePool("near"), _FakePool("far")
    near.status = lambda: dict(_FakePool.status(near), tenants=[
        _tenant_entry(200, 100, 16, est=10)])
    far.status = lambda: dict(_FakePool.status(far), tenants=[
        _tenant_entry(200, 100, 16, est=90)])
    r = _router(port_router, [far, near])
    r.submit(_req("c"))
    assert near.submitted and not far.submitted
    st = dict(_FakePool.status(near),
              tenants=[_tenant_entry(200, 190, 16, est=500)])
    assert FleetRouter._est_backlog(st) == 10 * 16
    st2 = dict(_FakePool.status(near), tenants=[_tenant_entry(200, 150, 8)])
    assert FleetRouter._est_backlog(st2) == 50 * 8
    assert FleetRouter._est_backlog(_FakePool.status(far)) == 0.0
    for s in (st, st2, _FakePool.status(far)):
        assert (FleetRouter._load_score(s)
                == jax_router.FleetRouter._load_score(s))
    r.close()


def test_cost_aware_placement_efficiency_and_tiebreak():
    slow, fast = _FakePool("slow"), _FakePool("fast")
    slow.status = lambda: dict(_FakePool.status(slow), tenants=[
        _tenant_entry(100, 50, 16, est=20, eff=100.0)])
    fast.status = lambda: dict(_FakePool.status(fast), tenants=[
        _tenant_entry(100, 50, 16, est=20, eff=900.0)])
    r = _router(port_router, [slow, fast])
    r.submit(_req("e"))
    assert fast.submitted and not slow.submitted
    a, b = _FakePool("a"), _FakePool("b")
    r2 = _router(port_router, [a, b])
    r2.submit(_req("t"))
    assert a.submitted and not b.submitted
    assert (FleetRouter._load_score(a.status())
            == FleetRouter._load_score(b.status()))
    assert FleetRouter._pool_efficiency(fast.status()) == 900.0
    r.close()
    r2.close()


def test_migrate_queued_replay_over_fakes():
    src = _MigFakePool("src", queue_depth=3, free_groups=0)
    dst = _MigFakePool("dst", queue_depth=0, free_groups=2)
    r = _router(port_router, [src, dst])
    rh = r.submit(_req("j"), pool=0)
    assert r.migrate(rh, 1) is True
    assert len(dst.submitted) == 1 and dst.submitted[0] is rh.request
    assert rh.pool_idx == 1 and r.migrations == 1
    assert not rh._migrating.is_set()
    assert r.migrate(rh, 1) is False
    assert [e["won"] for e in r._placement_tail] == ["pinned", "migrate"]
    with pytest.raises(RuntimeError, match="pinned pool"):
        r._dead.add(0)
        r.submit(_req("k"), pool=0)
    r.close()


def test_migrate_invalidates_both_status_caches():
    src = _MigFakePool("src", queue_depth=2, free_groups=0)
    dst = _MigFakePool("dst", queue_depth=0, free_groups=2)
    spare = _MigFakePool("spare", queue_depth=9, free_groups=0)
    r = _router(port_router, [src, dst, spare])
    with r._lock:
        r._statuses()
    assert set(r._status_cache) == {0, 1, 2}
    rh = r.submit(_req("j"), pool=0)
    gen0 = r._status_gen.get(0, 0)
    assert r.migrate(rh, 1)
    assert 0 not in r._status_cache and 1 not in r._status_cache
    assert 2 in r._status_cache
    assert r._status_gen[0] == gen0 + 1
    # a poll of the source that started before an invalidation cannot
    # write its snapshot back after it
    stale = {"stale": True}
    src.status = lambda: (r._invalidate_status(0), stale)[1]
    with r._lock:
        r._statuses()
    assert 0 not in r._status_cache and 1 in r._status_cache
    r.close()


def test_rebalance_policy_steals_queued_from_loaded_pool():
    src = _MigFakePool("src", queue_depth=4, free_groups=0, occupancy=1.0)
    dst = _MigFakePool("dst", queue_depth=0, free_groups=2, occupancy=0.5)
    r = _router(port_router, [src, dst])
    rh = r.submit(_req("q"), pool=0)
    assert r._rebalance_once() is True
    assert rh.pool_idx == 1 and len(dst.submitted) == 1
    assert r.steals == 1 and r.fleet_status()["router"]["steals"] == 1
    src.queue_depth = 0
    assert r._rebalance_once() is False
    r.close()


def test_rebalance_policy_skips_streamed_and_oversized():
    src = _MigFakePool("src", queue_depth=4, free_groups=0)
    dst = _MigFakePool("dst", queue_depth=0, free_groups=2)
    r = _router(port_router, [src, dst])
    r.submit(_req("s", on_chunk=lambda *a: None), pool=0)
    r.submit(_req("big", nchains=64), pool=0)
    assert r._rebalance_once() is False
    assert not dst.submitted
    r.close()


def test_migration_failure_poisons_the_handle():
    src, dst = _MigFakePool("src"), _MigFakePool("dst")
    r = _router(port_router, [src, dst])
    rh = r.submit(_req("j"), pool=0)

    def refuse(request, timeout=None):
        raise RuntimeError("pool full")

    src.submit = dst.submit = refuse
    with pytest.warns(RuntimeWarning, match="migration resume attempt"):
        with pytest.raises(RuntimeError, match="could not be resumed"):
            r.migrate(rh, 1)
    assert r.migration_failures == 1 and r.migrations == 0
    with pytest.raises(RuntimeError, match="served prefix"):
        rh.result(timeout=0.5)
    r.close()


def test_routed_handle_rides_through_migration_latch():
    src, dst = _MigFakePool("src"), _MigFakePool("dst")
    r = _router(port_router, [src, dst])
    rh = r.submit(_req("j"), pool=0)
    old = rh._inner
    out = {}
    waiter = threading.Thread(
        target=lambda: out.update(res=rh.result(timeout=30)), daemon=True)
    rh._migrating.set()
    waiter.start()
    old._finish("PREFIX")
    time.sleep(0.3)
    assert "res" not in out and rh.done() is False
    new = _StubHandle(99, rh.request)
    rh._rebind(1, new)
    rh._migrating.clear()
    new._finish("REAL")
    waiter.join(timeout=10)
    assert out.get("res") == "REAL"
    r.close()


# --- the port's router against the JAX router on the same scripts ------------

class _ScriptPool(_FakePool):
    """A fake whose status a script rewrites between submits: load,
    tenants with convergence and cost evidence, a pool failure, an
    admission p99, or no answer at all."""

    def __init__(self, label):
        super().__init__(label)
        self.tenants, self.failures, self.p99, self.down = [], 0, None, False

    def status(self):
        if self.down:
            raise ConnectionError("refused")
        st = _FakePool.status(self)
        st["tenants"] = [dict(t) for t in self.tenants]
        st["faults"] = {"pool_failures": self.failures}
        st["slo"] = {"admission_ms": ({"p99": self.p99}
                                      if self.p99 is not None else None)}
        return st


def _script(pkg, seed, **router_kw):
    """Submit 24 requests through ``pkg``'s router while a script drawn
    from ``seed`` rewrites four pools' statuses; every submit's outcome
    and record."""
    mod, cls = PKGS[pkg]
    rng = np.random.default_rng(seed)
    pools = [_ScriptPool(f"p{k}") for k in range(4)]
    r = _router(mod, pools, **router_kw)
    out = []
    for i in range(24):
        for p in pools:
            p.queue_depth = int(rng.integers(0, 5))
            p.free_groups = int(rng.integers(0, 4))
            p.occupancy = float(np.round(rng.random(), 3))
            p.tenants = [_tenant_entry(
                int(rng.integers(50, 200)), int(rng.integers(0, 50)),
                int(rng.choice([4, 16, 32])),
                est=(float(rng.integers(1, 90)) if rng.random() < 0.5
                     else None),
                eff=(float(rng.integers(1, 900)) if rng.random() < 0.5
                     else None))
                for _ in range(int(rng.integers(0, 3)))]
            p.failures = int(rng.random() < 0.1)
            p.p99 = (float(np.round(rng.random() * 3e3, 3))
                     if rng.random() < 0.6 else None)
            p.down = bool(rng.random() < 0.1)
        pr = int(rng.integers(0, 3))
        dl = int(rng.choice([10, 20])) if rng.random() < 0.2 else None
        req = cls(ma={}, niter=5, nchains=int(rng.choice([4, 16, 48])),
                  name=f"j{i}", trace_id=f"tr{i}", priority=pr,
                  deadline_sweeps=dl)
        try:
            h = r.submit(req)
            ev = dict(r._placement_tail[-1])
            ev.pop("t")
            ev["candidates"] = [dict(c, cache_age_s=c["cache_age_s"] is not
                                     None) for c in ev["candidates"]]
            out.append(("placed", h.pool_idx, ev))
        except (RetryAfter, JaxRetryAfter) as e:
            out.append(("shed", str(e), e.retry_after_s, e.queue_depth,
                        e.tier, e.where))
    block = r.fleet_status()["router"]
    hz = r.healthz()
    hz.pop("t")
    r.close()
    return out, block, hz


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("placement", ["load", "round_robin"])
def test_placement_sequence_and_explain_match_jax(seed, placement):
    port = _script("port", seed, placement=placement)
    assert port == _script("jax", seed, placement=placement)
    kinds = {o[0] for o in port[0]}
    assert kinds == {"placed"}
    if placement == "load":
        assert {o[2]["won"] for o in port[0]} >= {"score", "urgent_fit"}


@pytest.mark.parametrize("seed", range(3))
def test_shed_matches_jax(seed):
    """With ``max_queue_depth`` armed the fleet sheds with the JAX
    router's ``RetryAfter`` (message, retry-after, depth, tier,
    ``where="router"``), priority 0 at twice the depth, and counts the
    sheds by tier in its ``router`` block."""
    port = _script("port", seed, max_queue_depth=2)
    assert port == _script("jax", seed, max_queue_depth=2)
    sheds = [o for o in port[0] if o[0] == "shed"]
    assert sheds and all(o[5] == "router" for o in sheds)
    assert all(o[4] != 0 or o[3] >= 4 for o in sheds)
    block = port[1]
    assert block["sheds"] == len(sheds) and block["max_queue_depth"] == 2
    assert sum(block["sheds_by_tier"].values()) == len(sheds)


def test_fleet_snapshot_matches_jax(monkeypatch):
    """The whole ``fleet_status()`` snapshot, and so its key tree, is the
    JAX router's on the same fakes after the same submits, migration and
    shed; it validates against the port's schema copy."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)
    snaps = {}
    for pkg, (mod, cls) in PKGS.items():
        pools = [_MigFakePool("a", queue_depth=1),
                 _MigFakePool("b", free_groups=0)]
        pools[0].status = (lambda p=pools[0]: dict(
            _FakePool.status(p), watchdog={
                "state": "tripped", "trip": {"cause": "throughput_collapse"},
                "heartbeat_age_s": {"dispatch": 0.5}}))
        r = _router(mod, pools, max_queue_depth=3, rebalance=False)
        hs = [r.submit(cls(ma={}, niter=5, nchains=4, name=f"s{i}",
                           trace_id=f"x{i}")) for i in range(3)]
        assert r.migrate(hs[0], 1 - hs[0].pool_idx) is True
        pools[0].queue_depth = pools[1].queue_depth = 7
        with pytest.raises((RetryAfter, JaxRetryAfter)):
            r.submit(cls(ma={}, niter=5, nchains=4, name="shed"))
        snaps[pkg] = r.fleet_status()
        r.close()
    assert json.dumps(snaps["port"], sort_keys=True) == json.dumps(
        snaps["jax"], sort_keys=True)
    _valid(snaps["port"], "fleet_status", "fleet snapshot")
    assert snaps["port"]["router"]["migrations"] == 1
    rows = {p["source"]: p for p in snaps["port"]["pools"]}
    assert rows["a"]["watchdog_cause"] == "throughput_collapse"


def test_proc_pool_launch_spawns_the_port_worker(tmp_path, monkeypatch):
    """``ProcPool._launch`` runs ``python -m
    gibbs_student_t_tpu_torch.serve.pool_main`` with the repository on the
    child's path and sets no JAX variable: the worker's device comes from
    its spec. A child that dies before its handshake raises."""
    seen = {}

    class _Dead:
        returncode = 3

        def __init__(self, cmd, env=None, stdout=None, stderr=None):
            seen.update(cmd=cmd, env=env)

        def poll(self):
            return 3

    monkeypatch.setattr(port_router.subprocess, "Popen", _Dead)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    spec = PoolSpec(str(tmp_path / "pool"), {"m": 1}, {"c": 2},
                    dict(device="cpu"))
    os.makedirs(spec.pool_dir)
    with open(os.path.join(spec.pool_dir, "ready.json"), "w") as fh:
        fh.write("{}")          # a stale handshake is removed first
    with pytest.raises(RuntimeError, match="died before ready"):
        ProcPool.spawn(spec, faults=[{"point": "pool_kill", "after": 1,
                                      "action": "kill"}])
    cmd, env = seen["cmd"], seen["env"]
    assert cmd[1:3] == ["-m", "gibbs_student_t_tpu_torch.serve.pool_main"]
    assert cmd[3:5] == ["--dir", spec.pool_dir] and cmd[5] == "--faults"
    assert "JAX_PLATFORMS" not in env
    assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert not os.path.exists(os.path.join(spec.pool_dir, "ready.json"))
    with open(os.path.join(spec.pool_dir, "spec.pkl"), "rb") as fh:
        import pickle

        assert pickle.load(fh)["kwargs"] == {"device": "cpu"}


# --- end to end: two in-process port servers behind the router ---------------

_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r',?)*\})? (NaN|[+-]Inf|-?[0-9.eE+-]+)( -?[0-9]+)?$')


def _tool(*args):
    """One of the repository's tools, as a process (no PYTHONPATH: the
    tools load the JAX ``obs/aggregate.py`` by path)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.fixture(scope="module")
def local_fleet(demo, refs, tmp_path_factory):
    """The stream through a round-robin fleet of a serial and a pipelined
    in-process server, with the router's HTTP wire mounted; what the wire
    and the tools read."""
    ma = demo[0]
    root = tmp_path_factory.mktemp("fleet")
    pools = [LocalPool(_server(demo, pipeline, watchdog=False),
                       label=f"pool{i}")
             for i, pipeline in enumerate(EXECUTORS)]
    router = FleetRouter(pools, placement="round_robin", failover=False,
                         http_port=0, obs_dir=str(root / "obs"),
                         capacity_sample_s=0.05)
    out = {}
    try:
        hs = [router.submit(TenantRequest(ma=ma, **s)) for s in STREAM]
        out["results"] = {h.request.name: h.result(timeout=RUN_TIMEOUT_S)
                          for h in hs}
        out["handles"] = hs
        url = router.http.url
        out["reads"] = {r: _get(url + r) for r in (
            "/status", "/healthz", "/metrics", "/trace", "/postmortem")}
        out["snap"] = router.fleet_status()
        out["tools"] = {
            "fleet_status": _tool("tools/fleet_status.py", url, "--json"),
            "serve_top": _tool("tools/serve_top.py", "--url", url),
            "fleet_table": _tool("tools/fleet_status.py", url,
                                 str(root / "missing"))}
        out["capacity"] = router.capacity_timeline()
    finally:
        router.close()
    out["closed"] = all(not p.alive for p in pools)
    return out


def test_local_fleet_round_robin_bitwise(local_fleet, refs):
    """Round-robin placement over a serial and a pipelined server: every
    tenant bitwise its run on one server, the spread 3 / 2."""
    for name, res in local_fleet["results"].items():
        _bitwise(res, refs[name])
    assert [h.pool_idx for h in local_fleet["handles"]] == [0, 1, 0, 1, 0]
    assert local_fleet["snap"]["router"]["placements"] == {"pool0": 3,
                                                           "pool1": 2}
    assert local_fleet["closed"]


def test_local_fleet_http_wire(local_fleet):
    reads = local_fleet["reads"]
    code, body = reads["/status"]
    snap = json.loads(body)
    assert code == 200 and snap["n_reachable"] == 2
    _valid(snap, "fleet_status", "/status")
    assert snap["router"]["placements"] == {"pool0": 3, "pool1": 2}
    assert snap["router"]["placement_events"] == 5
    for p in snap["pools"]:
        assert p["reachable"] and p["healthy"]
    code, body = reads["/healthz"]
    hz = json.loads(body)
    assert code == 200 and hz["ok"] is True and hz["n_ok"] == 2
    code, text = reads["/metrics"]
    lines = [ln for ln in text.splitlines() if ln]
    assert code == 200 and all(
        ln.startswith(("# HELP ", "# TYPE ")) or _PROM_LINE.match(ln)
        for ln in lines)
    assert re.search(r'^gst_fleet_placements\{pool="pool0"\} 3\.0 \d+$',
                     text, re.M)
    assert text.count("# TYPE gst_fleet_pool_occupancy_now gauge") == 1
    code, body = reads["/trace"]
    doc = json.loads(body)
    assert code == 200
    _valid(doc, "fleet_trace", "/trace")
    assert set(doc["otherData"]["clocks"]) == {"pool0", "pool1"}
    cov = port_agg.trace_coverage(doc)
    for h in local_fleet["handles"]:
        c = cov[h.request.trace_id]
        assert c["router"] >= 3 and c["pool"] >= 1, c
    code, body = reads["/postmortem"]
    assert code == 200
    _valid(json.loads(body), "fleet_postmortem", "/postmortem")
    for s in local_fleet["capacity"]:
        _valid(s, "capacity_sample", "capacity sample")


def test_repo_tools_read_the_port_router(local_fleet):
    """The unchanged ``tools/fleet_status.py`` and ``tools/serve_top.py
    --url``, which load the JAX ``obs/aggregate.py`` by path, read the
    port router's ``/status``: serve_top renders the router block and
    both pools; fleet_status takes the router's wire as one reachable
    source and reports an unreachable one as DOWN."""
    tools = local_fleet["tools"]
    top = tools["serve_top"]
    assert top.returncode == 0, top.stderr
    assert "router placements: pool0=3 pool1=2" in top.stdout
    assert "failovers=0 resubmitted=0 dead_pools=0 sheds=0" in top.stdout
    assert "pools=2/2 reachable" in top.stdout
    assert all(ln.split()[1] == "ok" for ln in top.stdout.splitlines()
               if ln.startswith("pool"))
    fs = tools["fleet_status"]
    assert fs.returncode == 0, fs.stderr
    snap = json.loads(fs.stdout)
    assert snap["n_reachable"] == 1 and snap["pools"][0]["reachable"]
    table = tools["fleet_table"]
    assert table.returncode == 0, table.stderr
    assert "pools=1/2 reachable" in table.stdout and "DOWN" in table.stdout


# --- live migration over the wire, at a counted quantum ----------------------

class _WirePool:
    """An in-process server behind a real ``RpcServer`` and
    ``RemoteChainServer``, driven on a thread of its own whose
    ``on_quantum`` parks the driver once ``hold_at`` quanta are counted
    until :attr:`go` is set: a migration triggered there freezes the
    tenant at that boundary, whatever the host's speed."""

    alive = True

    def __init__(self, server, label):
        self.server, self.label = server, label
        self.proc = self.status_url = None
        self.rpc = RpcServer(server)
        self.remote = RemoteChainServer(self.rpc.address, timeout=SOCK_S)
        self.hold_at = None
        self.parked, self.go = threading.Event(), threading.Event()
        th = threading.Thread(target=server.run, name=f"drive-{label}",
                              kwargs=dict(idle_exit=False,
                                          on_quantum=self._gate),
                              daemon=True)
        server._thread = th          # close() joins it
        th.start()

    def _gate(self, s):
        if self.hold_at is not None and s.quanta >= self.hold_at:
            self.hold_at = None
            self.parked.set()
            self.go.wait(RUN_TIMEOUT_S)

    def submit(self, request, timeout=None):
        return self.remote.submit(request, timeout=timeout)

    def cancel(self, handle):
        return self.remote.cancel(handle)

    def status(self):
        return self.server.status()

    def healthz(self):
        return self.server.healthz()

    def reset_counters(self):
        self.server.reset_counters()

    def close(self, grace=30.0):
        self.go.set()
        self.remote.close()
        self.rpc.close()
        self.server.close(timeout=RUN_TIMEOUT_S)


@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_live_migration_bitwise_over_the_wire(demo, refs, tmp_path,
                                              pipeline):
    """A running spooled tenant moved once its source has served two
    quanta, and a queued tenant moved by replay, each bitwise its
    uninterrupted run; the caller blocked in ``result()`` rides through
    the rebind; both pools' status caches are dropped."""
    ma = demo[0]
    p0 = _WirePool(_server(demo, pipeline, watchdog=False), "p0")
    p1 = _WirePool(_server(demo, pipeline, watchdog=False), "p1")
    router = FleetRouter([p0, p1], placement="round_robin", failover=False)
    try:
        p0.hold_at = 2
        rh = router.submit(TenantRequest(
            ma=ma, niter=40, nchains=16, seed=7, name="R",
            spool_dir=str(tmp_path / "mig_run")), pool=0)
        src_tid = rh.tenant_id
        got = {}
        waiter = threading.Thread(
            target=lambda: got.update(res=rh.result(timeout=RUN_TIMEOUT_S)),
            daemon=True)
        waiter.start()
        assert p0.parked.wait(RUN_TIMEOUT_S), "the source never ran"
        with router._lock:
            router._statuses()
        mig = {}
        mover = threading.Thread(
            target=lambda: mig.update(ok=router.migrate(rh, 1)), daemon=True)
        mover.start()

        def cancelled():
            t = p0.server._running.get(src_tid)
            return t is not None and t.slot.cancelled

        _wait_for(cancelled, "the migration's cancel")
        p0.go.set()
        mover.join(RUN_TIMEOUT_S)
        assert mig.get("ok") is True
        assert rh.pool_idx == 1 and router.migrations == 1
        assert 0 not in router._status_cache and 1 not in router._status_cache
        sent = rh._inner.request
        assert sent.start_sweep == 2 * Q and sent.niter == 40 - 2 * Q
        assert sent.resume_spool and sent.state is None
        assert p1.server._handles[rh.tenant_id].request.start_sweep == 2 * Q
        waiter.join(RUN_TIMEOUT_S)
        assert "res" in got, "result() did not ride through"
        _bitwise(got["res"], refs["R"])

        anchor = router.submit(TenantRequest(
            ma=ma, niter=5000, nchains=32, seed=99, name="A"), pool=0)
        qh = router.submit(TenantRequest(ma=ma, niter=20, nchains=16, seed=3,
                                         name="Q"), pool=0)
        assert router.migrate(qh, 1) is True
        _bitwise(qh.result(timeout=RUN_TIMEOUT_S), refs["Q"])
        assert anchor.cancel()
        assert [e["won"] for e in router._placement_tail] == [
            "pinned", "migrate", "pinned", "pinned", "migrate"]
        assert router.fleet_status()["router"]["migrations"] == 2
    finally:
        router.close()


# --- convergence eviction (the JAX fleet pin, on both executors) -------------

@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_converged_eviction_frees_lanes_and_backfills(demo, pipeline):
    """``on_converged="evict"`` with a target the first evaluation meets:
    the tenant releases its lanes at the next boundary (on the pipelined
    executor after at most the two quanta already dispatched), its result
    a bitwise prefix of the uninterrupted run; the queued 32-chain tenant
    backfills; the summary counts one eviction; bad policies are refused."""
    ma = demo[0]
    srv = _server(demo, pipeline)
    h = srv.submit(TenantRequest(
        ma=ma, niter=50, nchains=16, seed=0, name="E", on_converged="evict",
        monitor=MonitorSpec(params=[0, 1], ess_target=1.0, min_rows=4)))
    h_fill = srv.submit(TenantRequest(ma=ma, niter=10, nchains=32, seed=1,
                                      name="F"))
    try:
        _drive(srv)
        summ = srv.summary()
    finally:
        srv.close()
    res = h.result(timeout=0)
    rows = res.chain.shape[0]
    assert rows == Q if not pipeline else Q <= rows <= 3 * Q
    assert h.status == "done" and h_fill.status == "done"
    assert summ["converged_evictions"] == 1
    assert res.stats["converged_at"] == Q
    srv2 = _server(demo)
    h2 = srv2.submit(TenantRequest(ma=ma, niter=50, nchains=16, seed=0))
    try:
        _drive(srv2)
        _bitwise(res, h2.result(timeout=0), rows=rows)
        with pytest.raises(ValueError, match="on_converged must be"):
            srv2.submit(TenantRequest(ma=ma, niter=5, nchains=16,
                                      on_converged="early"))
        with pytest.raises(ValueError, match="armed target"):
            srv2.submit(TenantRequest(ma=ma, niter=5, nchains=16,
                                      on_converged="evict"))
        with pytest.raises(ValueError, match="armed target"):
            srv2.submit(TenantRequest(ma=ma, niter=5, nchains=16,
                                      monitor=MonitorSpec(params=[0]),
                                      on_converged="evict"))
    finally:
        srv2.close()


# --- worker processes --------------------------------------------------------

def test_subprocess_fleet_bitwise_and_wire(demo, refs, tmp_path):
    """Two workers (``spawn_fleet``, ``device="cpu"``), round robin: the
    stream bitwise its in-process run across the wire and the processes,
    placed 3 / 2; the snapshot (each pool's status read over its HTTP
    port) schema-valid with both pools reachable; the stitched trace
    carries both workers' clocks and every job's router and pool spans;
    each worker retires with exit 0 and its summary."""
    ma, cfg = demo
    fleet = spawn_fleet(str(tmp_path / "two"), 2, ma, cfg,
                        pool_kwargs=dict(POOL_KW, device="cpu",
                                         pipeline=False),
                        placement="round_robin", ready_timeout=RUN_TIMEOUT_S)
    procs = [p.proc for p in fleet.pools]
    try:
        assert all(p.status_url and p.spawn_s > 0 for p in fleet.pools)
        assert [p.ready["coldstart"]["library"] for p in fleet.pools] == [
            None, None]
        handles = [fleet.submit(TenantRequest(ma=ma, **s)) for s in STREAM]
        res = {h.request.name: h.result(timeout=RUN_TIMEOUT_S)
               for h in handles}
        snap = fleet.fleet_status()
        hz = fleet.healthz()
        doc = fleet.export_trace()
    finally:
        teardown_fleet(fleet, remove_dirs=False)
    for name, r in res.items():
        _bitwise(r, refs[name])
    assert snap["router"]["placements"] == {"pool0": 3, "pool1": 2}
    assert snap["n_reachable"] == 2 and hz["n_pools"] == 2
    _valid(snap, "fleet_status", "fleet snapshot")
    assert set(doc["otherData"]["clocks"]) == {"pool0", "pool1"}
    for c in doc["otherData"]["clocks"].values():
        assert c["n"] >= 1 and abs(c["offset_s"]) < 1.0
    cov = port_agg.trace_coverage(doc)
    for h in handles:
        assert cov[h.request.trace_id]["pool"] >= 1
    assert [p.returncode for p in procs] == [0, 0]
    for k in range(2):
        assert os.path.exists(tmp_path / "two" / f"pool{k}" / "summary.json")


@pytest.mark.slow
@pytest.mark.chaos
def test_dead_pool_failover_bitwise(demo, tmp_path):
    """One worker of two dies (``pool_kill`` after its third quantum); the
    router recovers it through its manifest: the spooled victim resumes
    from its checkpoint, the unspooled one is replayed, both bitwise the
    uninterrupted runs, and the other worker's tenants are untouched; the
    recovered worker's manifest is compacted at its clean close."""
    from gibbs_student_t_tpu_torch.serve.manifest import read_manifest

    ma, cfg = demo
    jobs = [dict(niter=20, nchains=16, seed=0, name="s0"),
            dict(niter=20, nchains=16, seed=1, name="V",
                 spool_dir=str(tmp_path / "spoolV")),
            dict(niter=10, nchains=16, seed=2, name="s1"),
            dict(niter=20, nchains=16, seed=3, name="M")]
    srv = _server(demo)
    ref_hs = [srv.submit(TenantRequest(ma=ma, **dict(j, spool_dir=None)))
              for j in jobs]
    try:
        _drive(srv)
    finally:
        srv.close()
    ref = {h.request.name: h.result(timeout=0) for h in ref_hs}
    fleet = spawn_fleet(str(tmp_path / "chaos"), 2, ma, cfg,
                        pool_kwargs=dict(POOL_KW, device="cpu",
                                         pipeline=False),
                        placement="round_robin", watch_poll_s=0.1,
                        ready_timeout=RUN_TIMEOUT_S,
                        faults_for={1: [{"point": "pool_kill", "after": 2,
                                         "action": "kill"}]})
    try:
        handles = [fleet.submit(TenantRequest(ma=ma, **j)) for j in jobs]
        res = {h.request.name: h.result(timeout=RUN_TIMEOUT_S)
               for h in handles}
        failovers, resubmitted = fleet.failovers, fleet.resubmitted
    finally:
        teardown_fleet(fleet, remove_dirs=False)
    assert failovers == 1 and resubmitted == 1
    for name in ("V", "M", "s0", "s1"):
        _bitwise(res[name], ref[name])
    recs = read_manifest(str(tmp_path / "chaos" / "pool1" / "manifest"))
    assert [r["kind"] for r in recs] == ["server"]
    assert recs[0]["compacted"] is True
