"""Fault containment and crash recovery in the port's chain server (CPU,
plain versions, the 5-component demo model, quantum 5, 20 sweeps).

- the fault harness itself: ``FaultSpec`` validation, counting, the
  actions and ``seeded_plan``, each run on both packages' ``faults``
  modules with the same inputs, which must give the same observations;
- the port's own pins, on each executor where the path exists: a
  tenant's ``on_chunk`` callback raising, its spool write failing, its
  staging failing, the drain thread dying in its entry (pipelined: the
  supervisor restarts it once, and the rest of the bundle is drained by
  its successor), a NaN lane under each ``on_divergence`` policy
  (``fail``, ``quarantine``, ``reinit``), the fail-fast reference
  (``supervise=False``) and a ``dispatch_stall`` sleep. The victim
  resolves as the policy says, with its drained prefix bitwise the
  fault-free run's first rows (its healthy chains bitwise throughout),
  and every other tenant is bitwise its fault-free run; pool telemetry
  on and off give the same chains;
- one fault script (callback, lane_nan under each policy, staging,
  spool_io, and a clean tenant that backfills) run by the JAX
  ``ChainServer(pipeline=False)`` and by the port's: the same
  ``TenantError.where``, prefix rows, ``summary()["faults"]``, fired
  counts and health (``n_quarantined``, ``quarantined_chains``,
  ``status``, ``n_reinits``), and manifests with the same sequence of
  record kinds and the same key fields (times, paths and digests left
  out). Chains are not compared across packages: their random streams
  differ by design;
- recovery: an abandoned server's manifest is recovered in process, the
  spooled tenant bitwise its uninterrupted run, the in-memory one listed
  on ``lost_tenants``, and a clean close compacts the log; and a server
  process killed on either side of a spool checkpoint (``os._exit(9)``
  from the ``kill_*_checkpoint`` points) is recovered by
  ``ChainServer.recover``, bitwise.

Every run is driven on a thread of its own with a time limit, so a hang
fails instead of stalling the suite.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.serve import faults as jax_faults
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.serve import (
    ChainServer,
    TenantError,
    TenantRequest,
    faults,
)
from gibbs_student_t_tpu_torch.serve.manifest import read_manifest
from gibbs_student_t_tpu_torch.utils.spool import load_spool_state
from test_torch_host import _fields

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("chain", "bchain", "zchain", "thetachain", "alphachain",
          "poutchain", "dfchain")
EXECUTORS = [False, True]
IDS = ["serial", "pipelined"]
#: a run that takes longer than this has hung (no test may hang the suite)
RUN_TIMEOUT_S = 180.0
#: the victim's chains that no fault touches (lane_nan poisons chain 0)
HEALTHY = list(range(1, 16))


# --- the harness: each property returns what it observed --------------------

def _raised(fn):
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 - the observation
        return type(e).__name__, str(e)
    return None


def _validation(mod):
    bad = [dict(point="banana"), dict(point="callback", action="explode"),
           dict(point="callback", exc="KeyboardInterrupt"),
           dict(point="callback", after=-1), dict(point="callback", times=0),
           dict(point="callback", action="sleep", seconds=0.0)]
    got = [_raised(lambda kw=kw: mod.FaultSpec(**kw)) for kw in bad]
    assert all(g is not None and g[0] == "ValueError" for g in got)
    return got, mod.POINTS


def _counting(mod):
    seen = []
    with mod.inject(mod.FaultSpec("callback", tenant="t", after=1)):
        for tenant in ("other", "t", "t", "t"):
            seen.append(_raised(lambda tenant=tenant: mod.fire(
                "callback", tenant=tenant)))
        counts = mod.fired_counts()
    seen.append(_raised(lambda: mod.fire("callback", tenant="t")))
    assert seen == [None, None, ("RuntimeError", "injected fault [callback]"),
                    None, None]
    return seen, counts, mod.fired_counts()


def _actions(mod):
    specs = [mod.FaultSpec("spool_io", exc="OSError", message="disk full",
                           times=2),
             mod.FaultSpec("drain_death", action="die"),
             mod.FaultSpec("dispatch_stall", action="sleep", seconds=0.01),
             mod.FaultSpec("staging", tenant=3, exc="ValueError")]
    with mod.inject(*specs):
        got = [_raised(lambda p=p, t=t: mod.fire(p, tenant=t))
               for p, t in (("spool_io", "a"), ("spool_io", "b"),
                            ("spool_io", "c"), ("drain_death", None),
                            ("dispatch_stall", None), ("staging", 3),
                            ("staging", "3"), ("lane_nan", 3))]
        counts = sorted(mod.fired_counts().items(), key=repr)
    assert issubclass(mod.WorkerDeath, BaseException)
    assert not issubclass(mod.WorkerDeath, Exception)
    return got, counts


def _seeded_plan(mod):
    tenants = [f"tenant{i}" for i in range(8)]
    plans = [[(s.point, s.tenant, s.after, s.action)
              for s in mod.seeded_plan(seed, tenants, **kw)]
             for seed, kw in ((7, {}), (7, {}), (8, {}),
                              (3, dict(points=("callback", "lane_nan",
                                               "spool_io"),
                                       after_range=(0, 5))))]
    assert plans[0] == plans[1] and plans[0] != plans[2]
    return plans


PROPERTIES = [_validation, _counting, _actions, _seeded_plan]


@pytest.mark.parametrize("prop", PROPERTIES,
                         ids=[p.__name__.strip("_") for p in PROPERTIES])
def test_fault_harness_matches_jax(prop):
    assert prop(faults) == prop(jax_faults)


# --- the port's own pins ------------------------------------------------------

def _drive(srv):
    """``srv.run()`` on a thread of its own; fails when it does not end in
    time, and re-raises what it raised."""
    box = []

    def target():
        try:
            srv.run()
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


@pytest.fixture(scope="module")
def demo():
    return make_demo_model_arrays(components=5), GibbsConfig(model="mixture")


def _server(demo, pipeline, **kw):
    ma, cfg = demo
    return ChainServer(ma, cfg, nlanes=32, quantum=5, record="full",
                       device="cpu", pipeline=pipeline, **kw)


def _request(demo, name, seed, **kw):
    return TenantRequest(ma=demo[0], niter=20, nchains=16, seed=seed,
                         name=name, **kw)


def _two_tenant_run(demo, pipeline, a_kw=None, b_kw=None, specs=(),
                    **srv_kw):
    """Victim A (seed 1) and bystander B (seed 2) on a fresh server under
    the fault specs: ``(handle A, handle B, summary()["faults"], fired
    counts)``."""
    srv = _server(demo, pipeline, **srv_kw)
    try:
        with faults.inject(*specs):
            hA = srv.submit(_request(demo, "A", 1, **(a_kw or {})))
            hB = srv.submit(_request(demo, "B", 2, **(b_kw or {})))
            _drive(srv)
            fired = faults.fired_counts()
        return hA, hB, srv.summary()["faults"], fired
    finally:
        srv.close()


@pytest.fixture(scope="module")
def refs(demo, tmp_path_factory):
    """The fault-free results of tenants A, B and the spooled S (seed 3),
    from one serial run."""
    srv = _server(demo, False)
    hs = [srv.submit(_request(demo, "A", 1)),
          srv.submit(_request(demo, "B", 2)),
          srv.submit(_request(demo, "S", 3, spool_dir=str(
              tmp_path_factory.mktemp("refs") / "S")))]
    try:
        _drive(srv)
    finally:
        srv.close()
    return dict(zip("ABS", (h.result(timeout=0) for h in hs)))


def _bitwise(got, want, rows=None, chains=None):
    """Every record field of ``got`` bitwise ``want``'s (its first
    ``rows`` rows, its ``chains``)."""
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if rows is not None:
            a, b = a[:rows], b[:rows]
        if chains is not None:
            a, b = a[:, chains], b[:, chains]
        np.testing.assert_array_equal(a, b, err_msg=f)


def _failure(handle) -> TenantError:
    with pytest.raises(TenantError) as ei:
        handle.result(timeout=0)
    assert ei.value.tenant_id == handle.tenant_id
    assert handle.status == "failed"
    return ei.value


def _counts(**kw):
    out = {"tenant_failures": 0, "quarantined_lanes": 0, "reinits": 0,
           "worker_restarts": 0, "pool_failures": 0}
    out.update(kw)
    return out


@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_callback_fault_isolates_tenant(demo, refs, pipeline):
    """A raising ``on_chunk`` fails only its tenant, with the records
    drained before it (the raising quantum's included) as a bitwise
    prefix; the bystander is bitwise its fault-free run."""
    calls = []

    def bad_callback(handle, sweep_end, records):
        calls.append(sweep_end)
        if len(calls) >= 2:
            raise ValueError("tenant callback exploded")

    hA, hB, counts, _ = _two_tenant_run(demo, pipeline,
                                        a_kw={"on_chunk": bad_callback})
    err = _failure(hA)
    assert err.where == "drain" and isinstance(err.cause, ValueError)
    assert err.partial.chain.shape[0] == 10 and calls == [5, 10]
    _bitwise(err.partial, refs["A"], rows=10)
    _bitwise(hB.result(timeout=0), refs["B"])
    assert counts == _counts(tenant_failures=1)


@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_spool_io_fault_isolates_tenant(demo, refs, pipeline, tmp_path):
    """A spool write error at the second append fails only the spooled
    tenant; its prefix is the one quantum on disk, bitwise."""
    hA, hB, counts, fired = _two_tenant_run(
        demo, pipeline, a_kw={"spool_dir": str(tmp_path / "A")},
        specs=[faults.FaultSpec("spool_io", tenant="A", after=1,
                                exc="OSError", message="disk full")])
    err = _failure(hA)
    assert err.where == "drain" and isinstance(err.cause, OSError)
    assert "disk full" in str(err)
    _bitwise(err.partial, refs["A"], rows=5)
    assert err.partial.chain.shape[0] == 5
    _bitwise(hB.result(timeout=0), refs["B"])
    assert counts == _counts(tenant_failures=1)
    assert fired == {("spool_io", "A"): 1}


@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_staging_fault_rejects_only_victim(demo, refs, pipeline):
    hA, hB, counts, _ = _two_tenant_run(
        demo, pipeline, specs=[faults.FaultSpec("staging", tenant="A")])
    assert hA.status == "rejected"
    with pytest.raises(RuntimeError, match=r"injected fault \[staging\]"):
        hA.result(timeout=0)
    _bitwise(hB.result(timeout=0), refs["B"])
    assert counts == _counts()


@pytest.mark.parametrize("victim", ["A", "B"], ids=["first", "last"])
def test_drain_worker_death_contained_and_restarted(demo, refs, victim):
    """The drain thread dies (``WorkerDeath``, which its loop does not
    latch) in the victim's entry of the second quantum's bundle: the
    victim fails with the one quantum drained before, the supervisor
    restarts the thread once, and its successor drains the rest of that
    bundle, so the other tenant is bitwise its fault-free run whether it
    comes before the victim or after it."""
    hA, hB, counts, fired = _two_tenant_run(
        demo, True, specs=[faults.FaultSpec("drain_death", tenant=victim,
                                            after=1, action="die")])
    hv, ho = (hA, hB) if victim == "A" else (hB, hA)
    err = _failure(hv)
    assert err.where == "worker"
    assert isinstance(err.cause, faults.WorkerDeath)
    _bitwise(err.partial, refs[victim], rows=5)
    assert err.partial.chain.shape[0] == 5
    _bitwise(ho.result(timeout=0), refs["B" if victim == "A" else "A"])
    assert counts == _counts(tenant_failures=1, worker_restarts=1)
    assert fired == {("drain_death", victim): 1}


@pytest.mark.parametrize("policy", ["fail", "quarantine", "reinit"])
@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_divergence_policy(demo, refs, pipeline, policy):
    """A NaN written into the victim's chain 0 after its first quantum is
    flagged by the second quantum's telemetry and folded at the third
    boundary: ``fail`` fails the tenant with its two quanta drained,
    ``quarantine`` freezes the chain and finishes the others, ``reinit``
    re-draws it from the prior and finishes every chain finite. The
    victim's other chains and the bystander are bitwise their fault-free
    runs, on either executor."""
    hA, hB, counts, fired = _two_tenant_run(
        demo, pipeline, a_kw={"on_divergence": policy},
        specs=[faults.FaultSpec("lane_nan", tenant="A", after=1)])
    assert fired == {("lane_nan", "A"): 1}
    _bitwise(hB.result(timeout=0), refs["B"])
    if policy == "fail":
        err = _failure(hA)
        assert err.where == "divergence"
        assert err.partial.chain.shape[0] == 10
        _bitwise(err.partial, refs["A"], rows=10, chains=HEALTHY)
        _bitwise(err.partial, refs["A"], rows=5)
        assert not np.isfinite(err.partial.chain[5, 0]).all()
        assert counts == _counts(tenant_failures=1)
        return
    res = hA.result(timeout=0)
    assert res.chain.shape[0] == 20
    _bitwise(res, refs["A"], chains=HEALTHY)
    health = hA.health
    assert res.stats["health"] is health
    assert health["status"][0] == "diverged"
    assert list(health["status"][1:]) == ["ok"] * 15
    if policy == "quarantine":
        assert health["n_quarantined"] == 1
        assert health["quarantined_chains"] == [0]
        assert health["n_reinits"] == 0
        # frozen from the fold on: each quantum starts from the state
        # the quarantine froze (its sweeps run on, their results dropped)
        for f in FIELDS:
            a = getattr(res, f)
            assert np.array_equal(a[15, 0], a[10, 0], equal_nan=True), f
        assert counts == _counts(quarantined_lanes=1)
    else:
        assert health["n_quarantined"] == 0 and health["n_reinits"] == 1
        assert np.isfinite(res.chain[10:, 0]).all()
        assert not np.isfinite(res.chain[5:10, 0]).all()
        assert counts == _counts(reinits=1)


@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_supervise_off_keeps_fail_fast(demo, pipeline):
    """``supervise=False``: a tenant's drain failure resolves its handle
    and then fails the run; a lane-health policy is refused there."""
    def bad_callback(handle, sweep_end, records):
        raise ValueError("boom")

    srv = _server(demo, pipeline, supervise=False)
    try:
        with pytest.raises(ValueError, match="supervised server"):
            srv.submit(_request(demo, "P", 4, on_divergence="quarantine"))
        h = srv.submit(_request(demo, "A", 1, on_chunk=bad_callback))
        want = (RuntimeError, "serve worker thread failed") if pipeline \
            else (ValueError, "boom")
        with pytest.raises(want[0], match=want[1]):
            _drive(srv)
        err = _failure(h)
        assert err.where == "drain" and isinstance(err.cause, ValueError)
        assert srv.summary()["faults"]["tenant_failures"] == 0
        assert srv.summary()["supervise"] is False
    finally:
        srv.close()


@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_dispatch_stall_is_bitwise(demo, refs, pipeline):
    """A ``dispatch_stall`` sleep stalls the dispatch thread before two
    quanta and changes nothing else."""
    hA, hB, counts, fired = _two_tenant_run(
        demo, pipeline, specs=[faults.FaultSpec(
            "dispatch_stall", action="sleep", seconds=0.05, after=1,
            times=2)])
    assert fired == {("dispatch_stall", None): 2}
    _bitwise(hA.result(timeout=0), refs["A"])
    _bitwise(hB.result(timeout=0), refs["B"])
    assert counts == _counts()


def test_request_policy_checks_and_telemetry_off(demo, refs):
    """``on_divergence`` takes the four policies and nothing else, needs
    pool telemetry, and the request fields still unported raise; with
    telemetry off the chains are bitwise, with no health report."""
    srv = _server(demo, False, telemetry=False)
    try:
        with pytest.raises(ValueError, match="on_divergence must be one"):
            srv.submit(_request(demo, "X", 1, on_divergence="banana"))
        with pytest.raises(ValueError, match="pool telemetry"):
            srv.submit(_request(demo, "X", 1, on_divergence="fail"))
        with pytest.raises(TypeError, match="not supported"):
            _request(demo, "X", 1, trace_id="t")
        with pytest.raises(ValueError, match="warm_start must be"):
            srv.submit(_request(demo, "X", 1, warm_start=object()))
        with pytest.raises(ValueError, match="supervise must be"):
            _server(demo, False, supervise="auto")
        hA = srv.submit(_request(demo, "A", 1))
        _drive(srv)
    finally:
        srv.close()
    res = hA.result(timeout=0)
    _bitwise(res, refs["A"])
    assert hA.health is None and "health" not in res.stats
    for policy in ("none", "fail", "quarantine", "reinit"):
        assert _request(demo, "X", 1, on_divergence=policy)


# --- one fault script through both servers -----------------------------------

#: manifest fields compared across the packages, by record kind
_KEYS = {
    "server": ("nlanes", "quantum", "record", "max_queue", "backpressure",
               "telemetry", "scheduler"),
    "admit": ("tenant", "name", "seed", "niter", "nchains", "start_sweep",
              "on_divergence", "priority", "deadline_sweeps"),
    "checkpoint": ("tenant", "next_sweep"),
    "done": ("tenant", "status", "sweeps"),
    "fault": ("tenant", "where", "error"),
    "quarantine": ("tenant", "sweep", "chains"),
    "reinit": ("tenant", "sweep", "chains"),
}


def _manifest_view(records):
    out = []
    for r in records:
        kind = r["kind"]
        row = [kind] + [r.get(k) for k in _KEYS[kind]]
        if kind == "admit":
            row += [r.get("spool_dir") is not None,
                    r.get("model_file") is not None]
        out.append(tuple(row))
    return out


def _health_view(h):
    if h.health is None:
        return None
    hl = h.health
    return (hl["n_quarantined"], hl["quarantined_chains"],
            list(hl["status"]), hl["n_reinits"], hl["n_diverged"])


def _script(server_cls, req_cls, fmod, ma, cfg, root, **kw):
    """A: its callback raises at the second quantum; B, C, D: chain 0 goes
    NaN after the first quantum, under fail, quarantine and reinit; E:
    staging fails; F (spooled, queued until A's groups free): its third
    spool write fails; G: a clean tenant that backfills. Serial, 64
    lanes. Returns every tenant's outcome, the fault counters, the fired
    counts and the manifest before the close compacts it."""
    specs = [fmod.FaultSpec("callback", tenant="A", after=1),
             fmod.FaultSpec("lane_nan", tenant="B", after=1),
             fmod.FaultSpec("lane_nan", tenant="C", after=1),
             fmod.FaultSpec("lane_nan", tenant="D", after=1),
             fmod.FaultSpec("staging", tenant="E"),
             fmod.FaultSpec("spool_io", tenant="F", after=2, exc="OSError",
                            message="disk full")]
    man = str(root / "manifest")
    srv = server_cls(ma, cfg, nlanes=64, quantum=5, record="full",
                     pipeline=False, manifest_dir=man, **kw)
    jobs = [("A", 1, dict(on_chunk=lambda h, s, r: None)),
            ("B", 2, dict(on_divergence="fail")),
            ("C", 3, dict(on_divergence="quarantine")),
            ("D", 4, dict(on_divergence="reinit")),
            ("E", 5, {}),
            ("F", 6, dict(spool_dir=str(root / "F"))),
            ("G", 7, dict(niter=10))]
    try:
        with fmod.inject(*specs):
            hs = {name: srv.submit(req_cls(**{
                "ma": ma, "niter": 20, "nchains": 16, "seed": seed,
                "name": name, **extra})) for name, seed, extra in jobs}
            _drive(srv)
            fired = fmod.fired_counts()
        counts = srv.summary()["faults"]
        manifest = _manifest_view(read_manifest(man))
    finally:
        srv.close()
    outcome = {}
    for name, h in hs.items():
        if h.status == "rejected":
            outcome[name] = ("rejected", h.error)
            continue
        try:
            res = h.result(timeout=0)
            outcome[name] = ("done", res.chain.shape[0], _health_view(h))
        except Exception as e:  # noqa: BLE001 - the observation
            rows = (None if getattr(e, "partial", None) is None
                    else e.partial.chain.shape[0])
            outcome[name] = ("failed", type(e).__name__, e.where,
                             type(e.cause).__name__, rows, _health_view(h))
    return outcome, counts, fired, manifest


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    from gibbs_student_t_tpu.serve import ChainServer as JaxServer
    from gibbs_student_t_tpu.serve.scheduler import (
        TenantRequest as JaxRequest,
    )

    jma = jax_demo_model_arrays(components=5)
    got_j = _script(JaxServer, JaxRequest, jax_faults, jma,
                    JaxConfig(model="mixture"),
                    tmp_path_factory.mktemp("jax"), watchdog=False,
                    flight=False)
    got_p = _script(ChainServer, TenantRequest, faults,
                    model_arrays_from_fields(_fields(jma)),
                    GibbsConfig(model="mixture"),
                    tmp_path_factory.mktemp("port"), device="cpu")
    return got_j, got_p


def test_containment_matches_jax(scripted):
    (out_j, counts_j, fired_j, _), (out_p, counts_p, fired_p, _) = scripted
    assert out_p == out_j
    assert counts_p == counts_j
    assert fired_p == fired_j
    # what the script is built to show
    assert counts_p == _counts(tenant_failures=3, quarantined_lanes=1,
                               reinits=1)
    assert out_p["A"][:5] == ("failed", "TenantError", "drain",
                              "RuntimeError", 10)
    assert out_p["B"][:5] == ("failed", "TenantError", "divergence",
                              "RuntimeError", 10)
    assert out_p["C"][:2] == ("done", 20) and out_p["C"][2][:2] == (1, [0])
    assert out_p["D"][:2] == ("done", 20) and out_p["D"][2][3] == 1
    assert out_p["E"][0] == "rejected"
    assert out_p["F"][:5] == ("failed", "TenantError", "drain", "OSError",
                              10)
    assert out_p["G"][:2] == ("done", 10)


def test_manifest_matches_jax(scripted):
    (*_, man_j), (*_, man_p) = scripted
    assert man_p == man_j
    kinds = [r[0] for r in man_p]
    assert kinds[0] == "server"
    assert {"admit", "checkpoint", "done", "fault", "quarantine",
            "reinit"} <= set(kinds)
    assert kinds.count("fault") == 3


# --- recovery -----------------------------------------------------------------

def test_manifest_recovery_resumes_bitwise(demo, refs, tmp_path):
    """An abandoned server (no close, no finalize: the in-process stand-in
    for a kill) leaves a manifest and spool checkpoints from which
    ``recover`` rebuilds the pool and finishes the spooled tenant bitwise
    its uninterrupted run; the in-memory tenant is reported lost; the
    recovered server's clean close compacts the log to its geometry."""
    man = str(tmp_path / "manifest")
    srv = _server(demo, False, manifest_dir=man)
    srv.submit(_request(demo, "S", 3, spool_dir=str(tmp_path / "S")))
    srv.submit(_request(demo, "B", 2))
    for _ in range(2):
        srv.step()
    del srv
    assert [r["kind"] for r in read_manifest(man)] == [
        "server", "admit", "admit", "checkpoint", "checkpoint"]
    srv2, handles = ChainServer.recover(man, device="cpu")
    try:
        assert sorted(handles) == ["S"]
        assert [r["name"] for r in srv2.lost_tenants] == ["B"]
        assert handles["S"].request.start_sweep == 10
        _drive(srv2)
    finally:
        srv2.close()
    res = handles["S"].result(timeout=0)
    _bitwise(res, refs["S"])
    recs = read_manifest(man)
    assert [r["kind"] for r in recs] == ["server"]
    assert recs[0]["compacted"] is True


_VICTIM = """
import os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.serve import ChainServer, TenantRequest, faults

ma = make_demo_model_arrays(components=5)
faults.install(faults.FaultSpec({arm!r}, tenant="S", after=1,
                                action="kill"))
srv = ChainServer(ma, GibbsConfig(model="mixture"), nlanes=32, quantum=5,
                  record="full", device="cpu", manifest_dir={man!r},
                  flight_dir={flight!r}, flight_sync_every=1)
srv.submit(TenantRequest(ma=ma, niter=20, nchains=16, seed=3, name="S",
                         spool_dir={spool!r}))
srv.run()
os._exit(3)  # not reached: the injected kill fires first
"""


@pytest.mark.chaos
@pytest.mark.parametrize("arm", ["kill_before_checkpoint",
                                 "kill_after_checkpoint"])
def test_process_kill_recovery_bitwise(demo, refs, tmp_path, arm):
    """A server process killed (``os._exit(9)``) in its second spool
    append, before or after the state checkpoint, is recovered by a new
    server from its manifest: the before-arm leaves the second quantum's
    rows as orphans past checkpoint 5 (cut at the resume), the after-arm
    resumes from checkpoint 10; either way the chains are bitwise the
    uninterrupted run. The killed server's flight recorder, synced every
    quantum, left a parseable, schema-valid ``flight.json`` at most one
    quantum behind the two it dispatched, which ``tools/postmortem.py``
    renders."""
    from gibbs_student_t_tpu_torch.obs import schema as obs_schema

    man, spool = str(tmp_path / "manifest"), str(tmp_path / "S")
    flight = str(tmp_path / "flight")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _VICTIM.format(repo=REPO, arm=arm, man=man,
                                              spool=spool, flight=flight)],
        capture_output=True, text=True, env=env, timeout=RUN_TIMEOUT_S)
    assert out.returncode == 9, (out.returncode, out.stderr[-2000:])
    bundle = os.path.join(flight, "flight.json")
    with open(bundle) as fh:
        doc = json.load(fh)
    schemas = obs_schema.load_schemas()
    obs_schema.assert_valid(doc, schemas["postmortem"], "flight.json",
                            defs=schemas)
    assert doc["reason"] == "sync" and 2 - doc["quanta_recorded"] <= 1
    shown = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "postmortem.py"),
         bundle], capture_output=True, text=True, env=env, timeout=60)
    assert shown.returncode == 0, shown.stderr[-2000:]
    _, next_sweep, _ = load_spool_state(spool, device="cpu")
    assert next_sweep == (5 if arm == "kill_before_checkpoint" else 10)
    srv, handles = ChainServer.recover(man, device="cpu")
    try:
        assert handles["S"].request.start_sweep == next_sweep
        _drive(srv)
    finally:
        srv.close()
    _bitwise(handles["S"].result(timeout=0), refs["S"])
