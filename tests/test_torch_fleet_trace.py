"""The port's fleet views held against the JAX package's (CPU, no pool).

- ``obs/aggregate.py``: ``fleet_merge`` and ``render_fleet`` on canned pool
  statuses drawn from a seed (reachable and unreachable pools, watchdog
  trips, per-tier SLO series, scheduling counters, sparse fields) return
  the JAX functions' snapshot and text, exactly; ``read_status`` and
  ``read_trace`` read a URL, a directory and a file as JAX's do;
  ``estimate_clock_offset``, ``stitch_fleet_trace`` and ``trace_coverage``
  equal JAX's on synthetic traces (skewed clocks, garbage samples, docs
  without an epoch), and the JAX tests' own pins hold for the port's;
- ``obs/export.prometheus_labeled`` writes the JAX function's bytes on the
  same families (hostile label values, NaN and infinite values, empty
  families, timestamps);
- the router's observability plane over fake pools: trace ids minted
  without touching the caller's request, one journaled placement event a
  placement and ``explain()``, the router's spans and a degraded trace
  export, the capacity sampler's ring and JSONL series, the fleet's
  Prometheus text (byte for byte the JAX router's on the same fakes) and
  postmortem, each valid against the port's schema copy.

The subprocess arm (slow, as the JAX package's is) stitches the trace of
a two-worker fleet on the CPU.
"""

import io
import json
import os
import threading
import time

import numpy as np
import pytest

from gibbs_student_t_tpu.obs import aggregate as jax_agg
from gibbs_student_t_tpu.obs import export as jax_export
from gibbs_student_t_tpu.serve import router as jax_router
from gibbs_student_t_tpu_torch.obs import aggregate as port_agg
from gibbs_student_t_tpu_torch.obs import export as port_export
from gibbs_student_t_tpu_torch.obs import schema as obs_schema
from gibbs_student_t_tpu_torch.obs.http import ObsHttpServer
from gibbs_student_t_tpu_torch.serve import router as port_router
from gibbs_student_t_tpu_torch.serve.scheduler import TenantRequest
from test_rpc import _FakePool

pytestmark = [pytest.mark.fleet, pytest.mark.obswire]

SCHEMAS = obs_schema.load_schemas()
T_FIXED = 1_700_000_000.25


def _valid(doc, name, label):
    obs_schema.assert_valid(doc, SCHEMAS[name], label, defs=SCHEMAS)


@pytest.fixture
def fixed_time(monkeypatch):
    """Both packages stamp snapshots with ``time.time()``: fix it."""
    monkeypatch.setattr(time, "time", lambda: T_FIXED)


# --- fleet_merge and render_fleet --------------------------------------------

def _canned_status(rng, k):
    """One pool's status, drawn from ``rng``: the fields fleet_merge and
    render_fleet read, some missing or of the wrong type."""
    nlanes = int(rng.choice([32, 64, 1024]))
    busy = int(rng.integers(0, nlanes + 1))
    tiers = {str(t): {leg: list(np.round(rng.random(int(rng.integers(0, 4)))
                                         * 1e3, 3))
                      for leg in port_agg.SLO_LEGS}
             for t in range(int(rng.integers(0, 3)))}
    state = rng.choice(["ok", "tripped", "off", None])
    st = {
        "schema": 1, "nlanes": nlanes, "busy_lanes": busy,
        "free_groups": int(rng.integers(0, 4)), "group": 16,
        "occupancy_now": busy / nlanes, "occupancy": float(rng.random()),
        "queue_depth": int(rng.integers(0, 6)),
        "staged": int(rng.integers(0, 2)), "quanta": int(rng.integers(0, 99)),
        "uptime_s": float(np.round(rng.random() * 100, 3)),
        "faults": {"pool_failures": int(rng.integers(0, 2) * (k % 2)),
                   "tenant_faults": int(rng.integers(0, 3))},
        "tenants": [{"tenant_id": i, "niter": 50, "sweeps_done": 5 * i}
                    for i in range(int(rng.integers(0, 4)))],
        "slo": {"admission_ms": None,
                "n_converged": int(rng.integers(0, 5))},
        "slo_raw": {leg: list(np.round(rng.random(int(rng.integers(0, 6)))
                                       * 1e3, 3))
                    for leg in port_agg.SLO_LEGS},
        "sched": {"preemptions": int(rng.integers(0, 3)),
                  "sheds": int(rng.integers(0, 2)),
                  "queue_tiers": {"0": int(rng.integers(0, 2)),
                                  "2": int(rng.integers(0, 3))}},
        "watchdog": {"state": state,
                     "trip": ({"cause": "throughput_collapse"}
                              if state == "tripped" else None),
                     "heartbeat_age_s": {"dispatch": float(rng.random() * 3),
                                         "drain": None}},
    }
    if tiers:
        st["slo_raw"]["tiers"] = tiers
    if k % 3 == 2:
        st["backend"] = {"platform": "gpu", "native": None, "scatter": False}
    if k % 4 == 3:                 # a sparse status
        for key in ("busy_lanes", "sched", "watchdog", "slo_raw"):
            st.pop(key)
        st["queue_depth"] = "3"
    return st


def _canned_results(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if rng.random() < 0.2:
            out.append((f"http://127.0.0.1:{9000 + k}",
                        ConnectionError("refused")))
        else:
            out.append((f"pool{k}", _canned_status(rng, k)))
    return out


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 3), (2, 5), (3, 8), (4, 0)])
def test_fleet_merge_and_render_match_jax(seed, n, fixed_time):
    results = _canned_results(seed, n)
    port = port_agg.fleet_merge(results)
    jax = jax_agg.fleet_merge(results)
    assert json.dumps(port, sort_keys=True) == json.dumps(jax,
                                                          sort_keys=True)
    port["router"] = jax["router"] = {"placements": {"pool0": 2},
                                      "failovers": 1, "sheds": 0}
    texts = []
    for mod, snap in ((port_agg, port), (jax_agg, jax)):
        out = io.StringIO()
        mod.render_fleet(snap, out)
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert "router placements: pool0=2" in texts[0]


def test_fleet_merge_folds_watchdog_state():
    """A pool answering healthz but with a TRIPPED watchdog renders sick:
    the fleet row folds the watchdog state, its cause and the heartbeat
    ages, and ``render_fleet`` shows the trip."""
    def st(state, cause=None, beat=0.1):
        return {"schema": 1, "queue_depth": 0, "staged": 0,
                "free_groups": 2, "group": 16, "occupancy_now": 0.5,
                "nlanes": 64, "busy_lanes": 32, "faults": {},
                "slo": {"admission_ms": None},
                "slo_raw": {"admission_ms": []}, "tenants": [],
                "watchdog": {"state": state,
                             "trip": ({"cause": cause} if cause else None),
                             "heartbeat_age_s": {"dispatch": beat}}}

    snap = port_agg.fleet_merge([
        ("good", st("ok")),
        ("stuck", st("tripped", cause="dispatch_stall", beat=42.0))])
    _valid(snap, "fleet_status", "fleet snapshot")
    rows = {p["source"]: p for p in snap["pools"]}
    assert rows["good"]["healthy"] is True
    assert rows["good"]["watchdog_state"] == "ok"
    assert rows["stuck"]["healthy"] is False
    assert rows["stuck"]["watchdog_cause"] == "dispatch_stall"
    assert rows["stuck"]["heartbeat_age_max_s"] == pytest.approx(42.0)
    out = io.StringIO()
    port_agg.render_fleet(snap, out)
    text = out.getvalue()
    assert "TRIP" in text and "wd:dispatch_stall" in text
    good_line = next(ln for ln in text.splitlines()
                     if ln.strip().startswith("good"))
    assert "TRIP" not in good_line


def test_read_status_and_trace_match_jax(tmp_path):
    """A URL (``/status`` and ``/trace`` appended, or already there), an
    ``obs_dir`` and a file path read as the JAX readers read them;
    ``fleet_status`` over them, an unreachable URL among them, merges as
    JAX's does."""
    st = _canned_status(np.random.default_rng(5), 0)
    doc = {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 0,
                            "ts": 1.5, "dur": 2.0, "args": {}}],
           "otherData": {"epoch_wall": 10.0, "dropped_spans": 0}}
    srv = ObsHttpServer(port=0, status_fn=lambda: st, trace_fn=lambda: doc)
    d = tmp_path / "obs"
    d.mkdir()
    (d / "status.json").write_text(json.dumps(st))
    (tmp_path / "trace.json").write_text(json.dumps(doc))
    try:
        for src in (srv.url, srv.url + "/status", str(d),
                    str(d / "status.json")):
            assert port_agg.read_status(src) == jax_agg.read_status(src)
        for src in (srv.url, srv.url + "/trace", str(tmp_path / "trace.json")):
            assert port_agg.read_trace(src) == jax_agg.read_trace(src)
        srcs = [srv.url, str(d), "http://127.0.0.1:9/status"]
        port = port_agg.fleet_status(srcs, timeout=2.0)
        jax = jax_agg.fleet_status(srcs, timeout=2.0)
        port.pop("t")
        jax.pop("t")
        assert port == jax and port["n_reachable"] == 2
    finally:
        srv.close()
    (tmp_path / "list.json").write_text("[1, 2]")
    for mod in (port_agg, jax_agg):
        with pytest.raises(ValueError, match="not an object"):
            mod.read_status(str(tmp_path / "list.json"))


# --- the clock-offset estimator ----------------------------------------------

def _clock_cases():
    rng = np.random.default_rng(11)
    cases = {"empty": [], "garbage": [(5.0, 4.0, 3.0), ("x",), None, (1.0,)],
             "skewed": [], "asymmetric": [(50.0, 50.03, 50.03)],
             "min_rtt": [(11.0, 11.25 + 3.7, 11.5),
                         (10.0, 10.0005 + 2.0, 10.001)]}
    t0 = 100.0
    for rtt in (0.010, 0.004, 0.020):
        cases["skewed"].append((t0, t0 + rtt / 2.0 + 5.0, t0 + rtt))
        t0 += 1.0
    for k in range(4):
        t = np.cumsum(rng.random(12)) + 1e3
        rtt = rng.random(12) * 0.05
        off = rng.normal() * 3
        cases[f"random{k}"] = [(float(a), float(a + r * rng.random() + off),
                                float(a + r)) for a, r in zip(t, rtt)]
    return cases


CLOCKS = _clock_cases()


@pytest.mark.parametrize("name", list(CLOCKS))
def test_clock_offset_matches_jax(name):
    assert (port_agg.estimate_clock_offset(CLOCKS[name])
            == jax_agg.estimate_clock_offset(CLOCKS[name]))


def test_clock_offset_pins():
    """The JAX tests' pins: a skewed clock recovered exactly, the min-RTT
    sample preferred, the asymmetric error bounded by rtt / 2, garbage
    degrading to the identity offset."""
    est = port_agg.estimate_clock_offset(CLOCKS["skewed"])
    assert est["n"] == 3
    assert est["offset_s"] == pytest.approx(5.0, abs=1e-6)
    assert est["rtt_s"] == pytest.approx(0.004, abs=1e-6)
    est = port_agg.estimate_clock_offset(CLOCKS["min_rtt"])
    assert est["offset_s"] == pytest.approx(2.0, abs=1e-6)
    assert est["rtt_s"] == pytest.approx(0.001, abs=1e-6)
    est = port_agg.estimate_clock_offset(CLOCKS["asymmetric"])
    assert est["offset_s"] == pytest.approx(0.015, abs=1e-6)
    for name in ("empty", "garbage"):
        assert port_agg.estimate_clock_offset(CLOCKS[name]) == {
            "offset_s": 0.0, "rtt_s": None, "n": 0}


# --- stitching and coverage --------------------------------------------------

def _doc(events, epoch_wall, dropped=0):
    other = {"dropped_spans": dropped}
    if epoch_wall is not None:
        other["epoch_wall"] = epoch_wall
    return {"traceEvents": list(events), "displayTimeUnit": "ms",
            "otherData": other}


def _xev(name, ts, pid=0, tid=0, **args):
    return {"name": name, "ph": "X", "pid": pid, "tid": tid, "ts": ts,
            "dur": 100.0, "args": args}


def _meta(pid, name):
    return {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name}}


def _stitch_case(seed):
    """A router doc and pool rows of synthetic spans from ``seed``: jobs
    with trace ids on both sides, untagged spans, metadata rows, skewed
    epochs, a pool without an epoch and a pool with a malformed pid."""
    rng = np.random.default_rng(seed)
    jobs = [f"j{seed}_{i}" for i in range(int(rng.integers(1, 5)))]
    router_ev = [_meta(0, "serve")]
    for j in jobs:
        router_ev += [_xev(n, float(np.round(rng.random() * 1e6, 3)),
                           trace_id=j) for n in ("place", "submit")]
    router_ev.append(_xev("status_poll", 5.0))
    pools = []
    for k in range(int(rng.integers(0, 4))):
        ev = [_meta(0, "dispatch"), _meta(int(k + 1), "tenant")]
        for j in jobs:
            if rng.random() < 0.7:
                ev.append(_xev("quantum", float(rng.random() * 1e6),
                               pid=int(rng.integers(0, 4)), trace_id=j))
        ev.append(_xev("admit", 7.0, pid=1))
        if k == 2:
            ev.append(_xev("bad", 9.0, pid="x"))
        epoch = None if k == 1 else float(1000 + rng.normal() * 5)
        pools.append({"label": f"pool{k}", "doc": _doc(ev, epoch,
                                                       dropped=k),
                      "clock": {"offset_s": float(rng.normal()),
                                "rtt_s": float(rng.random() * 1e-3),
                                "n": int(rng.integers(0, 6))}})
    return _doc(router_ev, 1000.0, dropped=1), pools


@pytest.mark.parametrize("seed", range(5))
def test_stitch_and_coverage_match_jax(seed):
    router_doc, pools = _stitch_case(seed)
    port = port_agg.stitch_fleet_trace(json.loads(json.dumps(router_doc)),
                                       json.loads(json.dumps(pools)))
    jax = jax_agg.stitch_fleet_trace(json.loads(json.dumps(router_doc)),
                                     json.loads(json.dumps(pools)))
    assert port == jax
    assert port_agg.trace_coverage(port) == jax_agg.trace_coverage(jax)
    _valid(port, "fleet_trace", "stitched doc")


def test_stitch_pins():
    """The JAX tests' pins: pool pids on their own stride with the label
    prefixed, a pool clock 10 s ahead corrected onto the router's
    timeline, coverage counted by side."""
    router = _doc([_meta(0, "serve"), _xev("place", 10.0, trace_id="t1")],
                  1000.0)
    pool = _doc([_meta(0, "dispatch"), _xev("quantum", 20.0, pid=1,
                                            trace_id="t1")], 1000.0)
    doc = port_agg.stitch_fleet_trace(router, [
        {"label": "pool0", "doc": pool,
         "clock": {"offset_s": 0.0, "rtt_s": 0.001, "n": 3}}])
    _valid(doc, "chrome_trace", "stitched doc (chrome shape)")
    stride = port_agg.POOL_PID_STRIDE
    assert {ev["pid"] for ev in doc["traceEvents"]} == {0, stride,
                                                        stride + 1}
    assert {ev["args"]["name"] for ev in doc["traceEvents"]
            if ev["name"] == "process_name"} == {"router", "pool0/dispatch"}
    router = _doc([_xev("submit", 3_000_000.0, trace_id="j")], 1000.0)
    pool = _doc([_xev("quantum", 1_000_000.0, pid=0, trace_id="j")], 1012.0)
    doc = port_agg.stitch_fleet_trace(router, [
        {"label": "p", "doc": pool,
         "clock": {"offset_s": 10.0, "rtt_s": 0.001, "n": 5}}])
    evs = {ev["pid"]: ev for ev in doc["traceEvents"]}
    assert evs[0]["ts"] == pytest.approx(3_000_000.0)
    assert evs[stride]["ts"] == pytest.approx(3_000_000.0)
    assert doc["otherData"]["clocks"]["p"]["shift_us"] == pytest.approx(
        2_000_000.0)
    router = _doc([_xev("place", 0.0, trace_id="a"),
                   _xev("submit", 1.0, trace_id="a"), _xev("noise", 2.0)],
                  1.0)
    pool = _doc([_xev("quantum", 0.0, trace_id="a"),
                 _xev("quantum", 5.0, trace_id="b")], 1.0)
    cov = port_agg.trace_coverage(port_agg.stitch_fleet_trace(router, [
        {"label": "p", "doc": pool, "clock": {"offset_s": 0.0}}]))
    assert cov == {"a": {"router": 2, "pool": 1},
                   "b": {"router": 0, "pool": 1}}


# --- prometheus_labeled ------------------------------------------------------

def _families():
    return {
        "empty": {},
        "one": {"fleet_dead_pools": {"kind": "gauge", "help": "Dead",
                                     "samples": [({}, 0)]}},
        "labeled": {
            "fleet_placements": {"kind": "counter",
                                 "help": "Tenants placed, per pool",
                                 "samples": [({"pool": "pool0"}, 3),
                                             ({"pool": "pool1"}, 2)]},
            "fleet_pool_occupancy_now": {"samples": [
                ({"pool": 'we"ird\\pool\nname', "z": 1, "a b": "x"}, 0.25),
                ({"pool": "nan"}, float("nan")),
                ({"pool": "inf"}, float("inf")),
                ({"pool": "ninf"}, -float("inf")),
                ({"pool": "none"}, None)]},
            "serve_occupancy": {"kind": "gauge", "samples": [({}, 1)]},
            "9 bad-name": {"kind": "counter", "help": "multi\nline \\ help",
                           "samples": []},
            "gst_prefixed": None},
    }


@pytest.mark.parametrize("name", list(_families()))
@pytest.mark.parametrize("ts", [None, 1_700_000_000_123])
@pytest.mark.parametrize("prefix", ["gst_", "x_"])
def test_prometheus_labeled_bytes_match_jax(name, ts, prefix):
    fam = _families()[name]
    port = port_export.prometheus_labeled(fam, prefix=prefix, ts_ms=ts)
    jax = jax_export.prometheus_labeled(fam, prefix=prefix, ts_ms=ts)
    assert port.encode() == jax.encode()
    if fam:
        assert port.endswith("\n")
        for n in fam:
            assert port.count(
                f"# TYPE {port_export._metric_name(n, prefix)} ") == 1


# --- the router's plane over fake pools --------------------------------------

def _router(pkg, pools, **kw):
    kw.setdefault("failover", False)
    return pkg.FleetRouter(pools, **kw)


def test_router_mints_trace_ids_and_journals_placements(tmp_path):
    """Every job gets a trace id (the caller's request untouched), one
    schema-valid placement event a placement lands in the journal, and
    ``explain()`` answers by handle and by trace id; without a journal the
    in-memory tail answers."""
    light = _FakePool("light", queue_depth=0, free_groups=3, occupancy=0.2)
    heavy = _FakePool("heavy", queue_depth=5, free_groups=0, occupancy=0.9)
    r = _router(port_router, [heavy, light], obs_dir=str(tmp_path / "obs"))
    reqs = [TenantRequest(ma={}, niter=5, nchains=4, name=f"job{i}")
            for i in range(3)]
    handles = [r.submit(rq) for rq in reqs]
    assert all(rq.trace_id is None for rq in reqs)
    tids = [h.request.trace_id for h in handles]
    assert all(tids) and len(set(tids)) == 3
    assert r.placement_events == sum(r.placements.values()) == 3
    events = [json.loads(ln) for ln in
              (tmp_path / "obs" / "placements.jsonl").read_text()
              .splitlines()]
    assert len(events) == 3
    for ev in events:
        _valid(ev, "placement_event", "journal event")
        assert ev["reason"] == "submit" and ev["pool"] == "light"
        assert ev["won"] == "score"
        cands = {c["pool"]: c for c in ev["candidates"]}
        assert cands["heavy"]["score"]["queue_staged"] == 5
    ex = r.explain(handles[0])
    assert len(ex) == 1 and ex[0]["trace_id"] == tids[0]
    assert r.explain(tids[1])[0]["trace_id"] == tids[1]
    assert r.explain("job2")[0]["job"] == "job2"
    r2 = _router(port_router, [_FakePool("only")], placement="round_robin")
    h2 = r2.submit(reqs[0])
    assert r2.explain(h2)[0]["won"] == "round_robin"
    r2.close()
    r.close()


def test_router_spans_share_trace_id_and_export_degrades(tmp_path):
    """The router's place/submit/result spans carry the job's trace id;
    ``export_trace`` over fakes without a trace surface degrades to
    ``missing_pools`` notes and still returns a schema-valid doc; with
    ``trace=False`` there is no recorder and submission is the same."""
    r = _router(port_router, [_FakePool("p0")], obs_dir=str(tmp_path / "o"))
    h = r.submit(TenantRequest(ma={}, niter=5, nchains=4, name="jX"))
    h._inner._finish({"ok": True})
    assert h.result(timeout=5) == {"ok": True}
    tid = h.request.trace_id
    spans = r.spans.spans()
    for s in spans:
        _valid(s, "span", "router span")
    assert {"place", "submit", "result"} <= {
        s["name"] for s in spans if s.get("trace_id") == tid}
    assert all(s["role"] == "router" for s in spans
               if s["name"] in ("place", "submit", "result"))
    out = str(tmp_path / "fleet_trace.json")
    doc = r.export_trace(path=out)
    _valid(doc, "fleet_trace", "degraded fleet trace")
    assert [m["pool"] for m in doc["otherData"]["missing_pools"]] == ["p0"]
    with open(out) as fh:
        assert json.load(fh) == doc
    cov = port_agg.trace_coverage(doc)
    assert cov[tid]["router"] >= 3 and cov[tid]["pool"] == 0
    r2 = _router(port_router, [_FakePool("p1")], trace=False)
    h2 = r2.submit(TenantRequest(ma={}, niter=5, nchains=4, name="jY"))
    assert r2.spans is None and h2.request.trace_id
    _valid(r2.export_trace(), "fleet_trace", "spanless fleet trace")
    r2.close()
    r.close()


def _watched(pool):
    """``pool`` whose status carries a watchdog block and one tenant with
    a convergence estimate."""
    orig = pool.status

    def status():
        st = orig()
        st["watchdog"] = {"state": "ok",
                          "heartbeat_age_s": {"dispatch": 0.25}}
        st["tenants"] = [{"tenant_id": 7, "name": "jZ",
                          "trace_id": "abc123", "sweeps_done": 40,
                          "niter": 100, "est_sweeps_to_target": 45.0}]
        return st

    pool.status = status
    return pool


def test_capacity_sampler_ring_jsonl_and_metrics(tmp_path):
    """The sampler thread fills the ring and the JSONL series with
    schema-valid samples (watchdog health, per-tenant slack), the
    exposition declares each family once, the postmortem validates, and
    ``close()`` joins the sampler."""
    r = _router(port_router, [_watched(_FakePool("p0"))],
                obs_dir=str(tmp_path / "obs"), capacity_sample_s=0.02)
    try:
        deadline = time.monotonic() + 10.0
        while r.capacity_samples < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert r.capacity_samples >= 2
        ring = r.capacity_timeline()
        assert ring and len(ring) <= 512
        for s in ring:
            _valid(s, "capacity_sample", "ring sample")
        row = ring[-1]["pools"][0]
        assert row["watchdog_state"] == "ok" and row["healthy"]
        assert row["heartbeat_age_max_s"] == pytest.approx(0.25)
        ten = ring[-1]["tenants"][0]
        assert ten["trace_id"] == "abc123"
        assert ten["remaining_sweeps"] == 60
        assert ten["slack_sweeps"] == pytest.approx(15.0)
        for line in (tmp_path / "obs" / "capacity.jsonl").read_text() \
                .splitlines():
            _valid(json.loads(line), "capacity_sample", "jsonl sample")
        text = r.metrics_text()
        assert text.count("# TYPE gst_fleet_placements counter") == 1
        assert 'gst_fleet_pool_queue_depth{pool="p0"}' in text
        assert 'gst_fleet_pool_healthy{pool="p0"} 1.0' in text
        pm = r.fleet_postmortem()
        _valid(pm, "fleet_postmortem", "fleet postmortem")
        assert pm["pools"][0]["pool"] == "p0"
    finally:
        r.close()
    assert not any(t.name == "gst-fleet-capacity"
                   for t in threading.enumerate())


def test_router_plane_matches_jax_router(tmp_path, fixed_time):
    """Both routers over the same fakes, with fixed trace ids and clock:
    the capacity sample, the Prometheus text (byte for byte), the
    postmortem and the journal's events are the JAX router's."""
    out = {}
    for name, pkg in (("port", port_router), ("jax", jax_router)):
        pools = [_watched(_FakePool("a", queue_depth=1)),
                 _FakePool("b", free_groups=0, occupancy=0.9)]
        r = _router(pkg, pools, obs_dir=str(tmp_path / name))
        for i in range(4):
            r.submit(TenantRequest(ma={}, niter=5, nchains=4, name=f"j{i}",
                                   trace_id=f"tr{i}",
                                   priority=0 if i == 2 else 1))
        sample = r.capacity_sample()
        out[name] = dict(
            sample=sample, metrics=r.metrics_text(),
            postmortem=r.fleet_postmortem(reason="test"),
            journal=(tmp_path / name / "placements.jsonl").read_text(),
            explain=r.explain("tr2"))
        r.close()
    assert out["port"] == out["jax"]
    _valid(out["port"]["postmortem"], "fleet_postmortem", "postmortem")


# --- the slow arm: a two-worker fleet on the CPU, stitched end to end --------

@pytest.mark.slow
def test_two_pool_subprocess_fleet_stitches_end_to_end(tmp_path):
    """Two port workers on the CPU: one stitched, schema-valid trace in
    which every completed job has a router span and a pool span with its
    trace id, a clock block a pool, and a journal that reconciles with
    the router's counters."""
    from gibbs_student_t_tpu_torch.config import GibbsConfig
    from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
    from gibbs_student_t_tpu_torch.serve.router import (
        spawn_fleet,
        teardown_fleet,
    )

    ma = make_demo_model_arrays(components=5)
    cfg = GibbsConfig(model="mixture")
    obs = str(tmp_path / "router_obs")
    fleet = spawn_fleet(str(tmp_path / "fleet"), 2, ma, cfg,
                        pool_kwargs=dict(device="cpu", nlanes=32, quantum=5,
                                         record="full"),
                        placement="round_robin", obs_dir=obs,
                        capacity_sample_s=0.25, ready_timeout=300.0)
    try:
        handles = [fleet.submit(TenantRequest(
            ma=ma, niter=10, nchains=16, seed=s, name=f"job{s}"))
            for s in range(4)]
        for h in handles:
            h.result(timeout=300)
        doc = fleet.export_trace(path=str(tmp_path / "fleet_trace.json"))
        _valid(doc, "fleet_trace", "stitched 2-pool trace")
        assert not doc["otherData"].get("missing_pools")
        clocks = doc["otherData"]["clocks"]
        assert set(clocks) == {"pool0", "pool1"}
        for c in clocks.values():
            assert c["n"] >= 1 and abs(c["offset_s"]) < 1.0
        cov = port_agg.trace_coverage(doc)
        for h in handles:
            assert cov[h.request.trace_id]["router"] >= 1
            assert cov[h.request.trace_id]["pool"] >= 1
        stride = port_agg.POOL_PID_STRIDE
        assert {ev["pid"] // stride for ev in doc["traceEvents"]
                if ev["pid"] >= stride} == {1, 2}
        snap = fleet.fleet_status()
        assert snap["router"]["placement_events"] == sum(
            snap["router"]["placements"].values()) == 4
        with open(os.path.join(obs, "placements.jsonl")) as fh:
            events = [json.loads(ln) for ln in fh]
        assert {e["trace_id"] for e in events} == {
            h.request.trace_id for h in handles}
        assert fleet.capacity_samples >= 1
        for s in fleet.capacity_timeline():
            _valid(s, "capacity_sample", "live capacity sample")
    finally:
        teardown_fleet(fleet, remove_dirs=True)
