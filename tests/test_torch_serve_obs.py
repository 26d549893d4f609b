"""The port's serving observability plane on the CPU, held against the JAX
package's (the 5-component demo model, 32 lanes, quantum 5).

- the plane's modules against the JAX modules on the same inputs: span
  recording at a fixed clock (the Chrome trace document and the JSONL
  lines, ring overflow and sink failure), the streaming convergence
  monitor on the same seeded rows in the same quanta (snapshots to 1e-12,
  ``converged_at`` and ``est_sweeps_to_target`` included), the watchdog
  on the same heartbeat and wall streams under a fake clock (the same
  cause at the same tick, and no trip on a clean stream with +-50 % noisy
  walls), the flight recorder (the same bundle), the Prometheus text and
  the schema validator (the same verdicts);
- one shared 4-tenant run of the port's server with the whole plane armed
  (monitors, spans with a JSONL sink, ``obs_dir``, a metrics run
  directory, a manifest, the flight recorder and the watchdog), and the
  same tenant set through the JAX server: ``progress()`` against the
  post-hoc diagnostics of the drained rows (1e-6), the trace's coverage,
  every emitted record against the port's schema copy, the cost against
  the dispatch wall (1e-9), and the key trees of ``status()``,
  ``summary()``, ``healthz()``, ``cost()``, ``progress()`` and the
  postmortem equal to the JAX server's but for a listed set of keys;
- the plane on and off (bitwise, on each executor), the warn-and-continue
  paths, a stalled dispatch, eviction at convergence, a preempted and a
  recovered monitored tenant.

Every run is driven on a thread of its own with a time limit, so a hang
fails instead of stalling the suite.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.obs import MetricsRegistry
from gibbs_student_t_tpu_torch.obs import export as port_export
from gibbs_student_t_tpu_torch.obs import flight as port_flight
from gibbs_student_t_tpu_torch.obs import schema as port_schema
from gibbs_student_t_tpu_torch.obs import spans as port_spans
from gibbs_student_t_tpu_torch.obs import watchdog as port_watchdog
from gibbs_student_t_tpu_torch.obs.metrics import read_events
from gibbs_student_t_tpu_torch.parallel.diagnostics import (
    ess_per_param,
    split_rhat_per_param,
)
from gibbs_student_t_tpu_torch.serve import (
    ChainServer,
    MonitorSpec,
    TenantRequest,
    faults,
)
from gibbs_student_t_tpu_torch.serve import monitor as port_monitor
from gibbs_student_t_tpu_torch.serve.manifest import read_manifest

pytestmark = pytest.mark.obsplane

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("chain", "bchain", "zchain", "thetachain", "alphachain",
          "poutchain", "dfchain")
EXECUTORS = [False, True]
IDS = ["serial", "pipelined"]
RUN_TIMEOUT_S = 180.0
MON_PARAMS = [0, 1, 2]
NITERS = (15, 10, 15, 10)
Q = 5


# --- helpers -----------------------------------------------------------------

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


def _bitwise(got, want, rows=None):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if rows is not None:
            b = b[:rows]
        np.testing.assert_array_equal(a, b, err_msg=f)
    for k in ("acc_white", "acc_hyper"):
        b = want.stats[k] if rows is None else want.stats[k][:rows]
        np.testing.assert_array_equal(got.stats[k], b, err_msg=k)


def _valid(doc, name, schemas, label):
    port_schema.assert_valid(json.loads(json.dumps(doc, default=float)),
                             schemas[name], label, defs=schemas)


@pytest.fixture(scope="module")
def demo():
    return make_demo_model_arrays(components=5), GibbsConfig(model="mixture")


@pytest.fixture(scope="module")
def schemas():
    return port_schema.load_schemas()


def _server(demo, pipeline=True, **kw):
    ma, cfg = demo
    return ChainServer(ma, cfg, nlanes=32, quantum=Q, record="full",
                       device="cpu", pipeline=pipeline, **kw)


def _plane_set(ma, req_cls, spec):
    return [req_cls(ma=ma, niter=n, nchains=16, seed=i, name=f"t{i}",
                    monitor=spec) for i, n in enumerate(NITERS)]


@pytest.fixture(scope="module")
def refs(demo):
    """The tenant set's results with the plane off, serial."""
    srv = _server(demo, False, spans=False, flight=False, watchdog=False)
    hs = [srv.submit(r) for r in _plane_set(demo[0], TenantRequest, None)]
    try:
        _drive(srv)
    finally:
        srv.close()
    return [h.result(timeout=0) for h in hs]


def _armed_run(srv, reqs, root=None):
    """Submit ``reqs``, drive the server, read the live healthz at the first
    boundary and, from the second on, the live status once the first
    running tenant's monitor has evaluated (the boundary waits for the
    drain); then the trace, status, summary, healthz and postmortem;
    close. Returns what it read."""
    hs = [srv.submit(r) for r in reqs]
    live = {}

    def on_quantum(s):
        if "healthz" not in live and s.quanta:
            live["healthz"] = s.healthz()
        t_end = time.monotonic() + 5.0
        while "status" not in live and s.quanta >= 2 \
                and time.monotonic() < t_end:
            st = s.status()
            if st["tenants"] and "blocks" in st["tenants"][0]:
                live["status"] = st
            time.sleep(0.01)

    try:
        _drive(srv, on_quantum)
        out = {"trace": (srv.export_trace(os.path.join(root, "trace.json"))
                         if root is not None else None),
               "status": srv.status(), "summary": srv.summary(),
               "healthz": srv.healthz(),
               "pm_path": srv.dump_postmortem(reason="fixture")}
    finally:
        srv.close()
    out.update(server=srv, handles=hs, live=live,
               results=[h.result(timeout=0) for h in hs])
    return out


@pytest.fixture(scope="module")
def plane_run(demo, tmp_path_factory):
    """ONE pipelined 4-tenant run of the port's server with the whole plane
    armed: monitors on 3 parameters with loose targets, spans with a JSONL
    sink, ``obs_dir``, a metrics run directory, a crash manifest, the
    flight recorder and the watchdog; the stage timers off, as in the JAX
    run it is compared with (tests/test_torch_stage_timers.py has them
    on)."""
    root = tmp_path_factory.mktemp("plane")
    obs_dir, run_dir = str(root / "obs"), str(root / "run")
    reg = MetricsRegistry(run_dir=run_dir)
    reg.write_manifest(config=demo[1], seeds=list(range(len(NITERS))))
    srv = _server(demo, True, metrics=reg, obs_dir=obs_dir,
                  manifest_dir=str(root / "manifest"),
                  trace_jsonl=os.path.join(obs_dir, "spans.jsonl"),
                  kernel_timers=False)
    spec = MonitorSpec(params=MON_PARAMS, ess_target=4.0, rhat_target=50.0)
    out = _armed_run(srv, _plane_set(demo[0], TenantRequest, spec),
                     str(root))
    reg.close()
    out.update(obs_dir=obs_dir, run_dir=run_dir,
               man_dir=str(root / "manifest"))
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The same tenant set through the JAX server, with the same plane
    (its kernel timers off, as the port's fixture has its stage timers)."""
    from gibbs_student_t_tpu.obs import MetricsRegistry as JaxRegistry
    from gibbs_student_t_tpu.serve import ChainServer as JaxServer
    from gibbs_student_t_tpu.serve import MonitorSpec as JaxSpec
    from gibbs_student_t_tpu.serve import TenantRequest as JaxRequest

    root = tmp_path_factory.mktemp("jaxplane")
    obs_dir = str(root / "obs")
    reg = JaxRegistry(run_dir=str(root / "run"))
    jma = jax_demo_model_arrays(components=5)
    srv = JaxServer(jma, JaxConfig(model="mixture"), nlanes=32, quantum=Q,
                    record="full", metrics=reg, obs_dir=obs_dir,
                    manifest_dir=str(root / "manifest"),
                    trace_jsonl=os.path.join(obs_dir, "spans.jsonl"),
                    kernel_timers=False)
    spec = JaxSpec(params=MON_PARAMS, ess_target=4.0, rhat_target=50.0)
    out = _armed_run(srv, _plane_set(jma, JaxRequest, spec), str(root))
    reg.close()
    return out


# --- the modules against the JAX modules --------------------------------------

def _spans_view(mod, tmp_path, tag):
    """Spans at a fixed clock through one package's recorder: its Chrome
    trace document, JSONL lines, drops, the metrics counter and the
    warnings, then a sink that fails."""
    from gibbs_student_t_tpu.obs.metrics import MetricsRegistry as JaxReg

    reg = MetricsRegistry() if mod is port_spans else JaxReg()
    path = str(tmp_path / f"{tag}.jsonl")
    rec = mod.SpanRecorder(capacity=8, jsonl_path=path, metrics=reg)
    rec.epoch, rec.epoch_wall = 100.0, 1.7e9
    rec.set_trace_id(3, "trace-3")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(12):
            rec.record("step", ("staging", "dispatch", "drain")[i % 3],
                       100.0 + 0.25 * i, 0.125, tenant=i % 4, quantum=i,
                       **({"k": i} if i % 5 == 0 else {}))
    doc = rec.chrome_trace_doc(tenant_names={0: "a", 1: "b"})
    lines = open(path).read()
    rec._sink.close()
    with warnings.catch_warnings(record=True) as caught2:
        warnings.simplefilter("always")
        rec.record("after", "drain", 104.0, 0.5)
        rec.record("after2", "drain", 104.5, 0.5)
    rec.close()
    return (doc, lines, rec.dropped, reg.counter("serve_spans_dropped").value,
            [str(w.message) for w in caught],
            [type(w.message).__name__ for w in caught2],
            [s["name"] for s in rec.spans()][-2:])


def test_span_recorder_matches_jax(tmp_path):
    from gibbs_student_t_tpu.obs import spans as jax_spans

    got = _spans_view(port_spans, tmp_path, "port")
    want = _spans_view(jax_spans, tmp_path, "jax")
    assert got == want
    doc, _, dropped, counted, msgs, sink_warn, tail = got
    # 4 drops of the 12 spans, then 2 more after the sink failed
    assert dropped == counted == 6 and len(msgs) == 1
    assert doc["otherData"]["dropped_spans"] == 4
    assert sink_warn == ["RuntimeWarning"]
    assert tail == ["after", "after2"]


def _monitor_view(mod, rows, spec_kw, backfill_quanta=0):
    """One package's monitor fed ``rows`` (rows, chains, p) a quantum at a
    time (the first ``backfill_quanta`` as one backfill): every snapshot
    after an update, without the wall-clock rate."""
    names = [f"p{i}" for i in range(rows.shape[2])]
    pidx = mod.resolve_params(mod.MonitorSpec(**spec_kw), names)
    blocks = np.array([0, 1, -1, 1])[pidx]
    mon = mod.TenantMonitor(mod.MonitorSpec(**spec_kw), rows.shape[1], pidx,
                            param_names=names, blocks=blocks,
                            block_names=("white", "hyper", "b", "theta", "z",
                                         "alpha", "df"))
    snaps = []
    start = 0
    if backfill_quanta:
        start = backfill_quanta * Q
        mon.backfill(rows[:start], start, updates=backfill_quanta)
    for s in range(start, rows.shape[0], Q):
        mon.update(rows[s:s + Q], s + Q)
        snap = mon.snapshot()
        snap.pop("ess_per_s")
        snaps.append(snap)
    return snaps, mon.converged_at, mon.block_ess()


def _close(a, b, path="$"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert isinstance(b, float) and abs(a - b) <= 1e-12 * max(
            1.0, abs(a)), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("spec_kw,backfill", [
    (dict(params=[0, 1, 3], ess_target=300.0, rhat_target=1.2), 0),
    (dict(params=["p3", 1], rhat_target=1.05, every=2), 0),
    (dict(ess_target=120.0, min_rows=12), 2),
], ids=["targets", "every2", "backfill"])
def test_monitor_matches_jax(spec_kw, backfill):
    from gibbs_student_t_tpu.serve import monitor as jax_monitor

    rng = np.random.default_rng(11)
    # AR(1) chains with a drifting start, so R-hat and ESS move with rows
    rows = np.empty((60, 12, 4), np.float32)
    x = rng.standard_normal((12, 4)) * 3.0
    for i in range(60):
        x = 0.6 * x + rng.standard_normal((12, 4))
        rows[i] = x
    got = _monitor_view(port_monitor, rows, spec_kw, backfill)
    want = _monitor_view(jax_monitor, rows, spec_kw, backfill)
    _close(got, want)
    snaps = got[0]
    if "ess_target" in spec_kw:
        assert got[1] is not None and snaps[-1]["est_sweeps_to_target"] == 0


def test_monitor_spec_checks_match_jax():
    from gibbs_student_t_tpu.serve import monitor as jax_monitor

    def verdicts(mod):
        out = []
        for kw in (dict(every=0), dict(min_rows=3), {}):
            try:
                mod.MonitorSpec(**kw)
                out.append(None)
            except ValueError as e:
                out.append(str(e))
        for params in (["nope"], [7], ["b", 0], None, []):
            try:
                out.append(list(mod.resolve_params(
                    mod.MonitorSpec(params=params), ["a", "b"])))
            except ValueError as e:
                out.append(str(e))
        return out

    assert verdicts(port_monitor) == verdicts(jax_monitor)
    # recycled rows: the same weighted moments and count as the JAX monitor
    rows = np.random.default_rng(0).normal(size=(5, 2, 2))
    mons = [mod.TenantMonitor(mod.MonitorSpec(), 2, np.arange(2))
            for mod in (port_monitor, jax_monitor)]
    for mon in mons:
        mon.update(rows, 5, recycled=2)
    assert mons[0].snapshot()["recycled_rows"] == 2
    assert mons[1].snapshot()["recycled_rows"] == 2
    for a in ("_w_n", "_w_mean", "_w_m2"):
        np.testing.assert_allclose(getattr(mons[0], a), getattr(mons[1], a),
                                   rtol=1e-12, err_msg=a)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _stream_stall(wd, clock, tick):
    """Quanta of ~0.1 s walls with a dispatch beat each, until the
    dispatch stops beating at tick 30."""
    if tick < 30:
        wd.beat("dispatch")
        wd.note_quantum(100.0 + tick % 7, sweeps_per_s=1000.0, backlog=0)


def _stream_backlog(wd, clock, tick):
    wd.beat("dispatch")
    wd.note_quantum(100.0, sweeps_per_s=1000.0,
                    backlog=max(0, tick - 20) // 2)


def _stream_collapse(wd, clock, tick):
    wd.beat("dispatch")
    wd.note_quantum(100.0, sweeps_per_s=1000.0 if tick < 25 else 300.0,
                    backlog=tick % 2)


def _stream_clean(wd, clock, tick):
    rng = np.random.default_rng(tick)
    wd.beat("dispatch")
    wd.beat("drain")
    wd.note_quantum(100.0 * rng.uniform(0.5, 1.5),
                    sweeps_per_s=1000.0 * rng.uniform(0.5, 1.5),
                    backlog=int(rng.integers(0, 3)))


STREAMS = {"dispatch_stall": _stream_stall, "drain_backlog": _stream_backlog,
           "throughput_collapse": _stream_collapse, None: _stream_clean}


def _watchdog_view(mod, stream, monkeypatch):
    """One package's watchdog over ``stream`` under a fake clock (a tick
    of 0.25 s): the tick it tripped at and the trip, and the snapshots
    along the way."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    trips = []
    wd = mod.Watchdog(policy="warn", spec=mod.WatchdogSpec(),
                      active_fn=lambda: True, on_trip=trips.append)
    tripped_at, snaps = None, []
    for tick in range(200):
        clock.t += 0.25
        stream(wd, clock, tick)
        trip = wd.check()
        snaps.append(wd.snapshot())
        if trip is not None and tripped_at is None:
            tripped_at = tick
    return tripped_at, wd.trip, trips, snaps


@pytest.mark.parametrize("cause", list(STREAMS),
                         ids=[c or "clean_noisy" for c in STREAMS])
def test_watchdog_matches_jax(cause, monkeypatch):
    from gibbs_student_t_tpu.obs import watchdog as jax_watchdog

    got = _watchdog_view(port_watchdog, STREAMS[cause], monkeypatch)
    want = _watchdog_view(jax_watchdog, STREAMS[cause], monkeypatch)
    assert got == want
    tripped_at, trip, trips, _ = got
    if cause is None:
        assert tripped_at is None and trip is None and not trips
    else:
        assert trip["cause"] == cause and trips == [trip]


def test_watchdog_env_and_spec_checks(monkeypatch):
    from gibbs_student_t_tpu.obs import watchdog as jax_watchdog

    for value in ("auto", "0", "warn", "dump", "fail", None):
        if value is None:
            monkeypatch.delenv("GST_SERVE_WATCHDOG", raising=False)
        else:
            monkeypatch.setenv("GST_SERVE_WATCHDOG", value)
        assert port_watchdog.serve_watchdog_env() == (value or "auto")
    monkeypatch.setenv("GST_SERVE_WATCHDOG", "dumb")
    with pytest.raises(ValueError, match="'dumb'") as got:
        port_watchdog.serve_watchdog_env()
    with pytest.raises(ValueError) as want:
        jax_watchdog.serve_watchdog_env()
    assert str(got.value) == str(want.value)

    def verdicts(mod):
        out = []
        for kw in (dict(deadline_factor=0), dict(tick_s=-1),
                   dict(backlog_quanta=1), dict(collapse_drop=1.0), {}):
            try:
                mod.WatchdogSpec(**kw)
                out.append(None)
            except ValueError as e:
                out.append(str(e))
        return out

    assert verdicts(port_watchdog) == verdicts(jax_watchdog)


def _flight_view(mod, tmp_path, tag, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    sync = str(tmp_path / tag / "flight.json")
    rec = mod.FlightRecorder(
        capacity=4, events_capacity=5, sync_path=sync, sync_every=3,
        span_tail=2, context_fn=lambda: {"quantum_idx": 7, "x": [1, 2]},
        spans_fn=lambda: [{"name": f"s{i}"} for i in range(5)])
    for q in range(6):
        clock.t += 0.5
        rec.beat("dispatch")
        rec.note_quantum({"q": q, "dispatch_ms": 10.0 + q,
                          "busy_lanes": np.int64(16), "queue_depth": 1})
        rec.note_event("admit", tenant=q, lane0=16 * q)
    clock.t += 1.0
    rec.beat("drain")
    path = rec.dump(str(tmp_path / tag / "pm.json"), reason="test")
    broken = mod.FlightRecorder(context_fn=lambda: 1 / 0,
                                spans_fn=lambda: 1 / 0)
    return (rec.bundle("mem"), json.load(open(path)), json.load(open(sync)),
            mod.read_bundle(path)["reason"], broken.bundle("b"))


def test_flight_recorder_matches_jax(tmp_path, monkeypatch):
    from gibbs_student_t_tpu.obs import flight as jax_flight

    got = _flight_view(port_flight, tmp_path, "port", monkeypatch)
    want = _flight_view(jax_flight, tmp_path, "jax", monkeypatch)
    assert got == want
    mem, disk, sync, _, broken = got
    assert mem["quanta_recorded"] == 6 and mem["quanta_dropped"] == 2
    assert disk["spans"] == [{"name": "s3"}, {"name": "s4"}]
    assert sync["reason"] == "sync" and "spans" not in sync
    assert "context_error" in broken and "spans_error" in broken


def test_prometheus_text_matches_jax(tmp_path):
    from gibbs_student_t_tpu.obs import export as jax_export

    reg = MetricsRegistry()
    reg.counter("serve_admissions").inc(3)
    reg.gauge("serve_queue_depth").set(2)
    for v in (0.5, 2.0, 30.0):
        reg.histogram("serve_admission_ms").observe(v)
    snap = reg.snapshot()
    labels = {"pool": 'a"b\\c\nd'}
    for kw in ({}, {"ts_ms": 123, "labels": labels}):
        assert (port_export.prometheus_text(snap, **kw)
                == jax_export.prometheus_text(snap, **kw))
    bad = str(tmp_path / "missing" / "metrics.prom")
    with pytest.warns(RuntimeWarning, match="exposition write"):
        assert port_export.write_prometheus(reg, bad) is None
    assert port_export.write_prometheus(reg, bad) is None   # warned once


def test_schema_validator_matches_jax(plane_run, schemas):
    """Both validators give the same verdicts on the same records, with
    either package's schema table; the port's table differs from the
    reference's only in the run manifest's versions, the ledger record's
    ``xla`` and its comment, and adds the named ``cuda_summary`` that
    takes ``xla``'s place."""
    from gibbs_student_t_tpu.obs import schema as jax_schema

    ref = jax_schema.load_schemas()
    assert sorted(schemas) == sorted([*ref, "cuda_summary"])
    differ = {k for k in ref if ref[k] != schemas[k]}
    assert differ == {"_comment", "manifest", "ledger_record"}
    assert "torch_version" in schemas["manifest"]["required"]
    assert "xla" not in schemas["ledger_record"]["required"]
    docs = [("serve_status", plane_run["status"]),
            ("healthz", plane_run["healthz"]),
            ("postmortem", json.load(open(plane_run["pm_path"]))),
            ("cost", {"device_ms": "x", "lane_quanta": 1.5}),
            ("healthz", {"ok": 1}),
            ("watchdog", {"enabled": True, "state": "bad", "trip": None}),
            ("manifest", json.load(open(os.path.join(
                plane_run["run_dir"], "manifest.json"))))]
    for table in (schemas, ref):
        for name, doc in docs:
            doc = json.loads(json.dumps(doc, default=float))
            assert (port_schema.validate(doc, table[name], defs=table)
                    == jax_schema.validate(doc, table[name], defs=table))


# --- the shared run -----------------------------------------------------------

def test_progress_matches_posthoc_diagnostics(plane_run):
    for h, res, niter in zip(plane_run["handles"], plane_run["results"],
                             NITERS):
        p = h.progress()
        assert p["status"] == "done" and p["rows"] == niter
        window = np.asarray(res.chain)[:, :, MON_PARAMS]
        ess_ref = ess_per_param(window)
        rhat_ref = split_rhat_per_param(window)
        np.testing.assert_allclose(np.asarray(p["ess"], float), ess_ref,
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(p["rhat"], float), rhat_ref,
                                   rtol=1e-6)
        assert p["ess_per_s"] > 0 and p["converged_at"] is not None
        assert res.stats["converged_at"] == p["converged_at"]
        assert res.stats["monitor"]["ess_min"] == p["ess_min"]
        assert h.converged_at == p["converged_at"]
    assert plane_run["summary"]["slo"]["n_converged"] == 4
    assert plane_run["summary"]["converged_evictions"] == 0


def test_export_trace_is_valid_and_complete(plane_run, schemas):
    doc = json.load(open(plane_run["trace"]))
    _valid(doc, "chrome_trace", schemas, "trace")
    per = {}
    staged = set()
    for e in doc["traceEvents"]:
        if e["ph"] != "X" or e["pid"] == 0:
            continue
        tid = e["pid"] - 1
        if e["cat"] == "staging":
            staged.add(tid)
        q = e["args"].get("quantum")
        if q is not None and e["name"] in ("quantum", "drain"):
            per.setdefault(tid, {}).setdefault(q, set()).add(e["cat"])
    assert staged == {0, 1, 2, 3}
    for t, niter in enumerate(NITERS):
        assert len(per[t]) == niter // Q
        assert all(v == {"dispatch", "drain"} for v in per[t].values())
    names = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names[1] == "tenant t0"


def test_records_validate_against_port_schema(plane_run, schemas):
    _valid(plane_run["status"], "serve_status", schemas, "status")
    _valid(plane_run["live"]["status"], "serve_status", schemas, "live")
    assert plane_run["live"]["status"]["tenants"]
    for hz in (plane_run["healthz"], plane_run["live"]["healthz"]):
        _valid(hz, "healthz", schemas, "healthz")
        assert hz["ok"] is True and hz["watchdog"]["state"] == "ok"
    obs = plane_run["obs_dir"]
    _valid(json.load(open(os.path.join(obs, "status.json"))),
           "serve_status", schemas, "status.json")
    for line in open(os.path.join(obs, "spans.jsonl")):
        _valid(json.loads(line), "span", schemas, "span line")
    events = read_events(plane_run["run_dir"])
    assert {"admit", "evict", "tenant_converged"} <= {
        e["event"] for e in events}
    for e in events:
        _valid(e, "event", schemas, "event")
    _valid(json.load(open(os.path.join(plane_run["run_dir"],
                                       "manifest.json"))),
           "manifest", schemas, "metrics manifest")
    for r in read_manifest(plane_run["man_dir"]):
        _valid(r, "serve_manifest_record", schemas, "manifest record")
    pm = json.load(open(plane_run["pm_path"]))
    _valid(pm, "postmortem", schemas, "postmortem")
    assert pm["reason"] == "fixture" and pm["quanta"] and pm["spans"]
    assert {"admit", "evict"} <= {e["kind"] for e in pm["events"]}
    fj = json.load(open(os.path.join(obs, "flight.json")))
    _valid(fj, "postmortem", schemas, "flight.json")
    assert fj["reason"] == "sync" and "spans" not in fj
    prom = open(os.path.join(obs, "metrics.prom")).read()
    assert "# TYPE gst_serve_admissions counter" in prom
    assert "gst_serve_converged_ms_count" in prom
    for h in plane_run["handles"]:
        _valid(h.cost(), "cost", schemas, "cost")
    _valid(plane_run["summary"]["watchdog"], "watchdog", schemas, "watchdog")


def test_cost_reconciles_with_dispatch_wall(plane_run):
    wall = plane_run["summary"]["cost"]["dispatch_wall_ms"]
    total = sum(h.cost()["device_ms"] for h in plane_run["handles"])
    assert wall > 0 and abs(total - wall) <= 1e-9 * wall
    for h, res, niter in zip(plane_run["handles"], plane_run["results"],
                             NITERS):
        c = h.cost()
        assert c["lane_quanta"] == 16 * (niter // Q)
        assert c["ess_per_core_s"] > 0
        assert res.stats["cost"] == c == h.progress()["cost"]


#: keys only the JAX server reports: its wire; by path, none
JAX_ONLY = {"http"}
JAX_ONLY_PATHS = set()
#: keys only the port reports: host ms of the launch loop and the plane
PORT_ONLY = {("host_ms", "dispatch"), ("host_ms", "monitor"),
             ("host_ms", "obs_refresh")}


def _tree(v, drop=(), drop_paths=(), path=()):
    """The key tree of a record: dicts by key (less the dropped keys, and
    the dropped ``(parent, key)`` pairs; ``(key,)`` at the top), a list
    by its first element, every other value a leaf."""
    if isinstance(v, dict):
        return {k: _tree(x, drop, drop_paths, path + (k,))
                for k, x in v.items()
                if k not in drop and path[-1:] + (k,) not in drop_paths}
    if isinstance(v, list):
        return [_tree(v[0], drop, drop_paths, path)] if v else []
    return "leaf"


def _records(run):
    h = run["handles"][0]
    return {"status": run["live"]["status"], "summary": run["summary"],
            "healthz": run["healthz"], "cost": h.cost(),
            "progress": h.progress(),
            "postmortem": json.load(open(run["pm_path"]))}


@pytest.mark.parametrize("record", ["status", "summary", "healthz", "cost",
                                    "progress", "postmortem"])
def test_record_key_trees_match_jax(plane_run, jax_run, record):
    got = _tree(_records(plane_run)[record], drop_paths=PORT_ONLY)
    want = _tree(_records(jax_run)[record], drop=JAX_ONLY,
                 drop_paths=JAX_ONLY_PATHS)
    assert got == want


# --- contracts -----------------------------------------------------------------

@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_plane_on_off_bitwise(demo, refs, plane_run, pipeline, tmp_path):
    """The whole plane on (monitors, spans, obs_dir, flight, watchdog) and
    off give bitwise the same tenants and the same quanta."""
    results = {}
    quanta = {}
    for on in (True, False):
        kw = (dict(obs_dir=str(tmp_path / "obs")) if on
              else dict(spans=False, flight=False, watchdog=False))
        srv = _server(demo, pipeline, **kw)
        spec = MonitorSpec(params=MON_PARAMS) if on else None
        hs = [srv.submit(r) for r in _plane_set(demo[0], TenantRequest,
                                                spec)]
        try:
            _drive(srv)
        finally:
            srv.close()
        results[on] = [h.result(timeout=0) for h in hs]
        quanta[on] = srv.quanta
        if on:
            assert srv.summary()["watchdog"]["state"] == "ok"
    for a, b, ref in zip(results[True], results[False], refs):
        _bitwise(a, b)
        _bitwise(a, ref)
    for a, ref in zip(plane_run["results"], refs):
        _bitwise(a, ref)
    if not pipeline:
        assert quanta[True] == quanta[False]


def test_observability_failures_warn_and_continue(demo, refs, tmp_path,
                                                  monkeypatch):
    """A span sink IO error, a raising monitor and a failing obs_dir
    refresh in one run: every tenant finishes ``done``, bitwise, with its
    monitor detached; no fault is counted."""
    def boom(self, *a, **k):
        raise RuntimeError("injected monitor failure")

    monkeypatch.setattr(port_monitor.TenantMonitor, "update", boom)
    obs_dir = str(tmp_path / "obs")
    srv = _server(demo, True, obs_dir=obs_dir,
                  trace_jsonl=str(tmp_path / "spans.jsonl"))
    srv.spans._sink.close()
    os.rmdir(obs_dir)
    with open(obs_dir, "w") as fh:   # a file where the directory was
        fh.write("not a directory")
    reqs = _plane_set(demo[0], TenantRequest, MonitorSpec(params=[0]))[:2]
    with pytest.warns(RuntimeWarning) as caught:
        hs = [srv.submit(r) for r in reqs]
        try:
            _drive(srv)
        finally:
            srv.close()
    text = " ".join(str(w.message) for w in caught)
    assert "sink" in text and "monitor failed" in text
    assert "obs_dir refresh failed" in text
    for h, ref in zip(hs, refs):
        assert h.status == "done" and h._monitor is None
        res = h.result(timeout=0)
        _bitwise(res, ref)
        assert "converged_at" not in res.stats
    s = srv.summary()
    assert s["faults"]["tenant_failures"] == 0
    assert s["faults"]["pool_failures"] == 0


@pytest.mark.chaos
@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_dispatch_stall_trips_watchdog(demo, refs, schemas, pipeline,
                                       tmp_path):
    """A 2 s sleep before the second dispatch, under a watchdog whose
    deadline is the median quantum wall (at least 0.2 s; a quantum of this
    pool takes well under 1 s on a loaded CPU): ``healthz()``, polled from
    a thread, reports the trip with cause ``dispatch_stall`` during the
    stall; the postmortem is on disk and valid; the two tenants are
    bitwise their uninjected runs."""
    from gibbs_student_t_tpu_torch.obs import WatchdogSpec

    srv = _server(demo, pipeline, flight_dir=str(tmp_path),
                  watchdog_spec=WatchdogSpec(min_deadline_s=0.2,
                                             deadline_factor=1.0,
                                             tick_s=0.02))
    seen, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            hz = srv.healthz()
            if hz["watchdog"]["trip"] is not None and not seen:
                seen.append((hz, srv.quanta))
            time.sleep(0.01)

    th = threading.Thread(target=poll, daemon=True)
    reqs = _plane_set(demo[0], TenantRequest, None)[:2]
    with faults.inject(faults.FaultSpec("dispatch_stall", after=1,
                                        action="sleep", seconds=2.0)):
        hs = [srv.submit(r) for r in reqs]
        th.start()
        with pytest.warns(RuntimeWarning, match="dispatch_stall"):
            try:
                _drive(srv)
            finally:
                stop.set()
                th.join(5.0)
                srv.close()
        assert faults.fired_counts() == {("dispatch_stall", None): 1}
    assert seen, "healthz never reported the trip"
    hz, quanta = seen[0]
    assert quanta == 1 and hz["ok"] is False
    assert hz["watchdog"]["trip"]["cause"] == "dispatch_stall"
    assert hz["error"] == "watchdog trip: dispatch_stall"
    _valid(hz, "healthz", schemas, "stalled healthz")
    pm = json.load(open(tmp_path / "postmortem.json"))
    _valid(pm, "postmortem", schemas, "stall postmortem")
    assert pm["reason"] == "watchdog:dispatch_stall"
    assert "watchdog_trip" in {e["kind"] for e in pm["events"]}
    for h, ref in zip(hs, refs):
        _bitwise(h.result(timeout=0), ref)


@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_converged_eviction_backfills(demo, refs, pipeline):
    """t0 (a budget of 30 here) with ``on_converged="evict"`` and a target
    its rows reach at sweep 10: it ends ``done`` with a bitwise prefix of
    its uninterrupted run (the pipelined executor may serve the quanta
    already dispatched), a queued tenant takes its groups at that
    boundary, and ``converged_evictions`` is 1; the other tenants are
    bitwise."""
    srv = _server(demo, False, spans=False, flight=False, watchdog=False)
    long_req = TenantRequest(ma=demo[0], niter=30, nchains=16, seed=0)
    h_ref = srv.submit(long_req)
    try:
        _drive(srv)
    finally:
        srv.close()
    ref0 = h_ref.result(timeout=0)
    window = np.asarray(ref0.chain)[:, :, MON_PARAMS]
    ess = [float(ess_per_param(window[:k]).min()) for k in (5, 10)]
    assert ess[1] > ess[0]
    srv = _server(demo, pipeline)
    reqs = _plane_set(demo[0], TenantRequest, None)
    reqs[0].niter = 30
    reqs[0].monitor = MonitorSpec(params=MON_PARAMS, ess_target=ess[1],
                                  min_rows=4)
    reqs[0].on_converged = "evict"
    hs = [srv.submit(r) for r in reqs]
    try:
        _drive(srv)
        spans = srv.spans.spans()
        events = srv.flight.bundle("t")["events"]
        summ = srv.summary()
    finally:
        srv.close()
    h = hs[0]
    res = h.result(timeout=0)
    assert h.status == "done" and h.converged_at == 10
    rows = res.chain.shape[0]
    assert 10 <= rows <= 20 and (pipeline or rows == 10)
    _bitwise(res, ref0, rows=rows)
    assert summ["converged_evictions"] == 1
    assert "evict_converged" in {e["kind"] for e in events}
    last_q = max(s["quantum"] for s in spans
                 if s["name"] == "quantum" and s["tenant"] == h.tenant_id)
    lane0 = {e["tenant"]: e["lane0"] for e in events if e["kind"] == "admit"}
    backfilled = [s["tenant"] for s in spans if s["name"] == "admit"
                  and s["quantum"] == last_q + 1
                  and lane0[s["tenant"]] == lane0[h.tenant_id]]
    assert backfilled
    for hh, ref in zip(hs[1:], refs[1:]):
        _bitwise(hh.result(timeout=0), ref)


def _monitor_keys(p):
    return {k: p[k] for k in ("rows", "sweeps", "params", "ess", "ess_min",
                              "rhat", "rhat_max", "est_sweeps_to_target",
                              "converged_at", "blocks")}


def test_preempted_monitored_progress_equals_uninterrupted(demo, tmp_path):
    """A spooled, monitored batch tenant preempted by an interactive one,
    requeued and finished: its final ``progress()`` is its uninterrupted
    run's (the backfill folds its spooled rows exactly once), and its rows
    are bitwise."""
    ma = demo[0]
    spec = MonitorSpec(params=MON_PARAMS, ess_target=1e9)

    def victim(tag):
        return TenantRequest(ma=ma, niter=30, nchains=32, seed=7, name="v",
                             priority=2, monitor=spec,
                             spool_dir=str(tmp_path / tag))

    srv = _server(demo, False)
    hv = srv.submit(victim("ref"))
    try:
        _drive(srv)
    finally:
        srv.close()
    want = hv.progress()
    srv = _server(demo, False, scheduler="priority")
    h = srv.submit(victim("pre"))
    hi = []

    def on_quantum(s):
        if s.quanta == 2 and not hi:
            hi.append(s.submit(TenantRequest(ma=ma, niter=10, nchains=32,
                                              seed=9, priority=0)))

    try:
        _drive(srv, on_quantum)
    finally:
        srv.close()
    assert h.preemptions == 1 and 0 < h.request.start_sweep < 30
    got = h.progress()
    _close(_monitor_keys(got), _monitor_keys(want))
    assert abs(got["within_chain_std_mean"]
               - want["within_chain_std_mean"]) <= 1e-12
    _bitwise(h.result(timeout=0), hv.result(timeout=0))


def test_recover_rearms_monitor(demo, tmp_path):
    """An abandoned server's spooled, monitored tenant (two quanta served)
    is recovered with its journaled monitor and ``on_converged``, the
    monitor backfilled from the spool: its final ``progress()`` and rows
    equal the uninterrupted run's."""
    ma = demo[0]
    spec = MonitorSpec(params=MON_PARAMS, ess_target=1e9, every=2)

    def req(tag):
        return TenantRequest(ma=ma, niter=30, nchains=16, seed=5, name="S",
                             monitor=spec, on_converged="evict",
                             spool_dir=str(tmp_path / tag))

    srv = _server(demo, False)
    hu = srv.submit(req("ref"))
    try:
        _drive(srv)
    finally:
        srv.close()
    man = str(tmp_path / "manifest")
    srv = _server(demo, False, manifest_dir=man)
    srv.submit(req("S"))
    for _ in range(2):
        srv.step()
    del srv     # abandoned: no close, as after a kill
    srv2, handles = ChainServer.recover(man, device="cpu")
    h = handles["S"]
    try:
        assert h.request.start_sweep == 10
        assert h.request.monitor == spec
        assert h.request.on_converged == "evict"
        _drive(srv2)
    finally:
        srv2.close()
    _close(_monitor_keys(h.progress()), _monitor_keys(hu.progress()))
    _bitwise(h.result(timeout=0), hu.result(timeout=0))


def test_recover_keeps_priority_zero(demo, tmp_path):
    """A recovered priority-0 tenant keeps priority 0. This is a known
    difference from the JAX server, whose ``int(rec.get("priority") or 1)``
    resubmits it at priority 1 (ROADMAP, Queue C)."""
    man = str(tmp_path / "manifest")
    srv = _server(demo, False, manifest_dir=man)
    srv.submit(TenantRequest(ma=demo[0], niter=20, nchains=16, seed=3,
                             name="P", priority=0,
                             spool_dir=str(tmp_path / "P")))
    srv.step()
    del srv
    srv2, handles = ChainServer.recover(man, device="cpu")
    try:
        assert handles["P"].request.priority == 0
        assert handles["P"].progress()["priority"] == 0
        _drive(srv2)
    finally:
        srv2.close()
    assert handles["P"].status == "done"


def test_request_and_server_checks(demo, monkeypatch, tmp_path):
    srv = _server(demo, False, flight=False)
    try:
        with pytest.raises(ValueError, match="MonitorSpec or None"):
            srv.submit(TenantRequest(ma=demo[0], niter=5, monitor=object()))
        with pytest.raises(ValueError, match="on_converged must be one"):
            srv.submit(TenantRequest(ma=demo[0], niter=5,
                                     on_converged="banana"))
        for spec in (None, MonitorSpec(params=[0])):
            with pytest.raises(ValueError, match="armed target"):
                srv.submit(TenantRequest(ma=demo[0], niter=5, monitor=spec,
                                         on_converged="evict"))
        assert TenantRequest(ma=demo[0], niter=5,
                             trace_id="t").trace_id == "t"
        with pytest.raises(ValueError, match="warm_start must be"):
            srv.submit(TenantRequest(ma=demo[0], niter=5,
                                     warm_start=object()))
        quiet = _server(demo, False, spans=False)
        with pytest.raises(ValueError, match="span tracing is disabled"):
            quiet.export_trace(str(tmp_path / "t.json"))
        quiet.close()
        with pytest.raises(ValueError, match="flight recorder is disabled"):
            srv.dump_postmortem()
        with pytest.raises(ValueError, match="watchdog must be"):
            _server(demo, False, watchdog="always")
        monkeypatch.setenv("GST_SERVE_WATCHDOG", "dumb")
        with pytest.raises(ValueError, match="GST_SERVE_WATCHDOG"):
            _server(demo, False)
        monkeypatch.setenv("GST_SERVE_WATCHDOG", "0")
        off = _server(demo, False, flight=False)
        assert off.healthz()["watchdog"]["state"] == "off"
        off.close()
    finally:
        srv.close()


def test_obs_dir_registry_and_exit_hooks(demo, tmp_path):
    """``obs_dir`` without a registry makes one in memory; a server made on
    the main thread installs the SIGTERM dump only over the default
    action, and ``close()`` undoes it and the atexit dump."""
    before = signal.getsignal(signal.SIGTERM)
    srv = _server(demo, False, obs_dir=str(tmp_path / "o"))
    assert srv.metrics is not None
    srv._refresh_obs()
    assert os.path.exists(tmp_path / "o" / "status.json")
    installed = signal.getsignal(signal.SIGTERM)
    if before == signal.SIG_DFL and (threading.current_thread()
                                     is threading.main_thread()):
        assert installed == srv._on_sigterm
    srv.close()
    assert signal.getsignal(signal.SIGTERM) == before
    assert not srv._atexit_registered


def test_postmortem_tool_renders_a_bundle(plane_run):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "postmortem.py"),
         plane_run["pm_path"]], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "timeline" in out.stdout
