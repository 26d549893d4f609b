"""The port's stage timers (``ops/timers.py``) and the server's profiling
plane on the CPU, held against the JAX package's.

- ``STAGE_NAMES`` is the JAX tuple; ``GST_KERNEL_TIMERS`` reads as the
  JAX gate does (a typo raises, ``0`` resolves off);
- the pending event pairs fold in recording order up to the first that is
  not done, give their events back (a boundary two chained pairs share
  once both are folded), and a recording bracket folds once the list
  passes its cap (fake events: the fold's logic without a card);
- ``TorchGibbs`` with the timers on and off gives bit for bit the same
  records, and every one of the eight stages reports one call a sweep;
- ``ChainServer(kernel_timers=True)`` on both executors: every tenant bit
  for bit a ``kernel_timers=False`` server's; ``summary()["stages"]`` and
  ``status()["stages"]`` valid against ``stage_timings`` with the eight
  names, the shares of the dispatch wall at most 1, the tenants'
  ``stage_device_ms`` summing to the totals within 2 % + 0.01 ms (the JAX
  pin, tests/test_serve_obs.py), the flight ring's entries and context,
  ``reset_counters``, ``/status`` over HTTP, and the timers-off server's
  blocks empty; the server's ``kernel_timers`` against the environment
  (``auto`` off) and its hold on the flag, given back at close.

Every server run is driven on a thread of its own with a time limit.
"""

import collections
import json
import threading
import urllib.request

import numpy as np
import pytest

from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.obs import schema as port_schema
from gibbs_student_t_tpu_torch.ops import timers
from gibbs_student_t_tpu_torch.serve import ChainServer, TenantRequest

FIELDS = ("chain", "bchain", "zchain", "poutchain", "thetachain",
          "alphachain", "dfchain")
RUN_TIMEOUT_S = 180.0
Q = 5
EXECUTORS = [False, True]
IDS = ["serial", "pipelined"]


@pytest.fixture(scope="module")
def demo():
    return make_demo_model_arrays(components=5), GibbsConfig(model="mixture")


@pytest.fixture(scope="module")
def schemas():
    return port_schema.load_schemas()


@pytest.fixture(autouse=True)
def _flag_down():
    """Every test starts and ends with the process-global flag down."""
    timers.timers_enable(False)
    yield
    timers.timers_enable(False)


def _bitwise(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for k in ("acc_white", "acc_hyper"):
        np.testing.assert_array_equal(got.stats[k], want.stats[k], err_msg=k)


def _valid(doc, name, schemas, label):
    port_schema.assert_valid(json.loads(json.dumps(doc, default=float)),
                             schemas[name], label, defs=schemas)


def _drive(srv):
    box = []

    def target():
        try:
            srv.run()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(RUN_TIMEOUT_S)
    assert not th.is_alive(), "the server's run did not end in time"
    if box:
        raise box[0]


# --- the module against the JAX timer surface ---------------------------

def test_stage_names_are_the_jax_enum():
    from gibbs_student_t_tpu.native import ffi as nffi

    assert timers.STAGE_NAMES == nffi.STAGE_NAMES


@pytest.mark.parametrize("value", [None, "auto", "1", "0", "yes", "on"])
def test_kernel_timers_env_matches_jax(monkeypatch, value):
    from gibbs_student_t_tpu.native import ffi as nffi

    if value is None:
        monkeypatch.delenv("GST_KERNEL_TIMERS", raising=False)
    else:
        monkeypatch.setenv("GST_KERNEL_TIMERS", value)
    if value in (None, "auto", "1", "0"):
        assert timers.kernel_timers_env() == nffi.kernel_timers_env()
        if value == "0":
            assert nffi.timers_resolved_on() is False
    else:
        for fn in (timers.kernel_timers_env, nffi.kernel_timers_env):
            with pytest.raises(ValueError, match="GST_KERNEL_TIMERS"):
                fn()


class _FakeEvent:
    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.t - self.t


def test_pending_pairs_fold_in_order(monkeypatch):
    """The fold takes the done pairs in recording order, stops at the first
    that is not done, never waits, and gives the folded events back to
    the device's pool; a delta leaves out stages with no new calls."""
    monkeypatch.setattr(timers, "_pending", collections.deque())
    monkeypatch.setattr(timers, "_free", {})
    timers.timers_reset()
    i = timers.STAGE_NAMES.index
    late = _FakeEvent(9.0, done=False)
    timers._pending.extend([
        [i("draws"), 0, _FakeEvent(0.0), _FakeEvent(1.5), False, False],
        [i("schur"), 0, _FakeEvent(2.0), _FakeEvent(2.25), False, False],
        [i("draws"), 0, _FakeEvent(3.0), late, False, False],
        [i("resid"), 0, _FakeEvent(4.0), _FakeEvent(5.0), False, False]])
    s0 = timers.timers_snapshot()
    assert s0["draws"] == {"ms": 1.5, "calls": 1}
    assert s0["schur"] == {"ms": 0.25, "calls": 1}
    assert s0["resid"] == {"ms": 0.0, "calls": 0}
    assert len(timers._pending) == 2 and len(timers._free[0]) == 4
    late.done = True
    s1 = timers.timers_snapshot()
    assert not timers._pending
    assert timers.timers_delta_ms(s0, s1) == {
        "resid": {"ms": 1.0, "calls": 1}, "draws": {"ms": 6.0, "calls": 1}}
    assert timers.timers_delta_ms(s1, timers.timers_snapshot()) == {}
    timers.timers_reset()
    assert all(v == {"ms": 0.0, "calls": 0}
               for v in timers.timers_snapshot().values())


def test_recording_bracket_folds_past_the_cap(monkeypatch):
    """With nobody reading, the pending list stays bounded: a bracket that
    finds it past the cap folds what is done."""
    monkeypatch.setattr(timers, "_pending", collections.deque())
    monkeypatch.setattr(timers, "_free", {})
    monkeypatch.setattr(timers, "PENDING_CAP", 4)
    timers.timers_reset()
    for k in range(6):
        with timers._lock:
            timers._pending.append(
                [0, 0, _FakeEvent(k), _FakeEvent(k + 1), False, False])
            if len(timers._pending) > timers.PENDING_CAP:
                timers._fold_locked()
    assert len(timers._pending) <= timers.PENDING_CAP
    assert timers.timers_snapshot()["schur"]["calls"] == 6
    timers.timers_reset()


def test_chained_pairs_share_their_boundary(monkeypatch):
    """A chain of brackets, each starting at the last one's end: every
    stage gets its own ms, and a shared boundary event goes back to the
    pool only once both pairs that use it are folded."""
    monkeypatch.setattr(timers, "_pending", collections.deque())
    monkeypatch.setattr(timers, "_free", {})
    timers.timers_reset()
    i = timers.STAGE_NAMES.index
    e = [_FakeEvent(t) for t in (0.0, 1.0, 3.0, 6.0)]
    e[3].done = False
    timers._pending.extend([
        [i("white_mh"), 0, e[0], e[1], True, False],
        [i("tnt"), 0, e[1], e[2], True, False],
        [i("schur"), 0, e[2], e[3], False, False]])
    snap = timers.timers_snapshot()
    assert (snap["white_mh"]["ms"], snap["tnt"]["ms"]) == (1.0, 2.0)
    # e[2] is the start of the pair still pending: not free yet
    assert timers._free[0] == [e[0], e[1]]
    e[3].done = True
    assert timers.timers_snapshot()["schur"]["ms"] == 3.0
    assert timers._free[0] == [e[0], e[1], e[2], e[3]]
    timers.timers_reset()


def test_flag_down_is_a_null_context():
    import torch

    assert timers.stage("schur", torch.device("cpu")) is timers._NULL
    timers.timers_enable(True)
    assert isinstance(timers.stage("schur", torch.device("cpu")),
                      timers._HostBracket)
    with timers.stage("white_mh", torch.device("cpu")) as b:
        pass
    assert isinstance(timers.stage("tnt", torch.device("cpu"), follows=b),
                      timers._HostBracket)
    with pytest.raises(KeyError):
        timers.stage("nope", torch.device("cpu"))


# --- the sampler -----------------------------------------------------------

def test_torchgibbs_on_off_bitwise_with_every_stage(demo):
    ma, cfg = demo
    res = {}
    for on in (False, True, False):
        timers.timers_enable(on)
        s0 = timers.timers_snapshot()
        smp = TorchGibbs(ma, cfg, nchains=6, device="cpu", record="full",
                         chunk_size=5)
        res[on] = smp.sample(niter=10, seed=4)
        delta = timers.timers_delta_ms(s0, timers.timers_snapshot())
        if on:
            assert set(delta) == set(timers.STAGE_NAMES)
            assert all(v["calls"] == 10 and v["ms"] > 0
                       for v in delta.values()), delta
        else:
            assert delta == {}
    _bitwise(res[True], res[False])


# --- the server ------------------------------------------------------------

def _server(demo, pipeline, **kw):
    ma, cfg = demo
    return ChainServer(ma, cfg, nlanes=32, quantum=Q, record="full",
                       device="cpu", pipeline=pipeline, spans=False,
                       watchdog=False, **kw)


def _tenants(ma):
    return [TenantRequest(ma=ma, niter=n, nchains=16, seed=20 + i,
                          name=f"t{i}") for i, n in enumerate((10, 15, 5))]


@pytest.fixture(scope="module", params=EXECUTORS, ids=IDS)
def served(request, demo):
    """The tenant set on one executor with the stage timers on (read live
    over HTTP after the run) and off."""
    out = {}
    for on in (True, False):
        timers.timers_enable(False)
        srv = _server(demo, request.param, kernel_timers=on,
                      http_port=0 if on else None)
        hs = [srv.submit(r) for r in _tenants(demo[0])]
        try:
            _drive(srv)
            run = {"summary": srv.summary(), "status": srv.status(),
                   "pm": srv.flight.bundle("fixture"),
                   "costs": [h.cost() for h in hs], "server": srv}
            if on:
                url = f"http://127.0.0.1:{srv.http.port}/status"
                with urllib.request.urlopen(url, timeout=30) as r:
                    run["http_status"] = json.loads(r.read())
                srv.reset_counters()
                run["after_reset"] = (srv.summary()["stages"],
                                      srv.status()["stages"])
        finally:
            srv.close()
        run["results"] = [h.result(timeout=0) for h in hs]
        out[on] = run
    timers.timers_enable(False)
    return out


def test_server_records_bitwise_timers_on_and_off(served):
    for a, b in zip(served[True]["results"], served[False]["results"]):
        _bitwise(a, b)
    assert served[True]["server"].kernel_timers is True
    assert served[False]["server"].kernel_timers is False


def test_server_stages_block(served, schemas):
    on = served[True]
    for block in (on["summary"]["stages"], on["status"]["stages"],
                  on["http_status"]["stages"]):
        _valid(block, "stage_timings", schemas, "stages")
        assert set(block) == set(timers.STAGE_NAMES)
    _valid(on["status"], "serve_status", schemas, "status")
    _valid(on["http_status"], "serve_status", schemas, "/status")
    stages = on["summary"]["stages"]
    share = sum(v["share_of_dispatch"] for v in stages.values())
    assert 0.0 < share <= 1.0, share
    assert all(v["device_ms"] > 0 and v["ms_per_quantum"] > 0
               for v in stages.values())
    assert on["after_reset"] == (None, None)
    off = served[False]
    assert off["summary"]["stages"] is None and off["status"]["stages"] is None


def test_tenant_stage_costs_reconcile(served, schemas):
    """Per-tenant shares sum to the server's totals stage by stage (the
    JAX pin: 2 % + 0.01 ms)."""
    stages = served[True]["summary"]["stages"]
    per_tenant = {}
    for c in served[True]["costs"]:
        _valid(c, "cost", schemas, "cost")
        for k, v in c["stage_device_ms"].items():
            per_tenant[k] = per_tenant.get(k, 0.0) + v
    assert set(per_tenant) == set(stages)
    for k, v in stages.items():
        assert abs(per_tenant[k] - v["device_ms"]) \
            <= 0.02 * v["device_ms"] + 0.01, (k, per_tenant[k], v)
    assert all("stage_device_ms" not in c for c in served[False]["costs"])


def test_flight_ring_carries_stages(served, schemas):
    pm = served[True]["pm"]
    _valid(pm, "postmortem", schemas, "postmortem")
    assert pm["kernel_timers"] is True
    assert set(pm["stage_totals_ms"]) == set(timers.STAGE_NAMES)
    assert pm["quanta"] and all(
        set(q["stage_device_ms"]) <= set(timers.STAGE_NAMES)
        and q["stage_device_ms"] for q in pm["quanta"])
    totals = {k: sum((q["stage_device_ms"] or {}).get(k, 0.0)
                     for q in pm["quanta"]) for k in timers.STAGE_NAMES}
    for k, v in pm["stage_totals_ms"].items():
        assert abs(totals[k] - v) <= 0.02 * v + 0.01, (k, totals[k], v)
    off = served[False]["pm"]
    assert off["kernel_timers"] is False and off["stage_totals_ms"] is None
    assert all(q["stage_device_ms"] is None for q in off["quanta"])


@pytest.mark.parametrize("env,arg,want", [
    (None, "auto", False), (None, True, True), (None, False, False),
    ("0", True, False), ("1", False, True), ("auto", False, False),
    ("auto", True, True)])
def test_server_kernel_timers_follow_the_environment(demo, monkeypatch, env,
                                                     arg, want):
    """``auto`` resolves to off (a bracket costs the host microseconds
    here); a server that wants the timers holds the flag until it
    closes."""
    if env is None:
        monkeypatch.delenv("GST_KERNEL_TIMERS", raising=False)
    else:
        monkeypatch.setenv("GST_KERNEL_TIMERS", env)
    srv = _server(demo, False, kernel_timers=arg, flight=False)
    try:
        assert srv.kernel_timers is want
        assert timers._on is want
    finally:
        srv.close()
    assert timers._on is False
    srv.close()                   # a second close gives back nothing more
    assert timers._holds == 0


def test_servers_hold_the_flag_by_count(demo, monkeypatch):
    """A timers-off server leaves a live one's flag up; the flag falls
    with the last holder's close, or when a holder is collected
    unclosed; ``timers_enable`` keeps it up on its own."""
    import gc

    monkeypatch.delenv("GST_KERNEL_TIMERS", raising=False)
    a = _server(demo, False, kernel_timers=True, flight=False)
    b = _server(demo, False, kernel_timers=True, flight=False)
    c = _server(demo, False, kernel_timers=False, flight=False)
    try:
        assert timers._on is True and timers._holds == 2
        c.close()
        a.close()
        assert timers._on is True and timers._holds == 1
        timers.timers_enable(False)
        assert timers._on is True
    finally:
        b.close()
    assert timers._on is False and timers._holds == 0
    timers.timers_enable(True)
    d = _server(demo, False, kernel_timers=True, flight=False)
    d.close()
    assert timers._on is True
    timers.timers_enable(False)
    assert timers._on is False
    e = _server(demo, False, kernel_timers=True, flight=False)
    assert timers._holds == 1
    del e
    gc.collect()
    assert timers._holds == 0 and timers._on is False


def test_server_kernel_timers_refuse_typos(demo, monkeypatch):
    with pytest.raises(ValueError, match="kernel_timers"):
        _server(demo, False, kernel_timers="yes", flight=False)
    monkeypatch.setenv("GST_KERNEL_TIMERS", "on")
    with pytest.raises(ValueError, match="GST_KERNEL_TIMERS"):
        _server(demo, False, flight=False)
