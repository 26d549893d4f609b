"""The port's recycling Gibbs and mixture warm starts on the CPU, held
against the JAX package's (the 5-component demo model, 32 lanes, quantum
5).

- ``parallel/recycle.py`` against the JAX module on the same seeded
  inputs: the scan's field groups, row classes, the interleaved view with
  its carry (bitwise), the estimator's weights and moments and
  ``functional_ess`` (1e-12 relative), a result's recycled view; the
  monitor's weighted fold against JAX's and against plain moments of the
  interleaved stream (1e-12 relative); the spool refusing a resume that
  flips recycling;
- ``serve/warm.py``'s mixture against the JAX module: ``fit_from_rows``
  and ``draw_x0`` bitwise, journals replayed both ways through JSON,
  ``clip_to_support``, ``resolve_warm_start`` and the spec's checks;
- one shared pipelined server: row-class tags on streamed records and the
  recycled counts (the result's, the monitor's, the summary's), with the
  recycled view rebuilt from the result; recycling off bitwise (chains
  and spool bytes), with no tag and no new key; a quarantine at a counted
  boundary excluding the frozen chains from the count; a cancel's prefix;
  a failed pilot degrading to the cold init; ``GST_WARM_START=0`` serving
  a warm request cold, bitwise; a warm start deterministic on the pool;
- a warm-started tenant killed before its first checkpoint and recovered
  from its manifest: bitwise its uninterrupted run, no pilot re-run;
- the same script on the port's server and on the JAX server: the key
  trees of ``summary()``, each result's ``stats`` and ``progress()``.

Every run is driven on a thread of its own with a time limit, so a hang
fails instead of stalling the suite.
"""

import json
import os
import shutil
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.backends import jax_backend as jax_jb
from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.parallel import recycle as jax_recycle
from gibbs_student_t_tpu.serve import monitor as jax_monitor
from gibbs_student_t_tpu.serve import warm as jax_warm
from gibbs_student_t_tpu_torch.backends import torch_backend as port_tb
from gibbs_student_t_tpu_torch.backends.torch_backend import ChainState
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.parallel import recycle as port_recycle
from gibbs_student_t_tpu_torch.parallel.diagnostics import (
    ess_per_param,
    split_rhat_per_param,
)
from gibbs_student_t_tpu_torch.serve import (
    AdaptScanSpec,
    ChainServer,
    MonitorSpec,
    TenantRequest,
    WarmStartFit,
    WarmStartSpec,
)
from gibbs_student_t_tpu_torch.serve import monitor as port_monitor
from gibbs_student_t_tpu_torch.serve import server as port_server
from gibbs_student_t_tpu_torch.serve import warm as port_warm
from gibbs_student_t_tpu_torch.serve.manifest import read_manifest
from gibbs_student_t_tpu_torch.utils.spool import ChainSpool

pytestmark = pytest.mark.recycle

torch.set_num_threads(1)

FIELDS = ("chain", "bchain", "zchain", "thetachain", "alphachain",
          "poutchain", "dfchain")
RUN_TIMEOUT_S = 180.0
Q = 5
RTOL = 1e-12


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


def _bitwise(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for k in ("acc_white", "acc_hyper"):
        np.testing.assert_array_equal(got.stats[k], want.stats[k], err_msg=k)


@pytest.fixture(scope="module")
def demo():
    return make_demo_model_arrays(components=5), GibbsConfig(model="mixture")


# --- parallel/recycle.py against the JAX module ------------------------------

def test_field_groups_match_jax():
    """The port's copies of the scan's field groups are JAX's, and they
    partition the recorded fields."""
    assert port_tb.RECYCLE_EARLY_FIELDS == jax_jb.RECYCLE_EARLY_FIELDS
    assert port_tb.RECYCLE_LATE_FIELDS == jax_jb.RECYCLE_LATE_FIELDS
    early = set(port_tb.RECYCLE_EARLY_FIELDS)
    late = set(port_tb.RECYCLE_LATE_FIELDS)
    assert not early & late
    assert early | late == set(port_tb._RECORD_FIELDS)
    assert (port_recycle.ROW_SCAN_END, port_recycle.ROW_RECYCLED) \
        == (jax_recycle.ROW_SCAN_END, jax_recycle.ROW_RECYCLED)


@pytest.mark.parametrize("rows,carry", [(0, True), (1, False), (1, True),
                                        (3, False), (5, True), (25, False)])
def test_row_class_pattern_matches_jax(rows, carry):
    got = port_recycle.row_class_pattern(rows, carry)
    want = jax_recycle.row_class_pattern(rows, carry)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def _cols(rng, rows):
    return {"x": rng.normal(size=(rows, 3, 2)),
            "z": (rng.random((rows, 3, 5)) < 0.3).astype(np.float32),
            "theta": rng.normal(size=(rows, 3)),
            "acc_white": rng.random((rows, 3)),
            "extra": rng.normal(size=(rows, 3))}


def test_interleave_matches_jax_with_carry():
    """Three spans through both packages, each span's tail carried into
    the next: the same rows, classes and tails, bitwise; and the spans
    concatenated equal one interleave over the whole run."""
    rng = np.random.default_rng(0)
    spans = [_cols(rng, n) for n in (4, 1, 3)]
    tails = {"port": None, "jax": None}
    outs = {"port": [], "jax": []}
    for span in spans:
        for name, mod in (("port", port_recycle), ("jax", jax_recycle)):
            out, rc, tails[name] = mod.interleave(span, tails[name])
            outs[name].append((out, rc))
    for (po, prc), (jo, jrc) in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(prc, jrc)
        for f in po:
            np.testing.assert_array_equal(po[f], jo[f], err_msg=f)
    whole = {f: np.concatenate([s[f] for s in spans]) for f in spans[0]}
    w_out, w_rc, _ = port_recycle.interleave(whole)
    np.testing.assert_array_equal(
        np.concatenate([rc for _, rc in outs["port"]]), w_rc)
    for f in whole:
        np.testing.assert_array_equal(
            np.concatenate([o[f] for o, _ in outs["port"]]), w_out[f])
    # a mid-row between k and k+1: early fields from k+1, late from k
    out, _, _ = port_recycle.interleave(spans[0])
    np.testing.assert_array_equal(out["x"][1], spans[0]["x"][1])
    np.testing.assert_array_equal(out["z"][1], spans[0]["z"][0])
    np.testing.assert_array_equal(out["extra"][1], spans[0]["extra"][0])


def test_estimators_match_jax():
    rng = np.random.default_rng(1)
    window = rng.normal(size=(17, 4, 3))
    for rc in (port_recycle.row_class_pattern(9, False),
               np.zeros(0, np.uint8)):
        np.testing.assert_array_equal(port_recycle.recycle_weights(rc),
                                      jax_recycle.recycle_weights(rc))
    w = rng.random(17)
    for got, want in zip(port_recycle.weighted_moments(window, w),
                         jax_recycle.weighted_moments(window, w)):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    mean, var = port_recycle.weighted_moments(window, np.ones(17))
    np.testing.assert_allclose(mean, window.mean(axis=0), rtol=RTOL)
    np.testing.assert_allclose(var, window.var(axis=0), rtol=RTOL)
    values = rng.normal(size=(64, 4)).cumsum(axis=0)
    np.testing.assert_allclose(port_recycle.functional_ess(values),
                               jax_recycle.functional_ess(values),
                               rtol=RTOL)


def test_recycled_result_and_row_class_diagnostics_match_jax():
    rng = np.random.default_rng(2)
    res = SimpleNamespace(chain=rng.normal(size=(6, 3, 2)),
                          bchain=np.zeros((0,)),
                          zchain=rng.normal(size=(6, 3, 4)),
                          thetachain=rng.normal(size=(6, 3)),
                          alphachain=np.zeros((0,)),
                          dfchain=rng.normal(size=(6, 3)),
                          poutchain=np.zeros((0,)))
    got, grc = port_recycle.recycled_result(res)
    want, wrc = jax_recycle.recycled_result(res)
    np.testing.assert_array_equal(grc, wrc)
    assert sorted(got) == sorted(want) == ["df", "theta", "x", "z"]
    for f in got:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    # the per-parameter diagnostics drop the recycled rows
    cols = {"x": rng.normal(size=(40, 4, 3))}
    out, rc, _ = port_recycle.interleave(cols)
    np.testing.assert_allclose(ess_per_param(out["x"], row_class=rc),
                               ess_per_param(cols["x"]), rtol=RTOL)
    np.testing.assert_allclose(split_rhat_per_param(out["x"], row_class=rc),
                               split_rhat_per_param(cols["x"]), rtol=RTOL)


def test_monitor_weighted_fold_matches_jax_and_stream():
    """The recycled fold (multiplicity 2 on the carried rows), backfill
    included, in both packages: the same moments and counts, and plain
    moments of the interleaved x stream."""
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(16, 4, 2)).astype(np.float32)
    mons = []
    for mod in (port_monitor, jax_monitor):
        mon = mod.TenantMonitor(mod.MonitorSpec(params=[0, 1], every=1000),
                                4, np.array([0, 1]))
        mon.backfill(rows[:4], 4, updates=1, recycled=3)
        mon.update(rows[4:8], 8, recycled=4)
        mon.update(rows[8:12], 12, recycled=4)
        mon.update(rows[12:], 16, recycled=9)      # clamped to 4
        mons.append(mon)
    port, jax_ = mons
    for a in ("_w_n", "_w_mean", "_w_m2", "_recycled", "_updates"):
        np.testing.assert_allclose(getattr(port, a), getattr(jax_, a),
                                   rtol=RTOL, err_msg=a)
    assert port.snapshot()["recycled_rows"] \
        == jax_.snapshot()["recycled_rows"] == 15
    stream = np.concatenate([rows[:1], np.repeat(rows[1:], 2, axis=0)])
    stream = stream.astype(np.float64)
    assert port._w_n == stream.shape[0]
    np.testing.assert_allclose(port._w_mean, stream.mean(axis=0), rtol=RTOL)
    np.testing.assert_allclose(port._w_m2 / port._w_n, stream.var(axis=0),
                               rtol=1e-10)
    # without recycled rows the snapshot has no such key
    plain = port_monitor.TenantMonitor(port_monitor.MonitorSpec(), 4,
                                       np.array([0, 1]))
    plain.update(rows[:4], 4)
    assert "recycled_rows" not in plain.snapshot()


def test_spool_refuses_a_recycle_flip(tmp_path):
    d = str(tmp_path / "sp")
    recs = {"x": np.zeros((2, 3, 1), np.float32)}
    st = ChainState(*(np.zeros((3, 1), np.float32) for _ in range(11)))
    sp = ChainSpool(d, seed=0, recycle=True)
    sp.append(recs, st, 2)
    sp.close()
    with open(os.path.join(d, "meta.json")) as fh:
        assert json.load(fh)["recycle"] is True
    with pytest.raises(ValueError, match="recycle"):
        ChainSpool(d, seed=0, resume=True, resume_at=2,
                   recycle=False).append(recs, st, 4)
    sp3 = ChainSpool(d, seed=0, resume=True, resume_at=2, recycle=True)
    sp3.append(recs, st, 4)
    sp3.close()


# --- serve/warm.py's mixture against the JAX module ----------------------------

def _toy_specs():
    # (kind, a, b, init): uniform [0, 1], normal(0, 1), linearexp [-2, -1]
    return np.array([[0, 0.0, 1.0, 0.5],
                     [1, 0.0, 1.0, 0.0],
                     [2, -2.0, -1.0, -1.5]])


def test_mixture_fit_and_draws_match_jax():
    """``fit_from_rows`` and ``draw_x0`` bitwise JAX's; a fit journaled by
    either package replays through JSON in the other, bitwise."""
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(20, 3, 3)) * 0.1 + 0.4
    rows[:, 1, 2] = -1.5                   # a stuck column: the floor
    kw = dict(pilot_sweeps=16, pilot_chains=3, burn_frac=0.5)
    port = port_warm.fit_from_rows(rows, port_warm.WarmStartSpec(**kw),
                                   _toy_specs(), pilot_ms=7.0)
    jfit = jax_warm.fit_from_rows(rows, jax_warm.WarmStartSpec(**kw),
                                  _toy_specs(), pilot_ms=7.0)
    for a in ("means", "stds", "weights"):
        np.testing.assert_array_equal(getattr(port, a), getattr(jfit, a))
    assert port.to_json() == jfit.to_json()
    for seed in (9, 10, 2**32 + 9):
        x = port.draw_x0(16, seed, _toy_specs())
        np.testing.assert_array_equal(x, jfit.draw_x0(16, seed,
                                                      _toy_specs()))
        assert (x[:, 0] > 0).all() and (x[:, 0] < 1).all()
        assert (x[:, 2] > -2).all() and (x[:, 2] < -1).all()
    for src, dst in ((port, jax_warm), (jfit, port_warm)):
        back = dst.WarmStartFit.from_json(json.loads(json.dumps(
            src.to_json())))
        np.testing.assert_array_equal(back.draw_x0(16, 9, _toy_specs()),
                                      src.draw_x0(16, 9, _toy_specs()))
    for mod in (port_warm, jax_warm):
        with pytest.raises(ValueError, match="unknown warm-start"):
            mod.WarmStartFit.from_json({"kind": "flow9", "means": [],
                                        "stds": [], "weights": []})


def test_clip_to_support_matches_jax():
    x = np.random.default_rng(5).normal(scale=4.0, size=(50, 3))
    got = port_warm.clip_to_support(x, _toy_specs())
    np.testing.assert_array_equal(got, jax_warm.clip_to_support(
        x, _toy_specs()))
    assert got[:, 1].max() == x[:, 1].max()      # Normal: unbounded


def test_resolve_warm_start_and_spec_checks_match_jax():
    def view(mod):
        out = []
        spec = mod.WarmStartSpec()
        d = {"kind": "gmm", "means": [[0.0]], "stds": [[1.0]],
             "weights": [1.0]}
        for env in ("auto", "1", "0"):
            for req in (None, spec, d, object()):
                try:
                    r = mod.resolve_warm_start(req, env=env)
                    out.append(None if r is None else
                               (type(r).__name__, r is spec))
                except ValueError as e:
                    out.append(str(e))
        for kw in (dict(pilot_sweeps=2), dict(pilot_chains=0),
                   dict(burn_frac=1.0), dict(jitter_frac=-1.0),
                   dict(kind="vae"), {}):
            try:
                out.append(vars(mod.WarmStartSpec(**kw)))
            except ValueError as e:
                out.append(str(e))
        return out

    assert view(port_warm) == view(jax_warm)


# --- the shared server -------------------------------------------------------------

def _server(demo, **kw):
    ma, cfg = demo
    return ChainServer(ma, cfg, nlanes=32, quantum=Q, record="full",
                       device="cpu", spans=False, flight=False,
                       watchdog=False, **kw)


def _run_tenant(srv, ma, niter=15, seed=3, monitor=True, **kw):
    chunks = []
    h = srv.submit(TenantRequest(
        ma=ma, niter=niter, nchains=16, seed=seed,
        monitor=(MonitorSpec(params=[0, 1], ess_target=1e9)
                 if monitor else None),
        on_chunk=lambda hh, s, r: chunks.append((s, r)), **kw))
    _drive(srv)
    return h.result(timeout=0), h, chunks


@pytest.fixture(scope="module")
def pool_on(demo):
    srv = _server(demo)
    assert srv.recycle is True          # the default: GST_RECYCLE=auto
    yield srv
    srv.close()


@pytest.fixture(scope="module")
def recycled_run(demo, pool_on, tmp_path_factory):
    """One tenant on the shared server, spooled, and its twin in memory."""
    ma, _ = demo
    d = str(tmp_path_factory.mktemp("rec") / "spool")
    res, h, chunks = _run_tenant(pool_on, ma)
    sres, sh, _ = _run_tenant(pool_on, ma, spool_dir=d)
    return res, h, chunks, sres, d


def test_row_class_tags_and_counts(pool_on, recycled_run):
    res, h, chunks, sres, _ = recycled_run
    assert [list(r["row_class"]) for _, r in chunks] == [
        [0, 1, 0, 1, 0, 1, 0, 1, 0]] + [[1, 0] * 5] * 2
    # 15 rows, the first not recycled, x 16 chains
    assert h.recycled_rows == 14 * 16
    assert h.progress()["recycled_rows"] == 14 * 16
    assert h._monitor.snapshot()["recycled_rows"] == 14
    assert res.stats["recycle"] == {"enabled": True,
                                    "recycled_lane_rows": 224}
    assert sres.stats["recycle"] == res.stats["recycle"]
    summ = pool_on.summary()["recycle"]
    assert summ["enabled"] is True and summ["recycled_lane_rows"] >= 448
    # the recycled view is rebuilt from the result, never stored
    cols, rc = port_recycle.recycled_result(res)
    assert rc.size == 2 * 15 - 1
    assert int((rc == port_recycle.ROW_RECYCLED).sum()) == 14
    np.testing.assert_array_equal(cols["x"][1], res.chain[1])
    np.testing.assert_array_equal(cols["z"][1], res.zchain[0])
    # streamed rows: the tag rides beside the scan-end records
    np.testing.assert_array_equal(
        np.concatenate([r["x"] for _, r in chunks]), res.chain)


def test_recycle_off_bitwise_without_new_keys(demo, recycled_run,
                                              monkeypatch, tmp_path):
    """``GST_RECYCLE=0`` beats the constructor: chains and spool bytes
    bitwise the recycling run's; no tag, no count, no stats key, and the
    spool's meta as before recycling (``recycle`` null)."""
    ma, _ = demo
    res, h, _, sres, d_on = recycled_run
    monkeypatch.setenv("GST_RECYCLE", "0")
    srv = _server(demo, recycle=True)
    d_off = str(tmp_path / "spool")
    try:
        assert srv.recycle is False
        r_off, h_off, chunks = _run_tenant(srv, ma)
        s_off, _, _ = _run_tenant(srv, ma, spool_dir=d_off)
        summ = srv.summary()["recycle"]
    finally:
        srv.close()
    _bitwise(r_off, res)
    _bitwise(s_off, sres)
    assert all("row_class" not in r for _, r in chunks)
    assert h_off.recycled_rows == 0
    assert "recycled_rows" not in h_off.progress()
    assert "recycled_rows" not in h_off._monitor.snapshot()
    assert "recycle" not in r_off.stats and "recycle" not in s_off.stats
    assert summ == {"enabled": False, "recycled_lane_rows": 0}
    for name in sorted(os.listdir(d_on)):
        if name.endswith(".spool"):
            with open(os.path.join(d_on, name), "rb") as a, \
                    open(os.path.join(d_off, name), "rb") as b:
                assert a.read() == b.read(), name
    metas = [json.load(open(os.path.join(d, "meta.json")))
             for d in (d_on, d_off)]
    assert metas[0].pop("recycle") is True and metas[1].pop("recycle") is None
    metas[0]["extra"].pop("tenant")
    metas[1]["extra"].pop("tenant")
    assert metas[0] == metas[1]
    monkeypatch.setenv("GST_RECYCLE", "1")
    forced = _server(demo, recycle=False)
    assert forced.recycle is True
    forced.close()
    with pytest.raises(ValueError, match="recycle must be"):
        _server(demo, recycle="yes")


def test_quarantine_excludes_recycled_rows(demo, pool_on):
    """Four chains quarantined at the boundary after the tenant's first
    quantum was drained (counted by ``server.quanta``; the pool's
    ``quarantine_lanes`` freezes them): the first quantum counts 4
    recycled rows x 16 chains, the next two 5 x 12."""
    ma, _ = demo
    srv = pool_on
    box = {}

    def on_quantum(s):
        h = box.get("h")
        if h is None or "done" in box or s.quanta < box["q0"] + 1:
            return
        t_end = time.monotonic() + 30.0
        while h.sweeps_done < Q and time.monotonic() < t_end:
            time.sleep(0.002)       # the first quantum's drain
        with s._lock:
            ent = s._running.get(h.tenant_id)
            if ent is not None:
                s.pool.quarantine_lanes(ent.slot.chain_lanes[:4])
                ent.slot.quarantined.update(range(4))
                box["done"] = s.quanta
    box["q0"] = srv.quanta       # the shared server's quanta so far
    box["h"] = h = srv.submit(TenantRequest(ma=ma, niter=15, nchains=16,
                                            seed=5))
    _drive(srv, on_quantum)
    res = h.result(timeout=0)
    assert box.get("done") == box["q0"] + 1, \
        "the quarantine trigger did not act"
    assert h.recycled_rows == 4 * 16 + 5 * 12 + 5 * 12
    assert res.stats["recycle"]["recycled_lane_rows"] == 184
    assert h.health["quarantined_chains"] == [0, 1, 2, 3]


def test_cancel_leaves_a_prefix(demo, pool_on):
    ma, _ = demo
    srv = pool_on
    seen = []

    def cancel_after_first(hh, sweep_end, records):
        seen.append(list(records["row_class"]))
        if len(seen) == 1:
            srv.cancel(hh)

    h = srv.submit(TenantRequest(ma=ma, niter=25, nchains=16, seed=6,
                                 on_chunk=cancel_after_first))
    _drive(srv)
    res = h.result(timeout=0)
    served = res.chain.shape[0]
    assert served < 25 and h.status == "done"
    assert h.recycled_rows == (served - 1) * 16
    assert sum(rc.count(1) for rc in seen) == served - 1
    cols, tag = port_recycle.recycled_result(res)
    assert tag.size == 2 * served - 1
    np.testing.assert_array_equal(np.concatenate(seen).astype(np.uint8), tag)


def test_warm_degradation_on_pilot_failure(demo, pool_on, monkeypatch):
    """A pilot that raises degrades the tenant to the cold init, with the
    count and a warning: never a rejection."""
    ma, _ = demo

    def boom(self, handle, spec):
        raise RuntimeError("pilot exploded")

    monkeypatch.setattr(port_server.ChainServer, "_pool_pilot_fit", boom)
    before = pool_on.summary()["warm"]["degraded"]
    with pytest.warns(RuntimeWarning, match="warm-start fit failed"):
        res, h, _ = _run_tenant(pool_on, ma, seed=11,
                                warm_start=WarmStartSpec())
    assert h.status == "done"
    assert "pilot exploded" in h.warm["degraded"]
    assert res.stats["warm"] == h.warm
    assert pool_on.summary()["warm"]["degraded"] == before + 1


def test_warm_start_on_pool_deterministic_and_off_serves_cold(
        demo, pool_on, monkeypatch):
    """A warm start served on the pool twice: the same fit, the same
    chains (the pilot's draws depend on its seed only), other than the
    cold run's. ``GST_WARM_START=0``: the request serves cold, bitwise."""
    ma, _ = demo
    spec = WarmStartSpec(pilot_sweeps=10, pilot_chains=8)
    w1, h1, _ = _run_tenant(pool_on, ma, seed=12, monitor=False,
                            warm_start=spec)
    w2, h2, _ = _run_tenant(pool_on, ma, seed=12, monitor=False,
                            warm_start=spec)
    cold, hc, _ = _run_tenant(pool_on, ma, seed=12, monitor=False)
    assert h1.warm["kind"] == "gmm" and not h1.warm["replayed"]
    assert w1.stats["warm"] == h1.warm
    _bitwise(w1, w2)
    assert not np.array_equal(w1.chain, cold.chain)
    assert hc.warm is None and "warm" not in cold.stats
    monkeypatch.setenv("GST_WARM_START", "0")
    off, h_off, _ = _run_tenant(pool_on, ma, seed=12, monitor=False,
                                warm_start=spec)
    assert h_off.warm == {"degraded": "GST_WARM_START=0"}
    _bitwise(off, cold)


def test_warm_tenant_recovered_from_manifest_bitwise(demo, tmp_path,
                                                     monkeypatch):
    """A flow warm start on the serial executor (its standalone pilot),
    killed before its first surviving checkpoint: ``recover`` restarts it
    from the journaled fit, with no pilot, bitwise its uninterrupted
    run."""
    ma, _ = demo
    spec = WarmStartSpec(pilot_sweeps=10, pilot_chains=8, kind="flow")

    def req(**kw):
        return TenantRequest(ma=ma, niter=20, nchains=16, seed=5, name="F",
                             warm_start=spec, **kw)

    ref_srv = _server(demo, pipeline=False)
    ref_h = ref_srv.submit(req())
    _drive(ref_srv)
    ref_srv.close()
    ref = ref_h.result(timeout=0)
    assert ref_h.warm["kind"] == "flow"

    man, spool = str(tmp_path / "man"), str(tmp_path / "sF")
    srv = _server(demo, pipeline=False, manifest_dir=man)
    srv.submit(req(spool_dir=spool))
    for _ in range(2):
        srv.step()
    # the process dies here: nothing closes, and the spool is lost too
    admits = [r for r in read_manifest(man) if r.get("kind") == "admit"]
    assert admits[-1]["warm"]["kind"] == "flow"
    assert admits[-1]["warm"]["flow"]["layers"]
    shutil.rmtree(spool)

    def no_pilot(*a, **k):
        raise AssertionError("the recovery ran a pilot")

    monkeypatch.setattr(port_server, "fit_warm_start", no_pilot)
    srv2, handles = ChainServer.recover(man, pipeline=False, device="cpu",
                                        spans=False, flight=False,
                                        watchdog=False)
    try:
        _drive(srv2)
    finally:
        srv2.close()
    h = handles["F"]
    res = h.result(timeout=0)
    assert h.warm["kind"] == "flow" and h.warm["replayed"] is True
    _bitwise(res, ref)


# --- the same script on both servers ----------------------------------------------

#: keys only one server reports: the JAX server's wire, native backend and
#: scatter-admission block; the port's host ms of its launch loop and plane
JAX_ONLY = {"http", "backend"}
JAX_ONLY_PATHS = {("admission",)}
PORT_ONLY = {("host_ms", "dispatch"), ("host_ms", "monitor"),
             ("host_ms", "obs_refresh")}


def _tree(v, drop=(), drop_paths=(), path=()):
    if isinstance(v, dict):
        return {k: _tree(x, drop, drop_paths, path + (k,))
                for k, x in v.items()
                if k not in drop and path[-1:] + (k,) not in drop_paths}
    if isinstance(v, list):
        return [_tree(v[0], drop, drop_paths, path)] if v else []
    return "leaf"


def _script(ma, req_cls, spec_mod, warm_mod, adapt_mod):
    mon = spec_mod.MonitorSpec(params=[0, 1], ess_target=4.0, min_rows=8)
    return [req_cls(ma=ma, niter=30, nchains=16, seed=0, name="adapt",
                    monitor=mon,
                    adapt_scan=adapt_mod.AdaptScanSpec(floor=0.25)),
            req_cls(ma=ma, niter=15, nchains=16, seed=1, name="warm",
                    warm_start=warm_mod.WarmStartSpec(pilot_sweeps=10,
                                                      pilot_chains=8)),
            req_cls(ma=ma, niter=15, nchains=16, seed=2, name="plain")]


def _scripted(srv, reqs):
    hs = [srv.submit(r) for r in reqs]
    _drive(srv)
    out = {"summary": srv.summary(),
           "stats": [h.result(timeout=60).stats for h in hs],
           "progress": [h.progress() for h in hs]}
    srv.close()
    return out


@pytest.fixture(scope="module")
def both_servers(demo):
    from gibbs_student_t_tpu.serve import ChainServer as JaxServer
    from gibbs_student_t_tpu.serve import TenantRequest as JaxRequest
    from gibbs_student_t_tpu.serve import adapt as jax_adapt

    ma, _ = demo
    port = _scripted(_server(demo, kernel_timers=False), _script(
        ma, TenantRequest, port_monitor, port_warm,
        __import__("gibbs_student_t_tpu_torch.serve.adapt",
                   fromlist=["AdaptScanSpec"])))
    jma = jax_demo_model_arrays(components=5)
    jsrv = JaxServer(jma, JaxConfig(model="mixture"), nlanes=32, quantum=Q,
                     record="full", spans=False, flight=False,
                     watchdog=False, kernel_timers=False)
    jax_ = _scripted(jsrv, _script(jma, JaxRequest, jax_monitor, jax_warm,
                                   jax_adapt))
    return port, jax_


@pytest.mark.parametrize("record", ["summary", "stats", "progress"])
def test_key_trees_match_jax(both_servers, record):
    port, jax_ = both_servers
    got = _tree(port[record], drop_paths=PORT_ONLY)
    want = _tree(jax_[record], drop=JAX_ONLY, drop_paths=JAX_ONLY_PATHS)
    assert got == want
    if record == "summary":
        for arm in ("recycle", "warm", "adapt"):
            assert port[record][arm]["enabled" if arm != "warm"
                                     else "warm_starts"]
    if record == "stats":
        assert port["stats"][1]["warm"]["kind"] == "gmm"
        assert port["stats"][0]["recycle"]["recycled_lane_rows"] > 0


def test_adapt_spec_is_exported():
    assert AdaptScanSpec is port_server._adapt.AdaptScanSpec
    assert WarmStartFit is port_warm.WarmStartFit
