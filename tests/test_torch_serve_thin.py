"""Thinning in the port's slot pool and chain server (``record_thin``), on
the CPU (plain versions), against the port's full-rate runs, its solo
sampler and the JAX server.

- a thinned tenant's rows are bitwise its full-rate rows ``[::t]``, every
  field (two tenants, the second padded to two groups, under both
  executors), and its telemetry, sweep counts and cost are the full-rate
  run's;
- a thinned tenant alone in the pool is bitwise
  ``TorchGibbs(record_thin=t).sample`` at the same seed, for t = 2 and 5;
- one quantum of a thinned pool: ``quantum // t`` record rows, the
  full-rate rows ``[::t]``, the wire bytes divided by t, and the state and
  telemetry bitwise the full-rate quantum's;
- ``quantum % record_thin`` raises in the pool and the server, as in the
  JAX pool;
- the manifest journals ``record_thin`` and ``group``, and ``recover``
  restores both; a spooled thinned tenant killed after its first
  checkpoint and recovered is bitwise its uninterrupted run;
- the same script on the port's server and on the JAX server: rows per
  tenant, ``stats["record_thin"]``, ``progress()``'s sweeps, recycling's
  recycled rows and streamed ``row_class`` (structural comparisons: the
  two packages' random streams differ).
"""

import threading

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.serve import (
    ChainServer,
    MonitorSpec,
    SlotPool,
    TenantRequest,
    TenantSlot,
)
from gibbs_student_t_tpu_torch.serve.manifest import (
    load_server_state,
    read_manifest,
)

torch.set_num_threads(1)

FIELDS = ("chain", "bchain", "zchain", "thetachain", "alphachain",
          "poutchain", "dfchain")
Q = 10
THIN = 5
RUN_TIMEOUT_S = 180.0
#: (niter, nchains, seed) of the two tenants of the shared runs
JOBS = ((20, 16, 3), (30, 20, 4))


@pytest.fixture(scope="module")
def demo():
    return make_demo_model_arrays(components=5), GibbsConfig(model="mixture")


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
    assert not th.is_alive(), "server run did not finish in time"
    if box:
        raise box[0]


def _server(demo, **kw):
    ma, cfg = demo
    kw.setdefault("nlanes", 48)
    return ChainServer(ma, cfg, quantum=Q, record="full", device="cpu",
                       spans=False, flight=False, watchdog=False, **kw)


def _bitwise(got, want, rows=slice(None)):
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))[rows]
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f
    for k in ("acc_white", "acc_hyper"):
        np.testing.assert_array_equal(got.stats[k],
                                      np.asarray(want.stats[k])[rows],
                                      err_msg=k)


def _serve_jobs(demo, thin, pipeline):
    ma, _ = demo
    srv = _server(demo, record_thin=thin, pipeline=pipeline)
    chunks = [[] for _ in JOBS]
    hs = [srv.submit(TenantRequest(
        ma=ma, niter=n, nchains=c, seed=s,
        on_chunk=lambda h, sw, r, i=i: chunks[i].append((sw, r))))
        for i, (n, c, s) in enumerate(JOBS)]
    _drive(srv)
    out = {"results": [h.result(timeout=0) for h in hs],
           "progress": [h.progress() for h in hs],
           "cost": [h.cost() for h in hs], "chunks": chunks,
           "summary": srv.summary()}
    srv.close()
    return out


@pytest.fixture(scope="module")
def runs(demo):
    """Each executor, at full rate and thinned: the same two tenants."""
    return {(pipe, thin): _serve_jobs(demo, thin, pipe)
            for pipe in (False, True) for thin in (1, THIN)}


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
@pytest.mark.parametrize("tenant", [0, 1], ids=["16chains", "20chains"])
def test_thinned_rows_are_full_rate_rows(runs, pipeline, tenant):
    full = runs[(pipeline, 1)]["results"][tenant]
    thin = runs[(pipeline, THIN)]["results"][tenant]
    niter = JOBS[tenant][0]
    assert thin.chain.shape[0] == niter // THIN
    _bitwise(thin, full, rows=slice(None, None, THIN))
    assert int(thin.stats["record_thin"]) == THIN
    assert "record_thin" not in full.stats


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
def test_telemetry_sweeps_and_cost_unchanged_by_thinning(runs, pipeline):
    full, thin = runs[(pipeline, 1)], runs[(pipeline, THIN)]
    for rf, rt in zip(full["results"], thin["results"]):
        tele = sorted(k for k in rf.stats if k.startswith("tele_"))
        assert tele and tele == sorted(k for k in rt.stats
                                       if k.startswith("tele_"))
        for k in tele:
            np.testing.assert_array_equal(rt.stats[k], rf.stats[k],
                                          err_msg=k)
    for (n, _, _), pf, pt in zip(JOBS, full["progress"], thin["progress"]):
        assert pf["sweeps_done"] == pt["sweeps_done"] == n
    for cf, ct in zip(full["cost"], thin["cost"]):
        assert cf["lane_quanta"] == ct["lane_quanta"]
    for key in ("busy_chain_sweeps", "quanta", "occupancy"):
        assert full["summary"][key] == thin["summary"][key], key
    # the streamed rows and the recycled rows shrink with the records
    rows_q = Q // THIN
    for (n, c, _), ch, res in zip(JOBS, thin["chunks"], thin["results"]):
        assert [sw for sw, _ in ch] == list(range(Q, n + 1, Q))
        assert [len(r["x"]) for _, r in ch] == [rows_q] * (n // Q)
        np.testing.assert_array_equal(
            np.concatenate([r["x"] for _, r in ch]), res.chain)
        assert res.stats["recycle"]["recycled_lane_rows"] == \
            (n // THIN - 1) * c
    assert thin["summary"]["recycle"]["recycled_lane_rows"] == sum(
        (n // THIN - 1) * c for n, c, _ in JOBS)


@pytest.mark.parametrize("thin", [2, THIN])
def test_thinned_tenant_equals_torch_gibbs(demo, thin):
    ma, cfg = demo
    srv = _server(demo, nlanes=32, record_thin=thin, pipeline=False)
    h = srv.submit(TenantRequest(ma=ma, niter=20, nchains=16, seed=7))
    _drive(srv)
    srv.close()
    smp = TorchGibbs(ma, cfg, nchains=16, device="cpu", chunk_size=Q,
                     tnt_block_size=None, record="full", record_thin=thin)
    rs = smp.sample(niter=20, seed=7)
    rv = h.result(timeout=0)
    assert rv.chain.shape == (20 // thin, 16, 3)
    _bitwise(rv, rs)
    assert int(rv.stats["record_thin"]) == int(rs.stats["record_thin"])


def test_thinned_quantum_is_full_rate_quantum(demo):
    """One quantum of a thinned pool against a full-rate pool on the same
    tenant: the rows ``[::t]``, a t-th of the wire bytes, and the state
    and telemetry bitwise."""
    ma, cfg = demo
    smp = TorchGibbs(ma, cfg, nchains=20, device="cpu", tnt_block_size=None)
    state = smp.init_state(seed=2)
    out = {}
    for thin in (1, THIN):
        pool = SlotPool(ma, cfg, nlanes=32, quantum=Q, record="compact8",
                        device="cpu", record_thin=thin)
        slot = TenantSlot(0, np.arange(32), 20, Q, 0, 2)
        pool.write_tenant(slot, smp, state)
        recs, tl, _ = pool.dispatch_quantum()
        out[thin] = (recs, tl, pool.tenant_state(slot), pool.wire_bytes)
    (r1, t1, s1, b1), (r5, t5, s5, b5) = out[1], out[THIN]
    assert b5 * THIN == b1
    for f in r1:
        assert r5[f].shape[0] == Q // THIN
        assert torch.equal(r5[f], r1[f][::THIN]), f
    for a, b in zip(t1, t5):
        assert torch.equal(a, b)
    for a, b in zip(s1, s5):
        assert torch.equal(a, b)


def test_quantum_must_be_a_multiple_of_record_thin(demo):
    from gibbs_student_t_tpu.serve.pool import SlotPool as JaxPool

    ma, cfg = demo
    msg = r"quantum \(10\) must be a multiple of record_thin \(3\)"
    with pytest.raises(ValueError, match=msg):
        SlotPool(ma, cfg, nlanes=32, quantum=Q, device="cpu",
                 record_thin=3)
    with pytest.raises(ValueError, match=msg):
        _server(demo, nlanes=32, record_thin=3)
    with pytest.raises(ValueError, match="record_thin must be >= 1"):
        SlotPool(ma, cfg, nlanes=32, quantum=Q, device="cpu",
                 record_thin=0)
    # the JAX pool's backend refuses first, with its chunk's wording
    with pytest.raises(ValueError, match=r"must be a multiple of "
                                         r"record_thin \(3\)"):
        JaxPool(jax_demo_model_arrays(components=5),
                JaxConfig(model="mixture"), nlanes=32, quantum=Q,
                record_thin=3)


def test_manifest_journals_thin_and_group(demo, tmp_path):
    man = str(tmp_path / "man")
    srv = _server(demo, nlanes=64, group=32, record_thin=THIN,
                  manifest_dir=man)
    srv.close()
    rec = [r for r in read_manifest(man) if r.get("kind") == "server"][-1]
    assert rec["record_thin"] == THIN and rec["group"] == 32
    _, _, kw = load_server_state(man)
    assert kw["record_thin"] == THIN and kw["group"] == 32
    srv2, handles = ChainServer.recover(man, device="cpu", spans=False,
                                        flight=False, watchdog=False)
    try:
        assert handles == {}
        assert srv2.pool.record_thin == THIN and srv2.pool.group == 32
        assert srv2.status()["group"] == 32
        assert srv2._free_groups == [0, 1]
    finally:
        srv2.close()


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
def test_spooled_thinned_tenant_recovers_bitwise(demo, tmp_path, pipeline):
    """A monitored, spooled 20-chain tenant of a thinned ``group=32`` pool,
    killed after its first checkpoint and recovered from the manifest:
    bitwise its uninterrupted run, its spool thinned."""
    ma, _ = demo

    def req(**kw):
        return TenantRequest(ma=ma, niter=30, nchains=20, seed=11, name="T",
                             monitor=MonitorSpec(params=[0, 1]), **kw)

    ref_srv = _server(demo, nlanes=64, group=32, record_thin=THIN,
                      pipeline=False)
    ref_h = ref_srv.submit(req())
    _drive(ref_srv)
    ref_srv.close()
    ref = ref_h.result(timeout=0)

    man, spool = str(tmp_path / "man"), str(tmp_path / "spool")
    srv = _server(demo, nlanes=64, group=32, record_thin=THIN,
                  pipeline=False, manifest_dir=man)
    srv.submit(req(spool_dir=spool))
    srv.step()
    # the process dies here: nothing is closed
    ck = [r for r in read_manifest(man) if r.get("kind") == "checkpoint"]
    assert [r["next_sweep"] for r in ck] == [Q]
    srv2, handles = ChainServer.recover(
        man, device="cpu", pipeline=pipeline, spans=False, flight=False,
        watchdog=False)
    try:
        assert srv2.pool.record_thin == THIN and srv2.pool.group == 32
        _drive(srv2)
    finally:
        srv2.close()
    h = handles["T"]
    res = h.result(timeout=0)
    assert res.chain.shape == (30 // THIN, 20, 3)
    _bitwise(res, ref)
    assert int(res.stats["record_thin"]) == THIN
    assert h.progress()["sweeps_done"] == 30 - Q
    assert h.progress()["rows"] == ref_h.progress()["rows"] == 30 // THIN


# --- the same script on both servers ------------------------------------------

def _script(ma, req_cls, spec_cls, chunks):
    return [req_cls(ma=ma, niter=20, nchains=16, seed=0, name="a",
                    on_chunk=lambda h, sw, r: chunks.append(
                        (sw, len(r["x"]), list(r["row_class"])))),
            req_cls(ma=ma, niter=10, nchains=16, seed=1, name="b",
                    monitor=spec_cls(params=[0, 1]))]


def _scripted(srv, reqs, chunks):
    hs = [srv.submit(r) for r in reqs]
    _drive(srv)
    res = [h.result(timeout=60) for h in hs]
    out = {"rows": [r.chain.shape[0] for r in res],
           "thin": [int(r.stats["record_thin"]) for r in res],
           "sweeps": [h.progress()["sweeps_done"] for h in hs],
           "monitor_rows": hs[1].progress()["rows"],
           "recycled": [h.recycled_rows for h in hs],
           "recycled_lane_rows": srv.summary()["recycle"][
               "recycled_lane_rows"],
           "chunks": sorted(chunks)}
    srv.close()
    return out


def test_thinning_matches_jax_server(demo):
    from gibbs_student_t_tpu.serve import ChainServer as JaxServer
    from gibbs_student_t_tpu.serve import MonitorSpec as JaxSpec
    from gibbs_student_t_tpu.serve import TenantRequest as JaxRequest

    ma, _ = demo
    pc, jc = [], []
    port = _scripted(_server(demo, nlanes=32, record_thin=THIN),
                     _script(ma, TenantRequest, MonitorSpec, pc), pc)
    jma = jax_demo_model_arrays(components=5)
    jsrv = JaxServer(jma, JaxConfig(model="mixture"), nlanes=32, quantum=Q,
                     record="full", record_thin=THIN, spans=False,
                     flight=False, watchdog=False, kernel_timers=False)
    jax_ = _scripted(jsrv, _script(jma, JaxRequest, JaxSpec, jc), jc)
    assert port == jax_
    assert port["rows"] == [20 // THIN, 10 // THIN]
    # two rows a quantum: the first chunk's first row follows the init
    assert port["chunks"] == [(Q, 2, [0, 1, 0]), (2 * Q, 2, [1, 0, 1, 0])]
