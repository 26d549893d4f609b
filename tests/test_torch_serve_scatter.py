"""The port's slot pool constructor surface on the CPU (plain versions):
the admission write arms (``GST_SERVE_SCATTER``), the pool's admission and
backend blocks, ``ChainServer(group=)`` and the pool's dispatch spans.

- the port's mirror of the JAX package's
  tests/test_serve.py::test_scatter_matches_bounce_bitwise: one schedule
  (two boundary admissions, a ``lane_nan`` fault re-drawn on one tenant
  and quarantined on another, a spooled tenant admitted mid-flight) under
  ``GST_SERVE_SCATTER=1`` and ``0``, under both executors: every result
  field and the spool bitwise, the same admissions, and fewer bytes moved
  by the scatter;
- a tenant killed after its first checkpoint under the bounce arm and
  recovered under it: bitwise its uninterrupted run under the scatter;
- the gate: strictly ``auto|1|0``, resolved once at construction; the
  bytes each arm counts an admission; ``status()["backend"]`` and
  ``summary()["admission"]``;
- a 20-chain tenant of a ``group=32`` pool holds 32 lanes and is bitwise
  ``TorchGibbs.sample``; a group that is not a multiple of 16 raises;
- a traced server's spans hold the pool's ``operand_upload`` and
  ``chunk_call`` on the dispatch role; an untraced pool records none.
"""

import threading

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.serve import (
    ChainServer,
    SlotPool,
    TenantRequest,
    TenantSlot,
    faults,
)
from gibbs_student_t_tpu_torch.serve.pool import serve_scatter_enabled

torch.set_num_threads(1)

FIELDS = ("chain", "bchain", "zchain", "thetachain", "alphachain",
          "poutchain", "dfchain")
Q = 5
RUN_TIMEOUT_S = 180.0


@pytest.fixture(scope="module")
def demo():
    return make_demo_model_arrays(components=5), GibbsConfig(model="mixture")


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
    assert not th.is_alive(), "server run did not finish in time"
    if box:
        raise box[0]


def _server(demo, **kw):
    ma, cfg = demo
    kw.setdefault("nlanes", 32)
    kw.setdefault("spans", False)
    return ChainServer(ma, cfg, quantum=Q, record="full", device="cpu",
                       flight=False, watchdog=False, **kw)


def _bitwise(got, want):
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        # tobytes: literal bitwise, and NaN-proof (the injected fault
        # leaves NaNs in the victim's records)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f
    for k in ("acc_white", "acc_hyper"):
        np.testing.assert_array_equal(got.stats[k], want.stats[k], err_msg=k)


def _run_arm(demo, flag, pipeline, spool_dir, monkeypatch):
    ma, _ = demo
    monkeypatch.setenv("GST_SERVE_SCATTER", flag)
    srv = _server(demo, pipeline=pipeline)
    assert srv.pool.scatter is (flag == "1")
    with faults.inject(
            faults.FaultSpec("lane_nan", tenant="R", after=1),
            faults.FaultSpec("lane_nan", tenant="Q", after=1)):
        hR = srv.submit(TenantRequest(ma=ma, niter=15, nchains=16, seed=1,
                                      name="R", on_divergence="reinit"))
        hQ = srv.submit(TenantRequest(ma=ma, niter=20, nchains=16, seed=2,
                                      name="Q", on_divergence="quarantine"))
        # queued behind the full pool: admitted mid-flight when R drains;
        # spooled, so its checkpoints read the state through the arm
        hL = srv.submit(TenantRequest(ma=ma, niter=10, nchains=16, seed=3,
                                      name="L", spool_dir=spool_dir))
        _drive(srv)
    out = {"results": [h.result(timeout=0) for h in (hR, hQ, hL)],
           "health": (hR.health, hQ.health),
           "stats": srv.pool.admission_stats(),
           "summary": srv.summary(), "status": srv.status()}
    srv.close()
    return out


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
def test_scatter_matches_bounce_bitwise(demo, monkeypatch, tmp_path,
                                        pipeline):
    arms = {flag: _run_arm(demo, flag, pipeline, str(tmp_path / flag),
                           monkeypatch) for flag in ("1", "0")}
    on, off = arms["1"], arms["0"]
    assert on["stats"]["scatter"] is True and off["stats"]["scatter"] is False
    assert on["stats"]["admits"] == off["stats"]["admits"] == 3
    for arm in (on, off):
        assert arm["health"][0]["n_reinits"] >= 1
        assert arm["health"][1]["n_quarantined"] >= 1
        assert arm["summary"]["admission"]["admits"] == 3
        assert arm["summary"]["admission"]["apply_ms"]["p50"] >= 0
    # the bounce moves the whole state down and up around an admission;
    # the scatter only the lanes' rows and their index
    assert on["stats"]["bytes_total"] < off["stats"]["bytes_total"]
    for r1, r0 in zip(on["results"], off["results"]):
        _bitwise(r1, r0)
    spool_on = sorted(p.name for p in (tmp_path / "1").iterdir())
    spool_off = sorted(p.name for p in (tmp_path / "0").iterdir())
    assert spool_on == spool_off
    for name in spool_on:
        a, b = tmp_path / "1" / name, tmp_path / "0" / name
        if a.is_file() and name != "meta.json":
            assert a.read_bytes() == b.read_bytes(), name


def test_bounce_arm_recovers_bitwise(demo, monkeypatch, tmp_path):
    """A spooled tenant killed after its first checkpoint under the bounce
    arm and recovered under it is bitwise its uninterrupted run under the
    scatter arm."""
    ma, _ = demo

    def req(**kw):
        return TenantRequest(ma=ma, niter=15, nchains=20, seed=6, name="K",
                             **kw)

    ref_srv = _server(demo, pipeline=False)
    ref_h = ref_srv.submit(req())
    _drive(ref_srv)
    ref_srv.close()
    monkeypatch.setenv("GST_SERVE_SCATTER", "0")
    man = str(tmp_path / "man")
    srv = _server(demo, pipeline=False, manifest_dir=man)
    srv.submit(req(spool_dir=str(tmp_path / "spool")))
    srv.step()
    srv2, handles = ChainServer.recover(man, device="cpu", pipeline=False,
                                        spans=False, flight=False,
                                        watchdog=False)
    try:
        assert srv2.pool.scatter is False
        _drive(srv2)
    finally:
        srv2.close()
    _bitwise(handles["K"].result(timeout=0), ref_h.result(timeout=0))


def test_scatter_gate(demo, monkeypatch):
    ma, cfg = demo
    monkeypatch.delenv("GST_SERVE_SCATTER", raising=False)
    assert serve_scatter_enabled()
    for flag, on in (("auto", True), ("1", True), ("0", False)):
        monkeypatch.setenv("GST_SERVE_SCATTER", flag)
        assert serve_scatter_enabled() is on
    monkeypatch.setenv("GST_SERVE_SCATTER", "yes")
    with pytest.raises(ValueError, match="GST_SERVE_SCATTER"):
        SlotPool(ma, cfg, nlanes=32, quantum=Q, device="cpu")
    # resolved once: a pool keeps its arm when the variable changes
    monkeypatch.setenv("GST_SERVE_SCATTER", "0")
    pool = SlotPool(ma, cfg, nlanes=32, quantum=Q, device="cpu")
    monkeypatch.setenv("GST_SERVE_SCATTER", "1")
    assert pool.scatter is False
    assert pool.backend_info() == {
        "platform": "cpu", "native": "none: plain versions on the CPU",
        "scatter": False}


@pytest.mark.parametrize("flag", ["1", "0"])
def test_admission_bytes(demo, monkeypatch, flag):
    """What :meth:`SlotPool.admission_stats` counts an admission: the rows
    and their lane index (scatter), or the rows and, after a quantum, the
    whole state down and back up (bounce)."""
    ma, cfg = demo
    monkeypatch.setenv("GST_SERVE_SCATTER", flag)
    pool = SlotPool(ma, cfg, nlanes=32, quantum=Q, device="cpu")
    smp = TorchGibbs(ma, cfg, nchains=16, device="cpu", tnt_block_size=None)
    state = smp.init_state(seed=0)
    rows = sum(t.numel() * t.element_size() for t in state)
    whole = sum(t.numel() * t.element_size() for t in pool.state)
    assert pool.admission_stats() == {"scatter": flag == "1", "admits": 0,
                                      "bytes_per_admit": None,
                                      "bytes_total": 0}
    first = TenantSlot(0, np.arange(16), 16, Q, 0, 0)
    pool.write_tenant(first, smp, state)
    pool.dispatch_quantum()
    pool.write_tenant(TenantSlot(1, np.arange(16, 32), 16, Q, 0, 1), smp,
                      state)
    st = pool.admission_stats()
    if flag == "1":
        assert st["bytes_total"] == 2 * (rows + 16 * 8)
    else:
        # the first admission pulled the state made on the device, the
        # second the state after the quantum
        assert st["bytes_total"] == 2 * (rows + 2 * whole)
    assert st["admits"] == 2 and st["bytes_per_admit"] == st[
        "bytes_total"] / 2


def test_status_and_summary_blocks(demo):
    ma, _ = demo
    srv = _server(demo, pipeline=False)
    srv.submit(TenantRequest(ma=ma, niter=Q, nchains=16, seed=0))
    _drive(srv)
    st, sm = srv.status(), srv.summary()
    srv.close()
    assert st["backend"] == sm["backend"] == srv.pool.backend_info()
    adm = sm["admission"]
    assert set(adm) == {"scatter", "admits", "bytes_per_admit",
                        "bytes_total", "apply_ms"}
    assert adm["scatter"] is True and adm["admits"] == 1
    assert set(adm["apply_ms"]) == {"p50", "p90", "p99", "max", "mean"}


# --- groups ---------------------------------------------------------------------

def test_group32_tenant_equals_torch_gibbs(demo):
    ma, cfg = demo
    srv = _server(demo, nlanes=64, group=32, pipeline=False)
    assert srv.pool.group == 32 and srv._free_groups == [0, 1]
    other = srv.submit(TenantRequest(ma=make_demo_model_arrays(
        components=5, seed=7), niter=2 * Q, nchains=16, seed=13))
    h = srv.submit(TenantRequest(ma=ma, niter=2 * Q, nchains=20, seed=3))
    srv.step()
    tenants = {t["tenant_id"]: t for t in srv.status()["tenants"]}
    assert tenants[h.tenant_id]["lane_groups"] == 1
    assert tenants[h.tenant_id]["lane0"] == 32
    assert tenants[other.tenant_id]["lane0"] == 0
    assert srv.status()["busy_lanes"] == 36
    _drive(srv)
    srv.close()
    smp = TorchGibbs(ma, cfg, nchains=20, device="cpu", chunk_size=Q,
                     tnt_block_size=None, record="full")
    _bitwise(h.result(timeout=0), smp.sample(niter=2 * Q, seed=3))
    assert other.result(timeout=0).chain.shape == (2 * Q, 16, 3)
    assert srv._free_groups == [0, 1]


def test_group_must_be_a_multiple_of_16(demo):
    with pytest.raises(ValueError, match="multiple of 16"):
        _server(demo, nlanes=48, group=24)
    with pytest.raises(ValueError, match="multiple of the admission group"):
        _server(demo, nlanes=48, group=32)


# --- the pool's spans -----------------------------------------------------------

def test_pool_dispatch_spans(demo):
    ma, _ = demo
    for pipeline in (False, True):
        srv = _server(demo, spans=True, pipeline=pipeline)
        srv.submit(TenantRequest(ma=ma, niter=2 * Q, nchains=16, seed=0))
        _drive(srv)
        spans = srv.spans.spans()
        srv.close()
        pool_spans = [s for s in spans
                      if s["name"] in ("operand_upload", "chunk_call")]
        assert {s["name"] for s in pool_spans} == {"operand_upload",
                                                   "chunk_call"}
        assert all(s["role"] == "dispatch" for s in pool_spans)
        assert sum(s["name"] == "chunk_call" for s in pool_spans) == 2
        assert all(s["dur"] >= 0 for s in pool_spans)
    srv = _server(demo, spans=False, pipeline=False)
    assert srv.pool.spans is None
    srv.close()
