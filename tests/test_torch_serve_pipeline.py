"""The port's chain server: the pipelined executor held to the serial loop,
and lossless preemption, spools, cancels, deadlines and sheds (CPU, plain
versions, the 5-component demo model, quantum 5).

Each pin holds on both executors (``pipeline=False`` and the pipelined
default), driven on a thread of its own that must finish in time, every
result waited for with a timeout and every server closed:

- pipelined == serial, every tenant bitwise (all seven record fields and
  the accept rates), over five tenants in a 32-lane pool with backfill:
  padded ones, a spooled one, Robbins-Monro adaptation on;
- preemption is lossless: in a 48-lane pool a padded spooled batch tenant
  (20 chains, 50 sweeps, still adapting when it is frozen) and a
  deadline-armed one (16 chains, deadline 15) are preempted by an
  interactive job of 48 chains that arrives once both have served two
  quanta (the trigger reads their slots' served sweeps, which the dispatch
  side sets, so a victim the staging thread admits a quantum late still
  serves its two). The
  first finishes bitwise its uninterrupted run, every field; the second
  resolves with ``DeadlineExceeded`` whose spooled prefix is bitwise the
  uninterrupted run's first rows;
- a spooled tenant's drains arrive in sweep order, each after its rows
  and checkpoint are on disk, and its result is its uninterrupted run's;
- ``resume_spool=True`` continues a spooled tenant from its checkpoint,
  bitwise;
- a cancel freezes a running tenant at the next boundary (the quantum in
  flight is kept: a bitwise prefix); a queued, a staged and a mid-staging
  job are rejected;
- the block policy sheds with ``RetryAfter`` when no room frees in time;
- the kernel library is built once when two threads ask for it at once.
"""

import ctypes
import threading
import time

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.ops import _cuda
from gibbs_student_t_tpu_torch.serve import (
    ChainServer,
    DeadlineExceeded,
    RetryAfter,
    TenantRequest,
)
from gibbs_student_t_tpu_torch.utils.spool import load_spool_state

torch.set_num_threads(1)

FIELDS = ("chain", "bchain", "zchain", "thetachain", "alphachain",
          "poutchain", "dfchain")
EXECUTORS = [False, True]
IDS = ["serial", "pipelined"]
#: no wait in this file may take longer (a hang fails, it does not stall)
TIMEOUT_S = 120.0
ADAPT = 20


@pytest.fixture(scope="module")
def setup():
    ma = make_demo_model_arrays(components=5)
    return ma, GibbsConfig(model="mixture").with_adapt(ADAPT)


def _victim(ma, **kw):
    # padded (20 chains: two groups), 10 quanta, adapting for 4
    return TenantRequest(**{"ma": ma, "niter": 50, "nchains": 20, "seed": 3,
                            "priority": 2, **kw})


def _deadline_victim(ma, **kw):
    return TenantRequest(ma=ma, niter=50, nchains=16, seed=5, priority=2,
                         **kw)


@pytest.fixture(scope="module")
def reference(setup):
    """The two victims' uninterrupted runs (serial, in memory)."""
    ma, cfg = setup
    srv = ChainServer(ma, cfg, nlanes=48, quantum=5,
                      record="full", device="cpu", pipeline=False)
    try:
        hv = srv.submit(_victim(ma))
        hw = srv.submit(_deadline_victim(ma))
        _drive(srv)
        return hv.result(TIMEOUT_S), hw.result(TIMEOUT_S)
    finally:
        srv.close()


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
    th.join(TIMEOUT_S)
    if th.is_alive():
        srv._stop.set()
        th.join(10.0)
        pytest.fail(f"the server's run did not end in {TIMEOUT_S} s")
    if box:
        raise box[0]


def _wait_for(cond, what):
    t_end = time.monotonic() + TIMEOUT_S
    while not cond():
        if time.monotonic() > t_end:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.002)


def _assert_bitwise(got, want, rows=None):
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        if rows is not None:
            a = a[:rows]
        np.testing.assert_array_equal(b, a, err_msg=f)
    for k in ("acc_white", "acc_hyper"):
        a = want.stats[k] if rows is None else want.stats[k][:rows]
        np.testing.assert_array_equal(got.stats[k], a, err_msg=k)


# --- pipelined == serial -----------------------------------------------------

def test_pipelined_equals_serial(setup, tmp_path):
    ma, cfg = setup
    jobs = [dict(niter=15, nchains=16, seed=10),
            dict(niter=10, nchains=12, seed=11),
            dict(niter=10, nchains=20, seed=12),
            dict(niter=5, nchains=8, seed=13, spool=True),
            dict(niter=10, nchains=16, seed=14)]
    results = {}
    for pipeline in EXECUTORS:
        srv = ChainServer(ma, cfg, nlanes=32, quantum=5,
                          record="full", device="cpu", pipeline=pipeline)
        try:
            hs = []
            for i, j in enumerate(jobs):
                j = dict(j)
                spool = (str(tmp_path / f"{pipeline}_{i}")
                         if j.pop("spool", False) else None)
                hs.append(srv.submit(TenantRequest(
                    ma=make_demo_model_arrays(components=5, seed=40 + i),
                    spool_dir=spool, **j)))
            _drive(srv)
            results[pipeline] = [h.result(TIMEOUT_S) for h in hs]
            s = srv.summary()
            assert s["busy_chain_sweeps"] == sum(j["niter"] * j["nchains"]
                                                 for j in jobs)
            assert srv._free_groups == [0, 1]
            assert not srv.pool._active_np.any()
        finally:
            srv.close()
    for got, want, j in zip(results[True], results[False], jobs):
        assert got.chain.shape == (j["niter"], j["nchains"], 3)
        _assert_bitwise(got, want)


# --- lossless preemption and the deadline -------------------------------------

@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_preemption_is_lossless(setup, reference, tmp_path, pipeline):
    ma, cfg = setup
    ref_v, ref_w = reference
    srv = ChainServer(ma, cfg, nlanes=48, quantum=5,
                      record="full", device="cpu",
                      pipeline=pipeline, scheduler="priority",
                      age_boost_s=0)
    hi, victims = [], []

    def on_quantum(s):
        # the pipelined executor stages one tenant at a time, so under load
        # the second victim can be admitted a quantum after the first: the
        # trigger waits for both to have served two quanta
        served = [t.slot.done_sweeps for t in list(s._running.values())
                  if t.handle in victims]
        if not hi and len(served) == 2 and min(served) >= 10:
            hi.append(s.submit(TenantRequest(ma=ma, niter=10, nchains=48,
                                             seed=9, priority=0)))

    try:
        hv = srv.submit(_victim(ma, spool_dir=str(tmp_path / "v")))
        hw = srv.submit(_deadline_victim(ma, deadline_sweeps=15,
                                         spool_dir=str(tmp_path / "w")))
        victims += [hv, hw]
        _drive(srv, on_quantum)
        assert hi[0].result(TIMEOUT_S).chain.shape == (10, 48, 3)
        _assert_bitwise(hv.result(TIMEOUT_S), ref_v)
        assert hv.preemptions >= 1 and hv.request.start_sweep >= 15
        with pytest.raises(DeadlineExceeded) as ei:
            hw.result(TIMEOUT_S)
        err = ei.value
        assert err.deadline_sweep == 15 and err.served_sweeps >= 15
        n = err.partial.chain.shape[0]
        assert n == err.served_sweeps
        _assert_bitwise(err.partial, ref_w, rows=n)
        assert srv.summary()["sched"]["preemptions"] >= 2
    finally:
        srv.close()


# --- spool drain order and resume ----------------------------------------------

@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_spool_drains_in_order(setup, reference, tmp_path, pipeline):
    ma, cfg = setup
    sdir = str(tmp_path / "s")
    seen = []

    def on_chunk(handle, sweep_end, records):
        _, ck_sweep, _ = load_spool_state(sdir, device="cpu")
        seen.append((sweep_end, ck_sweep, records["x"].shape[0],
                     handle.sweeps_done, handle.done()))

    srv = ChainServer(ma, cfg, nlanes=32, quantum=5,
                      record="full", device="cpu", pipeline=pipeline)
    try:
        h = srv.submit(_victim(ma, niter=25, spool_dir=sdir,
                               on_chunk=on_chunk))
        _drive(srv)
        res = h.result(TIMEOUT_S)
    finally:
        srv.close()
    assert seen == [(5 * k, 5 * k, 5, 5 * k, False) for k in range(1, 6)]
    _assert_bitwise(res, reference[0], rows=25)


@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_resume_spool_is_bitwise(setup, reference, tmp_path, pipeline):
    ma, cfg = setup
    sdir = str(tmp_path / "r")
    srv = ChainServer(ma, cfg, nlanes=32, quantum=5,
                      record="full", device="cpu", pipeline=pipeline)
    try:
        first = srv.submit(_victim(ma, niter=10, spool_dir=sdir))
        _drive(srv)
        first.result(TIMEOUT_S)
        with pytest.raises(ValueError, match="spool moved"):
            srv.submit(_victim(ma, niter=15, spool_dir=sdir,
                               resume_spool=True, start_sweep=5))
        h = srv.submit(_victim(ma, niter=15, spool_dir=sdir,
                               resume_spool=True))
        assert h.request.start_sweep == 10
        _drive(srv)
        res = h.result(TIMEOUT_S)
    finally:
        srv.close()
    _assert_bitwise(res, reference[0], rows=25)


# --- cancels ---------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_cancel_freezes_at_next_boundary(setup, reference, pipeline):
    ma, cfg = setup
    srv = ChainServer(ma, cfg, nlanes=32, quantum=5,
                      record="full", device="cpu", pipeline=pipeline)
    h, cancelled = None, []

    def on_quantum(s):
        if s.quanta == 2 and not cancelled:
            cancelled.append(s.cancel(h))

    try:
        h = srv.submit(_victim(ma))
        _drive(srv, on_quantum)
        res = h.result(TIMEOUT_S)
    finally:
        srv.close()
    # the quantum in flight (or just served) is kept, nothing after it
    assert cancelled == [True]
    assert h.status == "done" and res.chain.shape[0] == 10
    _assert_bitwise(res, reference[0], rows=10)
    assert srv.quanta == 2 and not srv.cancel(h)


def test_cancel_while_queued_staged_or_staging(setup):
    ma, cfg = setup
    srv = ChainServer(ma, cfg, nlanes=32, quantum=5,
                      record="full", device="cpu",
                      prefetch=1)
    entered, release = threading.Event(), threading.Event()
    prepare = srv._prepare

    def slow_prepare(handle):
        if handle.request.name == "slow":
            entered.set()
            release.wait(TIMEOUT_S)
        return prepare(handle)

    srv._prepare = slow_prepare
    try:
        # queued: no thread drives the server yet
        queued = srv.submit(TenantRequest(ma=ma, niter=5, nchains=16))
        assert srv.cancel(queued) and queued.status == "rejected"
        with pytest.raises(RuntimeError, match="cancelled before"):
            queued.result(TIMEOUT_S)
        # a long tenant fills the pool; the next job is staged into the
        # one-deep window and waits there
        big = srv.submit(TenantRequest(ma=ma, niter=500, nchains=32))
        srv.start()
        _wait_for(lambda: big.status == "running", "the first admission")
        staged = srv.submit(TenantRequest(ma=ma, niter=5, nchains=16))
        _wait_for(lambda: srv.status()["staged"] == 1
                  and len(srv._prepared) == 1, "the staged job")
        assert srv.cancel(staged) and staged.status == "rejected"
        # mid-staging: neither queued nor staged when the cancel lands
        slow = srv.submit(TenantRequest(ma=ma, niter=5, nchains=16,
                                        name="slow"))
        assert entered.wait(TIMEOUT_S)
        assert srv.cancel(slow) and not slow.done()
        release.set()
        with pytest.raises(RuntimeError, match="cancelled before"):
            slow.result(TIMEOUT_S)
        assert srv.cancel(big)
        res = big.result(TIMEOUT_S)
        assert 0 < res.chain.shape[0] < 500
    finally:
        release.set()
        srv.close(timeout=TIMEOUT_S)


# --- the block policy's shed -------------------------------------------------------

@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_block_policy_sheds_when_no_room_frees(setup, pipeline):
    ma, cfg = setup
    srv = ChainServer(ma, cfg, nlanes=32, quantum=5,
                      record="full", device="cpu",
                      max_queue=1, pipeline=pipeline)
    try:
        big = srv.submit(TenantRequest(ma=ma, niter=500, nchains=32))
        srv.start()
        _wait_for(lambda: big.status == "running", "the first admission")
        shed = None
        for i in range(4):      # the queue, then the staging window fill
            try:
                srv.submit(TenantRequest(ma=ma, niter=5, nchains=16,
                                         seed=i, priority=3), timeout=0.2)
            except RetryAfter as e:
                shed = e
                break
        assert shed is not None and shed.tier == 3
        assert shed.queue_depth >= 1 and shed.retry_after_s >= 0.5
        assert srv.summary()["sched"]["sheds_by_tier"] == {"3": 1}
    finally:
        srv.close(timeout=TIMEOUT_S)
    with pytest.raises(Exception, match="server closed"):
        big.result(TIMEOUT_S)


# --- the kernel library's build lock ----------------------------------------------

def test_library_builds_once_from_two_threads(monkeypatch):
    builds, loaded = [], []

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    def fake_build(force=False):
        builds.append(threading.current_thread().name)
        time.sleep(0.2)         # the other thread arrives meanwhile
        return "libfake.so"

    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    threads = [threading.Thread(target=lambda: loaded.append(_cuda.lib()),
                                name=f"t{i}") for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(TIMEOUT_S)
    assert len(builds) == 1 and len(loaded) == 2
    assert loaded[0] is loaded[1]
