"""The port's scheduler against the JAX package's (CPU).

- the scheduler's properties over fake handles (no pool), each run on both
  packages' ``TenantRequest``/``TenantHandle``/``AdmissionQueue``/
  ``schedule_score`` with the same inputs, which must give the same
  observations (pop orders, slacks, scores, raised errors) and the values
  tests/test_scheduler.py pins: FIFO degeneration of the priority score,
  tiers, deadline slack, aging, scored first fit, the reject and block
  policies, ``put_displaced``, ``depth_by_tier``, and the shed and
  deadline resolution of a handle;
- one schedule, run by the JAX ``ChainServer(pipeline=False,
  scheduler="priority")`` and by the port's on the 5-component demo model
  in a 64-lane pool (quantum 5): two spooled batch tenants fill the pool
  (one padded, one deadline-armed), an interactive and a standard job
  arrive after the second quantum. At every boundary both servers report
  the same status, preemption count and sweeps served for every tenant
  (so the same quanta of admission, preemption, requeue, deadline failure
  and finish), and the same ``summary()["sched"]``. Chains are not
  compared: the packages' random streams differ by design;
- the port server's submit-time checks of ``priority``/``deadline_sweeps``
  and its structured shed (``RetryAfter``, counted per tier).
"""

import threading
import time

import pytest
import torch

from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.serve import scheduler as jax_sched
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.serve import scheduler as port_sched
from test_torch_host import _fields

torch.set_num_threads(1)

#: a run that takes longer than this has hung (no test may hang the suite)
RUN_TIMEOUT_S = 180.0


class _FakeMA:
    pass


def _handle(mod, tid=0, *, niter=20, priority=1, deadline=None, **kw):
    req = mod.TenantRequest(ma=_FakeMA(), niter=niter, nchains=4,
                            priority=priority, **kw)
    h = mod.TenantHandle(tid, req)
    if deadline is not None:
        h._deadline_sweep = req.start_sweep + deadline
    return h


def _drain(q, fits=lambda h: True):
    out = []
    while (h := q.pop_first_fit(fits)) is not None:
        out.append(h.tenant_id)
    return out


def _no_aging(mod):
    return lambda h: mod.schedule_score(h, age_boost_s=0)


# --- the properties: each returns what it observed --------------------------

def _retry_after(mod):
    e = mod.RetryAfter("full", retry_after_s=1.5, queue_depth=7, tier=2,
                       where="router")
    e2 = mod.RetryAfter("full")
    assert isinstance(e, mod.QueueFull)
    return (e.retry_after_s, e.queue_depth, e.tier, e.where,
            e2.retry_after_s, e2.queue_depth, e2.where)


def _fifo_degeneration(mod):
    scored = mod.AdmissionQueue(maxsize=16, score=mod.schedule_score)
    plain = mod.AdmissionQueue(maxsize=16)
    for i in range(6):
        scored.put(_handle(mod, i))
        plain.put(_handle(mod, 100 + i))
    got = (_drain(scored), _drain(plain))
    assert got == (list(range(6)), list(range(100, 106)))
    return got


def _tiers(mod):
    q = mod.AdmissionQueue(maxsize=16, score=_no_aging(mod))
    for tid, pr in [(0, 2), (1, 0), (2, 1), (3, 0), (4, 3)]:
        q.put(_handle(mod, tid, priority=pr))
    got = _drain(q)
    assert got == [1, 3, 2, 0, 4]
    return got


def _deadline_slack(mod):
    q = mod.AdmissionQueue(maxsize=16, score=_no_aging(mod))
    q.put(_handle(mod, 0, niter=20))
    q.put(_handle(mod, 1, niter=20, deadline=100))
    q.put(_handle(mod, 2, niter=20, deadline=25))
    got = (_drain(q), _handle(mod, 9, niter=20, deadline=25).slack_sweeps(),
           _handle(mod, 9, niter=20).slack_sweeps())
    assert got == ([2, 1, 0], 5.0, None)
    return got


def _aging(mod):
    old_batch = _handle(mod, 0, priority=2)
    old_batch._age_t = time.monotonic() - 95.0
    fresh_hi = _handle(mod, 1, priority=0)
    got = (mod.schedule_score(old_batch, age_boost_s=30.0)
           < mod.schedule_score(fresh_hi, age_boost_s=30.0),
           mod.schedule_score(old_batch, age_boost_s=None)[0],
           mod.schedule_score(old_batch, age_boost_s=0)[0])
    assert got == (True, 2.0, 2.0)
    return got


def _scored_first_fit(mod):
    q = mod.AdmissionQueue(maxsize=16, score=_no_aging(mod))
    big_hi = _handle(mod, 0, priority=0)
    big_hi.request.nchains = 32
    q.put(big_hi)
    q.put(_handle(mod, 1, priority=2))
    got = (q.pop_first_fit(lambda h: h.request.nchains <= 4).tenant_id,
           q.pop_first_fit(lambda h: True).tenant_id)
    assert got == (1, 0)
    return got


def _reject_policy(mod):
    q = mod.AdmissionQueue(maxsize=2, policy="reject")
    q.put(_handle(mod, 0))
    q.put(_handle(mod, 1))
    with pytest.raises(mod.QueueFull):
        q.put(_handle(mod, 2))
    return len(q)


def _block_policy(mod):
    q = mod.AdmissionQueue(maxsize=1, policy="block")
    q.put(_handle(mod, 0))
    with pytest.raises(mod.QueueFull, match="still full") as ei:
        q.put(_handle(mod, 1), timeout=0.05)
    return type(ei.value).__name__, len(q)


def _put_displaced(mod):
    q = mod.AdmissionQueue(maxsize=1, policy="reject",
                           score=lambda h: mod.schedule_score(
                               h, age_boost_s=30.0))
    q.put(_handle(mod, 0))
    displaced = _handle(mod, 7, priority=2)
    displaced._age_t = time.monotonic() - 120.0
    q.put_displaced(displaced)
    got = (len(q), displaced._queue_seq,
           q.pop_first_fit(lambda h: True).tenant_id)
    assert got == (2, 1, 7)
    return got


def _depth_by_tier(mod):
    q = mod.AdmissionQueue(maxsize=16)
    for pr in (0, 2, 2, 1, 2):
        q.put(_handle(mod, pr, priority=pr))
    before = q.depth_by_tier()
    q.pop_first_fit(lambda h: h.request.priority == 2)
    got = (before, q.depth_by_tier())
    assert got == ({0: 1, 1: 1, 2: 3}, {0: 1, 1: 1, 2: 2})
    return got


def _shed_resolution(mod):
    h = _handle(mod, 3, priority=2)
    err = mod.RetryAfter("admission queue full", retry_after_s=0.5,
                         queue_depth=4, tier=2)
    h._fail_shed(err)
    with pytest.raises(mod.RetryAfter) as ei:
        h.result(timeout=0.1)
    assert ei.value is err
    return h.done(), h.status, ei.value.retry_after_s, ei.value.tier


def _deadline_resolution(mod):
    h = _handle(mod, 5, deadline=40)
    err = mod.DeadlineExceeded(5, deadline_sweep=40, served_sweeps=15,
                               partial="prefix-stub")
    assert isinstance(err, mod.TenantError)
    h._fail_tenant(err)
    with pytest.raises(mod.DeadlineExceeded) as ei:
        h.result(timeout=0.1)
    return (h.done(), h.status, ei.value.deadline_sweep,
            ei.value.served_sweeps, ei.value.partial, ei.value.where)


def _default_score(mod):
    s = mod.schedule_score(_handle(mod, 0))
    assert isinstance(s[0], float)
    return s


PROPERTIES = [_retry_after, _fifo_degeneration, _tiers, _deadline_slack,
              _aging, _scored_first_fit, _reject_policy, _block_policy,
              _put_displaced, _depth_by_tier, _shed_resolution,
              _deadline_resolution, _default_score]


@pytest.mark.parametrize("prop", PROPERTIES,
                         ids=[p.__name__.strip("_") for p in PROPERTIES])
def test_scheduler_property_matches_jax(prop):
    assert prop(port_sched) == prop(jax_sched)


# --- one schedule through both servers ----------------------------------------

def _drive(srv, on_quantum):
    """``srv.run(on_quantum=...)`` on a thread of its own, failing (not
    hanging) when it does not finish in time."""
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


def _schedule(server_cls, req_cls, ma, cfg, root, **kw):
    """The submission script: per boundary, every tenant's (name, status,
    preemptions, sweeps served)."""
    srv = server_cls(ma, cfg, nlanes=64, quantum=5, record="full",
                     pipeline=False, scheduler="priority", age_boost_s=0,
                     **kw)
    hs = {}
    trace = []

    def on_quantum(s):
        if s.quanta == 2 and "H" not in hs:
            hs["H"] = s.submit(req_cls(ma=ma, niter=10, nchains=48, seed=9,
                                       priority=0, name="H"))
            hs["D"] = s.submit(req_cls(ma=ma, niter=10, nchains=16, seed=4,
                                       priority=1, name="D"))
        trace.append((s.quanta, tuple(
            (k, h.status, h.preemptions, h.sweeps_done)
            for k, h in sorted(hs.items()))))

    try:
        hs["A"] = srv.submit(req_cls(ma=ma, niter=30, nchains=20, seed=1,
                                     priority=2, spool_dir=str(root / "A"),
                                     name="A"))
        hs["B"] = srv.submit(req_cls(ma=ma, niter=50, nchains=32, seed=2,
                                     priority=2, deadline_sweeps=15,
                                     spool_dir=str(root / "B"), name="B"))
        _drive(srv, on_quantum)
        return trace, srv.summary()["sched"], {k: h.done()
                                               for k, h in hs.items()}
    finally:
        srv.close()


def test_schedule_matches_jax_server(tmp_path):
    from gibbs_student_t_tpu.serve import ChainServer as JaxServer
    from gibbs_student_t_tpu_torch.serve import ChainServer, TenantRequest

    jma = jax_demo_model_arrays(components=5)
    got_j = _schedule(JaxServer, jax_sched.TenantRequest, jma,
                      JaxConfig(model="mixture"), tmp_path / "jax")
    got_p = _schedule(ChainServer, TenantRequest,
                      model_arrays_from_fields(_fields(jma)),
                      GibbsConfig(model="mixture"), tmp_path / "port",
                      device="cpu")
    assert got_p == got_j
    trace, sched, done = got_p
    # what the script is built to show: both batch tenants preempted at
    # the third boundary, the deadline-armed one failed there, the
    # interactive and standard jobs admitted at the next, the padded
    # batch tenant readmitted after them and finished
    assert trace[2][1] == (("A", "queued", 1, 0), ("B", "failed", 0, 15),
                           ("D", "queued", 0, 0), ("H", "queued", 0, 0))
    assert trace[3][1][2:] == (("D", "running", 0, 5),
                               ("H", "running", 0, 5))
    assert trace[-1][1][0] == ("A", "done", 1, 15)
    assert sched["preemptions"] == 2 and sched["policy"] == "priority"
    assert all(done.values())


# --- the port server's submit checks and its shed ----------------------------

def test_submit_checks_and_structured_shed():
    from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
    from gibbs_student_t_tpu_torch.serve import (
        ChainServer,
        RetryAfter,
        TenantRequest,
    )

    ma = make_demo_model_arrays(components=5)
    srv = ChainServer(ma, GibbsConfig(model="mixture"), nlanes=32,
                      quantum=5, max_queue=1, backpressure="reject",
                      record="full", device="cpu")
    try:
        for bad in (dict(priority=-1), dict(priority=True),
                    dict(priority=1.0), dict(deadline_sweeps=0),
                    dict(deadline_sweeps=2.5)):
            with pytest.raises(ValueError, match="priority|deadline"):
                srv.submit(TenantRequest(ma=ma, niter=5, **bad))
        with pytest.raises(ValueError, match="resume_spool needs"):
            srv.submit(TenantRequest(ma=ma, niter=5, resume_spool=True))
        first = srv.submit(TenantRequest(ma=ma, niter=5, seed=0))
        with pytest.raises(RetryAfter) as ei:
            srv.submit(TenantRequest(ma=ma, niter=5, seed=1, priority=2))
        e = ei.value
        assert e.retry_after_s == 1.0 and e.queue_depth == 1
        assert e.tier == 2 and e.where == "server"
        sched = srv.summary()["sched"]
        assert sched["sheds"] == 1 and sched["sheds_by_tier"] == {"2": 1}
        assert sched["queue_tiers"] == {"1": 1}
        assert sched["queue_depth_peak"] == 1
        assert srv.status()["queue_depth"] == 1
        assert first.progress()["priority"] == 1 and not first.done()
        with pytest.raises(TimeoutError):
            first.result(timeout=0.01)
    finally:
        srv.close()
    # close resolves the queued job
    with pytest.raises(RuntimeError, match="server closed"):
        first.result(timeout=1.0)
