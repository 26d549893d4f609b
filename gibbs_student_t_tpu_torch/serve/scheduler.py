"""Requests, handles and the admission queue of the chain server.

Counterpart of ``gibbs_student_t_tpu/serve/scheduler.py``:
:class:`TenantRequest` (one job), :class:`TenantHandle` (the caller's
view of it), the overload and failure signals (:class:`QueueFull`,
:class:`RetryAfter`, :class:`TenantError`, :class:`DeadlineExceeded`)
and the bounded :class:`AdmissionQueue` with block/reject backpressure.
The queue's default order is FIFO with first-fit backfill (the server
scans past a head job that does not fit, so a small job can take free
groups); a server running the ``priority`` policy installs
:func:`schedule_score` as the queue's ``score``, and pops become
best-score-first over ``(effective priority, deadline slack, arrival
seq)``, which is the FIFO order exactly when every request carries the
defaults. The queue and the handles are thread-safe: the pipelined
executor's staging, drain and dispatch threads share them.

A shed or expired job's ``result()`` raises at once; it never waits.
A request's ``on_divergence`` lane-health policy (:data:`DIVERGENCE_POLICIES`)
and its ``on_converged`` policy (:data:`CONVERGED_POLICIES`, with the
streaming ``monitor`` of serve/monitor.py) are the server's to apply
(serve/server.py), and so are its ``warm_start`` (serve/warm.py) and its
``adapt_scan`` (serve/adapt.py). A handle reports its progress, its
convergence, its cost, and its warm start, adaptive scan and recycled rows
while it runs. The JAX request's trace id belongs to the wire, which is
not ported: a request that sets one raises ``TypeError``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from gibbs_student_t_tpu_torch.models.pta import ModelArrays
from gibbs_student_t_tpu_torch.serve import faults


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the admission queue is at capacity: at
    once under the ``reject`` backpressure policy, and under ``block``
    when no room frees in time."""


class RetryAfter(QueueFull):
    """A structured overload shed: the job was not accepted, and the
    caller should retry after ``retry_after_s`` seconds (the median of
    recent admission latencies, floored at 0.5 s; 1 s without any).
    ``queue_depth`` is the queued and staged jobs at the shed, ``tier``
    the rejected request's priority, ``where`` ``"server"`` (or
    ``"router"``, the JAX fleet router's shed)."""

    def __init__(self, msg: str, retry_after_s=None, queue_depth=None,
                 tier=None, where: str = "server"):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.queue_depth = queue_depth
        self.tier = tier
        self.where = where


class TenantError(RuntimeError):
    """A failure scoped to one tenant, raised by ``TenantHandle.result()``.

    ``cause`` is the original exception (also chained as ``__cause__``);
    ``partial`` the :class:`ChainResult` of what was served before the
    failure (a bitwise prefix of the uninterrupted run), or None;
    ``where`` names the stage (``drain``, ``finalize``, ``worker``,
    ``divergence``, ``spool``, ``deadline``, ``close``, ``pool``)."""

    def __init__(self, tenant_id: int, reason: str,
                 where: str = "drain", cause=None, partial=None):
        super().__init__(f"tenant {tenant_id} failed [{where}]: {reason}")
        self.tenant_id = tenant_id
        self.reason = reason
        self.where = where
        self.cause = cause
        self.partial = partial
        if cause is not None:
            self.__cause__ = cause


class DeadlineExceeded(TenantError):
    """A deadline-armed tenant preempted at or past its deadline sweep:
    the server resolves its handle with this error instead of queueing
    a continuation that cannot finish in time. ``partial`` carries the
    spooled prefix served before the deadline (a bitwise prefix of the
    uninterrupted run)."""

    def __init__(self, tenant_id: int, deadline_sweep: int,
                 served_sweeps: int, partial=None):
        super().__init__(
            tenant_id,
            reason=(f"deadline at sweep {deadline_sweep} passed with "
                    f"{served_sweeps} sweep(s) served"),
            where="deadline", partial=partial)
        self.deadline_sweep = int(deadline_sweep)
        self.served_sweeps = int(served_sweeps)


#: Valid ``TenantRequest.on_divergence`` policies. ``none`` streams on
#: (diverged chains are flagged by telemetry only); the others need pool
#: telemetry and a supervised server (checked at submit).
DIVERGENCE_POLICIES = ("none", "fail", "quarantine", "reinit")

#: Valid ``TenantRequest.on_converged`` policies. ``none`` serves the whole
#: ``niter`` budget; ``evict`` frees the tenant's lanes at the first quantum
#: boundary after its monitor's armed targets hold (``converged_at``),
#: through the cancel machinery: the result is the served prefix with
#: status ``done``, and the freed groups backfill from the queue at that
#: boundary. ``evict`` needs a monitor with an armed target (checked at
#: submit).
CONVERGED_POLICIES = ("none", "evict")

#: fields of the JAX request whose machinery this package does not have
#: (their value here must stay the default)
_NOT_PORTED = {"trace_id": None}


@dataclass
class TenantRequest:
    """One job for the slot pool: ``niter`` sweeps (a multiple of the pool
    quantum) of ``nchains`` chains of the model ``ma`` from ``seed``.

    ``state`` and ``start_sweep`` resume a tenant: chain k draws at its
    sweep ``i`` from the key of ``(seed, k)`` at counter ``i``
    (ops/rng.py), whatever lanes it holds, so a continuation equals the
    unbroken run. ``spool_dir`` streams each quantum's rows and a rolling
    state checkpoint to a spool directory (utils/spool.py) instead of
    memory; ``resume_spool=True`` has the server load ``state`` and
    ``start_sweep`` from that checkpoint at submit (when ``start_sweep``
    is also given, the checkpoint must sit exactly there).
    ``on_chunk(handle, sweep_end, records)`` is called with each
    quantum's records (``{field: (rows, nchains, ...)}``); ``name`` labels
    the job.

    ``priority``: lower is more urgent (0 interactive, 1 the default, 2+
    batch). Under a ``scheduler="priority"`` server it orders the queue
    and lets an arrival preempt running spooled tenants of a strictly
    higher number, losslessly. ``deadline_sweeps`` (sweeps from
    ``start_sweep``, or None) orders the jobs of one tier by slack, and a
    tenant preempted at or past its deadline resolves with
    :class:`DeadlineExceeded`.

    ``on_divergence`` is the tenant's lane-health policy, applied at the
    quantum boundary after a chain's state goes non-finite (the pool
    telemetry's sticky ``diverged`` flag): ``none`` streams on, ``fail``
    fails the tenant with a :class:`TenantError`, ``quarantine`` freezes
    the diverged chains and serves the others on, ``reinit`` re-draws
    them from the prior (``TorchGibbs``'s ``reinit_diverged``, in the
    pool).

    ``monitor`` (a :class:`~gibbs_student_t_tpu_torch.serve.monitor.
    MonitorSpec`) arms streaming convergence monitoring: the drain folds
    each quantum's chain rows into online ESS and split-R-hat, reported
    by :meth:`TenantHandle.progress`, with ``converged_at`` in the
    result's stats and the server's SLO block. ``on_converged="evict"``
    ends the tenant at the first boundary after it converged.

    ``x0`` (``(nchains, p)`` or ``(p,)``) starts the chains there instead
    of at prior draws. ``warm_start`` (serve/warm.py) starts them from a
    fit instead: a ``WarmStartSpec`` fits one on a short pilot of the
    tenant's model at staging, and a ``WarmStartFit`` (or its journaled
    JSON dict) replays an earlier fit, bitwise; ``GST_WARM_START`` gates
    the arm (``0`` serves every request cold). ``adapt_scan`` (an
    ``AdaptScanSpec``, serve/adapt.py) thins the tenant's converged
    conditional blocks at drain boundaries; it needs a monitor with an ESS
    target, and ``GST_ADAPT_SCAN`` gates the arm."""

    ma: ModelArrays
    niter: int
    nchains: int = 16
    seed: int = 0
    x0: Optional[np.ndarray] = None
    state: object = None
    start_sweep: int = 0
    spool_dir: Optional[str] = None
    resume_spool: bool = False
    on_chunk: Optional[Callable] = None
    name: Optional[str] = None
    priority: int = 1
    deadline_sweeps: Optional[int] = None
    on_divergence: str = "none"
    monitor: object = None
    on_converged: str = "none"
    warm_start: object = None
    adapt_scan: object = None
    trace_id: Optional[str] = None

    def __post_init__(self):
        for f, default in _NOT_PORTED.items():
            if getattr(self, f) != default:
                raise TypeError(
                    f"TenantRequest.{f}={getattr(self, f)!r} is not "
                    f"supported by this package's server (only "
                    f"{default!r})")


class TenantHandle:
    """The caller's view of a submitted job."""

    def __init__(self, tenant_id: int, request: TenantRequest):
        self.tenant_id = tenant_id
        self.request = request
        self.status = "queued"
        self.error: Optional[str] = None
        self.submitted_t = time.monotonic()
        self.admitted_t: Optional[float] = None
        self.first_result_t: Optional[float] = None
        self.finished_t: Optional[float] = None
        self.sweeps_done = 0
        self._cols: Dict[str, List[np.ndarray]] = {}
        # the telemetry accumulated over the tenant's quanta (tele_* keys,
        # the solo sampler's aggregation) and the health report built
        # from it at the end (None with pool telemetry off)
        self._tele_stats: Dict[str, np.ndarray] = {}
        self.health: Optional[Dict] = None
        self._result = None
        self._builder = None
        self._build_lock = threading.Lock()
        self._done = threading.Event()
        self._tenant_error: Optional[TenantError] = None
        # scheduling state: arrival sequence in the queue (the FIFO
        # tiebreak of schedule_score), the aging anchor (kept across a
        # preemption's requeue, unlike submitted_t), the absolute deadline
        # sweep (start_sweep + deadline_sweeps at the first submit) and
        # the number of preemptions
        self._queue_seq = -1
        self._age_t = self.submitted_t
        self._deadline_sweep: Optional[int] = None
        self.preemptions = 0
        # the streaming convergence monitor (serve/monitor.TenantMonitor),
        # attached at admission when the request armed one; the server
        # detaches it (with a warning) if it ever raises
        self._monitor = None
        # the tenant's share of the dispatch wall (active-lane share of
        # each quantum it ran in) and its active chain-lane quanta
        self.cost_device_ms = 0.0
        self.cost_lane_quanta = 0
        # the recycled partial-scan chain-rows the drain tagged (0 with
        # recycling off); the warm-start summary ({kind, pilot_sweeps,
        # pilot_ms, ...}, {"degraded": why}, or None: cold), set at
        # staging; the adaptive scan's latest selection probabilities and
        # gates (None while the tenant runs the full-rate scan)
        self.recycled_rows = 0
        self.warm: Optional[Dict] = None
        self.adapt: Optional[Dict] = None

    # -- server side ------------------------------------------------------

    def _stream(self, sweep_end: int, records: Dict[str, np.ndarray]):
        """Per-quantum bookkeeping and the ``on_chunk`` callback."""
        self.sweeps_done = sweep_end - self.request.start_sweep
        if self.first_result_t is None:
            self.first_result_t = time.monotonic()
        if self.request.on_chunk is not None:
            faults.fire("callback", tenant=self.fault_key)
            self.request.on_chunk(self, sweep_end, records)

    @property
    def fault_key(self):
        """The fault-injection identity (serve/faults.py): the request's
        name when it has one, else the tenant id."""
        return (self.request.name if self.request.name is not None
                else self.tenant_id)

    def _append(self, records: Dict[str, np.ndarray]) -> None:
        for f, a in records.items():
            self._cols.setdefault(f, []).append(a)

    def _finish(self, result) -> None:
        self._result = result
        self.finished_t = time.monotonic()
        self.status = "done"
        self._done.set()

    def _finish_lazy(self, builder: Callable) -> None:
        """Complete the job; ``builder()`` joins the records into the
        result at the first ``result()`` call, on the caller's thread."""
        self._builder = builder
        self.finished_t = time.monotonic()
        self.status = "done"
        self._done.set()

    def _fail(self, why: str) -> None:
        """Reject the job before admission."""
        self.error = why
        self.finished_t = time.monotonic()
        self.status = "rejected"
        self._done.set()

    def _fail_shed(self, err: RetryAfter) -> None:
        """Reject the job with an overload shed: ``result()`` raises the
        same :class:`RetryAfter` the submit call did."""
        self._tenant_error = err
        self.error = str(err)
        self.finished_t = time.monotonic()
        self.status = "rejected"
        self._done.set()

    def _fail_tenant(self, err: TenantError) -> None:
        """Fail a job that ran: ``result()`` raises ``err``, which carries
        the cause and the prefix served before it."""
        self._tenant_error = err
        self.error = str(err)
        self.finished_t = time.monotonic()
        self.status = "failed"
        self._done.set()

    def _add_cost(self, device_ms: float, lane_quanta: int) -> None:
        """Fold one quantum's attributed share (one writer: the drain
        thread, or the serial loop's thread)."""
        self.cost_device_ms += device_ms
        self.cost_lane_quanta += int(lane_quanta)

    # -- caller side ------------------------------------------------------

    @property
    def admission_ms(self) -> Optional[float]:
        if self.admitted_t is None:
            return None
        return (self.admitted_t - self.submitted_t) * 1e3

    @property
    def first_result_ms(self) -> Optional[float]:
        """Admission to the first drained records, ms."""
        if self.admitted_t is None or self.first_result_t is None:
            return None
        return (self.first_result_t - self.admitted_t) * 1e3

    @property
    def throughput_sweeps_per_s(self) -> Optional[float]:
        """Chain-sweeps per second over the tenant's residency."""
        if self.admitted_t is None or self.finished_t is None:
            return None
        dt = self.finished_t - self.admitted_t
        return self.request.nchains * self.sweeps_done / dt if dt > 0 \
            else None

    @property
    def converged_at(self) -> Optional[int]:
        """The sweep at which the monitor's armed targets first held; None
        while unconverged or unmonitored."""
        mon = self._monitor
        return None if mon is None else mon.converged_at

    def cost(self) -> Dict[str, object]:
        """The tenant's cost: ``device_ms``, its active-lane share of
        every quantum's dispatch wall (the shares of the tenants of a
        quantum sum to that quantum's wall, so the tenants' ``device_ms``
        add up to the server's ``summary()["cost"]["dispatch_wall_ms"]``);
        ``lane_quanta``, active chain-lanes x quanta; ``ess_per_core_s``,
        the monitored min-ESS per attributed second (None unmonitored or
        before the first evaluation)."""
        ess_min = None
        mon = self._monitor
        if mon is not None:
            ess_min = mon.snapshot().get("ess_min")
        core_s = self.cost_device_ms / 1e3
        return {
            "device_ms": self.cost_device_ms,
            "lane_quanta": int(self.cost_lane_quanta),
            "ess_per_core_s": (
                round(float(ess_min) / core_s, 3)
                if isinstance(ess_min, (int, float)) and core_s > 0
                else None),
        }

    def slack_sweeps(self) -> Optional[float]:
        """Deadline slack in sweeps, None without a deadline: the sweeps
        to the deadline less the work left, which is the monitor's
        ``est_sweeps_to_target`` when it has one and the remaining budget
        otherwise. Negative: the deadline cannot be met at this rate."""
        if self._deadline_sweep is None:
            return None
        pos = self.request.start_sweep + self.sweeps_done
        est = None
        mon = self._monitor
        if mon is not None:
            est = mon.snapshot().get("est_sweeps_to_target")
        if not isinstance(est, (int, float)):
            est = self.request.niter - self.sweeps_done
        return float(self._deadline_sweep - pos - est)

    def progress(self) -> Dict[str, object]:
        """The job's state, callable from any thread before, during and
        after its run: scheduling state, the streaming convergence view
        when it is monitored (``rows``, per-parameter ``ess``/``rhat``
        and their ``ess_min``/``rhat_max``, ``ess_per_s``,
        ``est_sweeps_to_target``, ``converged_at``), its :meth:`cost`, and
        its ``recycled_rows``, ``warm`` and ``adapt`` views once set."""
        p: Dict[str, object] = {
            "tenant_id": self.tenant_id,
            "name": self.request.name,
            "status": self.status,
            "nchains": self.request.nchains,
            "sweeps_done": self.sweeps_done,
            "niter": self.request.niter,
        }
        mon = self._monitor
        if mon is not None:
            p.update(mon.snapshot())
        p["priority"] = int(self.request.priority)
        if self._deadline_sweep is not None:
            p["deadline_sweep"] = int(self._deadline_sweep)
            p["slack_sweeps"] = self.slack_sweeps()
        if self.preemptions:
            p["preemptions"] = int(self.preemptions)
        p["cost"] = self.cost()
        if self.recycled_rows:
            p["recycled_rows"] = int(self.recycled_rows)
        if self.warm is not None:
            p["warm"] = dict(self.warm)
        if self.adapt is not None:
            p["adapt"] = dict(self.adapt)
        return p

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Wait up to ``timeout`` seconds (None: for ever) for the job and
        return its ``ChainResult``, ``(niter, nchains, ...)`` chains as
        ``TorchGibbs.sample`` returns them. Raises ``TimeoutError`` when
        it is not done by then (a serial server is driven by
        ``ChainServer.step()``/``run()`` on the caller's thread), the
        structured error of a shed or failed job, and ``RuntimeError``
        for a rejected one."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"tenant {self.tenant_id} not done (status "
                f"{self.status!r}); drive ChainServer.step()/run()")
        if self._tenant_error is not None:
            raise self._tenant_error
        if self.error is not None:
            raise RuntimeError(
                f"tenant {self.tenant_id} rejected: {self.error}")
        if self._result is None and self._builder is not None:
            with self._build_lock:
                if self._result is None:
                    self._result = self._builder()
                    self._builder = None
        return self._result


def schedule_score(handle: TenantHandle, now: Optional[float] = None,
                   age_boost_s: Optional[float] = None) -> tuple:
    """The priority scheduler's pop order, lowest first:
    ``(effective priority, deadline slack, arrival seq)``. The effective
    priority is the tier less one per ``age_boost_s`` seconds waited (the
    starvation bound; None or 0: no aging); the slack is
    :meth:`TenantHandle.slack_sweeps` (``+inf`` without a deadline); the
    arrival sequence makes default requests pop in FIFO order."""
    pr = float(handle.request.priority)
    if age_boost_s:
        t = now if now is not None else time.monotonic()
        waited = t - handle._age_t
        if waited > 0:
            pr -= int(waited / age_boost_s)
    slack = handle.slack_sweeps()
    return (pr, float("inf") if slack is None else slack,
            handle._queue_seq)


class AdmissionQueue:
    """A bounded queue with first-fit scanning and block/reject
    backpressure. ``score`` (None: FIFO) orders every pop best-first."""

    def __init__(self, maxsize: int = 64, policy: str = "block",
                 score=None):
        if policy not in ("block", "reject"):
            raise ValueError(
                f"backpressure policy must be 'block' or 'reject', "
                f"got {policy!r}")
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self.policy = policy
        #: optional ``handle -> orderable`` key; pops take the minimum
        self.score = score
        self._q: List[TenantHandle] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def full(self) -> bool:
        with self._lock:
            return len(self._q) >= self.maxsize

    def depth_by_tier(self) -> Dict[int, int]:
        """Queued jobs per priority."""
        with self._lock:
            out: Dict[int, int] = {}
            for h in self._q:
                tier = int(h.request.priority)
                out[tier] = out.get(tier, 0) + 1
            return out

    def put(self, handle: TenantHandle,
            timeout: Optional[float] = None) -> None:
        """Queue a job; at capacity raise :class:`QueueFull` (``reject``)
        or wait up to ``timeout`` seconds for room (``block``)."""
        with self._not_full:
            if len(self._q) >= self.maxsize:
                if self.policy == "reject":
                    raise QueueFull(
                        f"admission queue at capacity ({self.maxsize})")
                if not self._not_full.wait_for(
                        lambda: len(self._q) < self.maxsize,
                        timeout=timeout):
                    raise QueueFull(
                        f"admission queue still full after {timeout}s")
            handle._queue_seq = self._seq
            self._seq += 1
            self._q.append(handle)

    def put_displaced(self, handle: TenantHandle) -> None:
        """Requeue a preempted tenant's continuation past the capacity
        check: it was admitted once, and shedding it would lose its
        work. It keeps its aging anchor."""
        with self._not_full:
            handle._queue_seq = self._seq
            self._seq += 1
            self._q.append(handle)

    def _pop_best(self, candidates) -> Optional[TenantHandle]:
        """Pop the best-scored (or, FIFO, the first) of ``candidates``,
        ``(index, handle)`` pairs; the caller holds the lock."""
        best = None
        if self.score is None:
            best = next(iter(candidates), None)
        else:
            best_key = None
            for i, h in candidates:
                key = self.score(h)
                if best_key is None or key < best_key:
                    best, best_key = (i, h), key
        if best is None:
            return None
        self._q.pop(best[0])
        self._not_full.notify()
        return best[1]

    def pop_first_fit(self, fits) -> Optional[TenantHandle]:
        """Remove and return the best-ordered queued job for which
        ``fits(handle)`` is true, else None."""
        with self._not_full:
            return self._pop_best(
                (i, h) for i, h in enumerate(self._q) if fits(h))

    def pop_next(self) -> Optional[TenantHandle]:
        """Remove and return the best-ordered queued job, else None (the
        staging thread's pop: placement happens later, by first fit over
        the prepared window)."""
        with self._not_full:
            return self._pop_best(enumerate(self._q))

    def snapshot(self) -> List[TenantHandle]:
        """The queued handles in queue order (they stay queued)."""
        with self._lock:
            return list(self._q)

    def remove(self, handle: TenantHandle) -> bool:
        """Drop a queued job (a cancel before admission); False when it
        is no longer queued."""
        with self._not_full:
            for i, h in enumerate(self._q):
                if h is handle:
                    self._q.pop(i)
                    self._not_full.notify()
                    return True
            return False
