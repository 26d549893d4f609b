"""The chain server: a scheduler in front of the slot pool, with a serial
and a pipelined executor.

Counterpart of ``gibbs_student_t_tpu/serve/server.py``. Jobs are queued by
:meth:`ChainServer.submit` and admitted into free 16-lane groups of one
:class:`SlotPool`; the pool advances every lane a quantum at a time, and
each tenant's records go to its handle (or its spool) until its budget is
served, when its groups backfill from the queue. Two executors share every
scheduling rule:

- **serial** (:meth:`ChainServer.step`, ``pipeline=False``): one quantum a
  call, admission, dispatch, drain and release on the calling thread. It
  is the reference the pipelined executor is held to, bitwise.
- **pipelined** (the default :meth:`ChainServer.run`): the dispatch thread
  (the caller's, or :meth:`ChainServer.start`'s) owns the pool and is the
  only thread that launches sweep work. At each quantum boundary it
  releases decided tenants, places prepared ones and dispatches the next
  quantum; a drain thread copies each quantum's records (and, for spooled
  tenants, a snapshot of the post-quantum state) to pinned host memory on
  a side stream, ordered after the quantum by an event, and hands out the
  records, spool appends and results while the next quantum runs; a
  staging thread builds queued tenants' ``TorchGibbs`` and initial state
  into a window at most ``prefetch`` deep. At most ``MAX_INFLIGHT``
  quanta are dispatched and not yet drained, so the device memory their
  records hold is bounded.

Chain k of a tenant draws at its sweep i from the key of (seed, k) at
counter i, whatever lanes it holds and whenever it is scheduled, so each
tenant's result is bitwise the same under either executor, and a tenant
frozen, checkpointed and readmitted elsewhere at its next sweep continues
its uninterrupted run.

The ``priority`` scheduler orders the queue by :func:`schedule_score` and
preempts losslessly: a waiter that does not fit freezes running spooled
tenants of a strictly lower tier (lowest tier first, the most slack first
within a tier) at the next boundary; each victim's checkpoint becomes a
queued continuation (or, past its deadline, a :class:`DeadlineExceeded`
carrying the spooled prefix). A full queue sheds with a structured
:class:`RetryAfter`, counted per tier.

Not ported from the JAX server: supervision and fault containment (a
failure while draining a tenant fails that tenant's handle and then the
run), lane-health policies, the crash-recovery manifest and ``recover``,
monitors, adaptive scans, warm starts, recycling, telemetry and cost
accounting, spans, the flight recorder, the watchdog and the wire
(ROADMAP A-9).
"""

from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from gibbs_student_t_tpu_torch.backends.torch_backend import (
    ChainState,
    TorchGibbs,
    _HostCopy,
)
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.models.pta import ModelArrays
from gibbs_student_t_tpu_torch.ops.rng import check_counter
from gibbs_student_t_tpu_torch.parallel.ensemble import (
    _localize_names,
    _structure,
    check_kernel_structure,
)
from gibbs_student_t_tpu_torch.serve.pool import SlotPool, TenantSlot
from gibbs_student_t_tpu_torch.serve.scheduler import (
    AdmissionQueue,
    DeadlineExceeded,
    QueueFull,
    RetryAfter,
    TenantError,
    TenantHandle,
    TenantRequest,
    schedule_score,
)
from gibbs_student_t_tpu_torch.utils.spool import (
    ChainSpool,
    load_spool,
    load_spool_state,
)


@dataclass
class _Prepared:
    """A staged tenant: what admission needs except its lanes."""

    handle: TenantHandle
    backend: TorchGibbs
    state: object
    groups_needed: int


@dataclass
class _Tenant:
    """A running tenant's entry."""

    slot: TenantSlot
    handle: TenantHandle
    spool: Optional[ChainSpool] = None


@dataclass
class _Bundle:
    """One quantum's deferred drain. ``entries`` rows are ``(slot, handle,
    spool, sweep_end, final, drained)``: ``drained`` False marks a
    finalize-only entry (a tenant released at a boundary after its last
    records rode an earlier bundle). ``event`` follows the quantum on the
    device (None on the CPU); ``idx`` is the next entry to drain."""

    recs: Optional[Dict[str, torch.Tensor]]
    snap: Optional[ChainState]
    event: object
    entries: list
    idx: int = 0


def _percentiles(vals: List[float]) -> Optional[dict]:
    """{p50, p90, p99, max, mean} of a series of ms (None if empty)."""
    if not vals:
        return None
    a = np.asarray(vals, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)),
            "max": float(a.max()), "mean": float(a.mean())}


class ChainServer:
    """Serve many sampling jobs through one :class:`SlotPool`.

    ``nlanes``, ``quantum``, ``record`` and ``device`` configure the pool;
    ``max_queue`` bounds the admission queue, and ``backpressure`` says
    what :meth:`submit` does when it is full: ``"reject"`` sheds at once,
    ``"block"`` waits for room (with no other thread driving the server,
    it serves quanta itself until a queued job is admitted), and sheds if
    none frees. ``scheduler`` is ``"fifo"`` (arrival order, first fit) or
    ``"priority"`` (:func:`schedule_score`, with lossless preemption);
    ``age_boost_s`` is the priority scheduler's starvation bound: a queued
    job gains one tier for each that many seconds waited. ``pipeline``
    picks the executor :meth:`run` uses (True: pipelined; False: the
    serial loop), and ``prefetch`` bounds the staged-tenant window."""

    #: quanta dispatched and not yet drained, at most
    MAX_INFLIGHT = 2

    def __init__(self, template_ma: ModelArrays, config: GibbsConfig,
                 nlanes: int = 1024, quantum: int = 25, record: str = "full",
                 device=None, max_queue: int = 64,
                 backpressure: str = "block", pipeline: bool = True,
                 prefetch: int = 2, scheduler: str = "fifo",
                 age_boost_s: float = 30.0):
        if pipeline not in (True, False):
            raise ValueError(f"pipeline must be True or False, got "
                             f"{pipeline!r}")
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        if scheduler not in ("fifo", "priority"):
            raise ValueError(f"scheduler must be 'fifo' or 'priority', "
                             f"got {scheduler!r}")
        self.config = config
        self.pipeline = bool(pipeline)
        self.scheduler = scheduler
        self.age_boost_s = float(age_boost_s)
        self.queue = AdmissionQueue(
            max_queue, backpressure,
            score=(None if scheduler == "fifo" else
                   (lambda h: schedule_score(h,
                                             age_boost_s=self.age_boost_s))))
        self.pool = SlotPool(template_ma, config, nlanes=nlanes,
                             quantum=quantum, device=device, record=record)
        # the dispatch thread's state; reentrant, so a callback on the
        # serial path may read status()
        self._lock = threading.RLock()
        self._running: Dict[int, _Tenant] = {}
        # admission groups (``pool.group`` lanes each) no tenant holds
        self._free_groups: List[int] = list(range(nlanes // self.pool.group))
        self._ids = itertools.count()
        self._t_started = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._driver: Optional[threading.Thread] = None
        # the pipelined executor (threads started at the first run)
        self._prefetch = int(prefetch)
        self._prep_lock = threading.Lock()
        self._prepared: List[_Prepared] = []
        self._staging_n = 0
        # cancels that landed while their tenant was being staged
        self._cancelled_prestage: set = set()
        self._workers_stop = threading.Event()
        # wakes the staging thread: a job queued, room in the window
        self._stage_wake = threading.Event()
        self._stage_thread: Optional[threading.Thread] = None
        self._drain_thread: Optional[threading.Thread] = None
        self._drainq: _queue.Queue = _queue.Queue()
        self._inflight = threading.Semaphore(self.MAX_INFLIGHT)
        self._worker_error: Optional[BaseException] = None
        self._worker_error_label = ""
        # tenants released at a boundary whose finalize rides the next
        # bundle, after their last drain
        self._reaped: List[_Tenant] = []
        self._pull_stream = (torch.cuda.Stream(self.pool.device)
                             if self.pool.device.type == "cuda" else None)
        # run-level aggregates
        self.quanta = 0
        self.busy_chain_sweeps = 0
        self.total_lane_sweeps = 0
        self._admission_ms: List[float] = []
        self._first_result_ms: List[float] = []
        # per-quantum host ms: admission at the boundary, the dispatch
        # (serial: up to the records on the host), the drain, and the gap
        # from one dispatch's end to the next one's start
        self._admit_apply_ms: List[float] = []
        self._dispatch_ms: List[float] = []
        self._drain_ms: List[float] = []
        self._gap_ms: List[float] = []
        self._last_dispatch_t: Optional[float] = None
        self._preemptions = 0
        self._sheds = 0
        self._sheds_by_tier: Dict[int, int] = {}
        self._queue_depth_peak = 0

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, request: TenantRequest,
               timeout: Optional[float] = None) -> TenantHandle:
        """Queue a job and return its handle. Checks that need the pool's
        template happen at staging; a model the pool cannot serve is
        rejected through its handle. A full queue sheds with
        :class:`RetryAfter` (raised here, and by the handle's
        ``result()``)."""
        pool = self.pool
        if request.resume_spool and request.state is None:
            if request.spool_dir is None:
                raise ValueError("resume_spool needs spool_dir (the "
                                 "checkpoint to resume from)")
            state, next_sweep, _ = load_spool_state(request.spool_dir,
                                                    device="cpu")
            if request.start_sweep and next_sweep != request.start_sweep:
                raise ValueError(
                    f"resume_spool checkpoint sits at sweep {next_sweep}, "
                    f"not the requested start_sweep {request.start_sweep}:"
                    " the spool moved under the resume")
            request.state, request.start_sweep = state, next_sweep
        if request.niter < 1 or request.niter % pool.quantum:
            raise ValueError(
                f"niter ({request.niter}) must be a positive multiple "
                f"of the pool quantum ({pool.quantum})")
        if request.nchains < 1:
            raise ValueError("nchains must be >= 1")
        pr = request.priority
        if isinstance(pr, bool) or not isinstance(pr, int) or pr < 0:
            raise ValueError(f"priority must be a non-negative int (0 = "
                             f"most urgent), got {pr!r}")
        dls = request.deadline_sweeps
        if dls is not None and (isinstance(dls, bool)
                                or not isinstance(dls, int) or dls < 1):
            raise ValueError(f"deadline_sweeps must be a positive int or "
                             f"None, got {dls!r}")
        groups = -(-request.nchains // pool.group)
        if groups > pool.nlanes // pool.group:
            raise ValueError(
                f"tenant needs {groups} lane groups; the pool only has "
                f"{pool.nlanes // pool.group}")
        # the seed and every tenant-local sweep index must fit their
        # 32-bit key and counter words
        check_counter("seed", request.seed)
        check_counter("sweep", request.start_sweep + request.niter - 1)
        handle = TenantHandle(next(self._ids), request)
        if dls is not None:
            handle._deadline_sweep = request.start_sweep + dls
        if self.queue.policy == "block" and (
                self._driver is None
                or self._driver is threading.current_thread()):
            # nobody else frees room: serve quanta here while that
            # admits something, then do not wait
            if self._driver is None:
                while self.queue.full() and self.step():
                    pass
            timeout = 0
        try:
            self.queue.put(handle, timeout=timeout)
        except QueueFull as e:
            err = self._shed_error(pr)
            self._sheds += 1
            self._sheds_by_tier[pr] = self._sheds_by_tier.get(pr, 0) + 1
            handle._fail_shed(err)
            raise err from e
        self._stage_wake.set()
        self._queue_depth_peak = max(self._queue_depth_peak,
                                     len(self.queue))
        return handle

    def _shed_error(self, tier: int) -> RetryAfter:
        """The overload signal: when to retry (the median of the recent
        admission latencies, at least 0.5 s; 1 s without any) and how
        many jobs stand queued or staged."""
        recent = self._admission_ms[-64:]
        retry_s = max(0.5, float(np.median(recent)) / 1e3) if recent \
            else 1.0
        depth = len(self.queue)
        with self._prep_lock:
            depth += len(self._prepared)
        return RetryAfter(
            f"admission queue full ({depth} deep); retry in "
            f"~{retry_s:.1f}s", retry_after_s=round(retry_s, 3),
            queue_depth=depth, tier=tier)

    def cancel(self, handle: TenantHandle) -> bool:
        """Cancel a job. A queued or staged one is rejected at once (one
        being staged right now, as its staging ends); a running one
        freezes at the next quantum boundary: the quantum in flight
        completes and its records are kept, and the tenant finishes with
        the sweeps served (status ``done``). False when the job is
        unknown or already finished."""
        with self._lock:
            ent = self._running.get(handle.tenant_id)
            if ent is not None:
                ent.slot.cancelled = True
                return True
        if self.queue.remove(handle):
            handle._fail("cancelled before admission")
            return True
        with self._prep_lock:
            for i, p in enumerate(self._prepared):
                if p.handle is handle:
                    self._prepared.pop(i)
                    handle._fail("cancelled before admission")
                    return True
            if handle.status == "queued" and not handle.done():
                self._cancelled_prestage.add(handle.tenant_id)
                return True
        return False

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _groups_needed(self, handle: TenantHandle) -> int:
        return -(-handle.request.nchains // self.pool.group)

    def _prepare(self, handle: TenantHandle) -> Optional[_Prepared]:
        """A queued tenant's ``TorchGibbs`` on the pool's device, checked
        against the template, and its initial state (the solo sampler's
        at the same seed, or the request's), or None when the model does
        not fit the pool (the handle is rejected)."""
        req, pool = handle.request, self.pool
        try:
            ma = _localize_names(req.ma)
            t = pool.template_ma
            if ma.row_mask is not None:
                raise ValueError("tenant models must be unpadded")
            if ma.n != pool.n_pool:
                raise ValueError(
                    f"tenant n={ma.n} != pool n={pool.n_pool}; the pool "
                    "admits only matching TOA counts")
            if ma.m != t.m:
                raise ValueError(f"tenant basis size {ma.m} != pool {t.m}")
            if _structure(ma) != _structure(t):
                raise ValueError(
                    "tenant model structure (parameters, noise groups, "
                    "phi blocks) differs from the pool template")
            backend = TorchGibbs(ma, self.config, nchains=req.nchains,
                                 device=pool.device, tnt_block_size=None)
            check_kernel_structure(backend, pool.drawer)
            state = (backend.init_state(seed=req.seed) if req.state is None
                     else req.state)
        except ValueError as e:
            handle._fail(f"{type(e).__name__}: {e}")
            return None
        return _Prepared(handle, backend, state, self._groups_needed(handle))

    def _apply_prepared(self, prep: _Prepared) -> None:
        """Place a prepared tenant into the first free groups (the caller
        holds ``_lock`` and has checked that they fit)."""
        handle, req, pool = prep.handle, prep.handle.request, self.pool
        with self._prep_lock:
            if handle.tenant_id in self._cancelled_prestage:
                self._cancelled_prestage.discard(handle.tenant_id)
                handle._fail("cancelled before admission")
                return
        taken = sorted(self._free_groups.pop(0)
                       for _ in range(prep.groups_needed))
        G = pool.group
        lanes = np.concatenate([np.arange(g * G, (g + 1) * G)
                                for g in taken])
        slot = TenantSlot(handle.tenant_id, lanes, req.nchains, req.niter,
                          req.start_sweep, req.seed)
        pool.write_tenant(slot, prep.backend, prep.state)
        spool = None
        if req.spool_dir is not None:
            spool = ChainSpool(
                req.spool_dir, req.seed, resume=req.start_sweep > 0,
                resume_at=req.start_sweep or None,
                record_mode=pool.drawer.record_mode,
                extra_meta={"tenant": handle.tenant_id,
                            "n_toa": [pool.n_pool]})
        handle.admitted_t = time.monotonic()
        handle.status = "running"
        self._running[handle.tenant_id] = _Tenant(slot, handle, spool)
        self._admission_ms.append(handle.admission_ms)

    def _admit(self, handle: TenantHandle) -> None:
        """Serial admission: prepare and place in one call."""
        prep = self._prepare(handle)
        if prep is not None:
            self._apply_prepared(prep)

    def _best_waiter(self, waiting) -> Optional[TenantHandle]:
        if not waiting:
            return None
        return min(waiting, key=lambda h: schedule_score(
            h, age_boost_s=self.age_boost_s))

    def _try_admissions(self) -> None:
        """Serial admission at a boundary: first fit over the queue (best
        score first under ``priority``), then preemption for the best
        waiter that is left."""
        while self._free_groups:
            free = len(self._free_groups)
            h = self.queue.pop_first_fit(
                lambda hh: self._groups_needed(hh) <= free)
            if h is None:
                break
            self._admit(h)
        if self.scheduler == "priority":
            waiter = self._best_waiter(self.queue.snapshot())
            if waiter is not None:
                self._preempt_for(waiter)

    def _apply_admissions(self) -> None:
        """Pipelined admission at a boundary: first fit over the prepared
        window (best score first under ``priority``), then preemption for
        the best waiter, prepared or queued. The caller holds ``_lock``."""
        while self._free_groups:
            free = len(self._free_groups)
            with self._prep_lock:
                fits = [(i, p) for i, p in enumerate(self._prepared)
                        if p.groups_needed <= free]
                if not fits:
                    break
                if self.queue.score is None:
                    best = fits[0][0]
                else:
                    best = min(fits, key=lambda ip: self.queue.score(
                        ip[1].handle))[0]
                prep = self._prepared.pop(best)
            self._stage_wake.set()
            self._apply_prepared(prep)
        if self.scheduler == "priority":
            with self._prep_lock:
                waiting = [p.handle for p in self._prepared]
            waiter = self._best_waiter(waiting + self.queue.snapshot())
            if waiter is not None:
                self._preempt_for(waiter)

    def _preempt_for(self, waiter: TenantHandle) -> int:
        """Free lane groups for ``waiter`` by freezing running tenants at
        the next boundary (the caller holds ``_lock``). Victims are
        spooled (their checkpoint makes the freeze lossless) and of a
        strictly lower tier than the waiter's own priority (aging orders
        the queue, it never preempts); the lowest tier goes first, and
        within a tier the most slack (no deadline before any). Groups
        already coming back count. Returns the victims marked."""
        pr = int(waiter.request.priority)
        needed = self._groups_needed(waiter) - len(self._free_groups)
        for t in self._running.values():
            if t.slot.cancelled:
                needed -= len(t.slot.lanes) // self.pool.group
        if needed <= 0:
            return 0
        victims = [t for t in self._running.values()
                   if t.spool is not None and not t.slot.cancelled
                   and int(t.handle.request.priority) > pr]

        def victim_key(t):
            s = t.handle.slack_sweeps()
            return (-int(t.handle.request.priority),
                    -(float("inf") if s is None else s))

        victims.sort(key=victim_key)
        marked = 0
        for t in victims:
            if needed <= 0:
                break
            t.slot.cancelled = t.slot.preempted = True
            needed -= len(t.slot.lanes) // self.pool.group
            marked += 1
            self._preemptions += 1
        return marked

    def _release(self, slot: TenantSlot) -> None:
        """Free a tenant's lanes and return its groups to the free list."""
        self.pool.evict(slot)
        self._free_groups.extend(
            int(g) for g in slot.lanes[::self.pool.group] // self.pool.group)
        self._free_groups.sort()

    def _reap_decided(self) -> List[_Tenant]:
        """Release the running tenants whose freeze was decided since the
        last dispatch (cancels), so their groups backfill at this
        boundary. Returns them for a finalize after their last drain."""
        reaped = []
        for tid, t in list(self._running.items()):
            if t.slot.cancelled and t.slot.done_sweeps > 0:
                self._running.pop(tid)
                self._release(t.slot)
                reaped.append(t)
        return reaped

    # ------------------------------------------------------------------
    # draining and finishing
    # ------------------------------------------------------------------

    def _drain_tenant(self, slot: TenantSlot, handle: TenantHandle,
                      spool: Optional[ChainSpool], host: dict,
                      sweep_end: int, state_fn) -> None:
        """Hand one tenant its share of a quantum (both executors): its
        records to its spool, with the checkpoint ``state_fn()`` at
        ``sweep_end``, or to its handle; then the ``on_chunk`` callback."""
        records = self.pool.tenant_records(host, slot)
        if spool is not None:
            spool.append(records, state_fn(), sweep_end)
        else:
            handle._append(records)
        first = handle.first_result_t is None
        handle._stream(sweep_end, records)
        if first and handle.first_result_ms is not None:
            self._first_result_ms.append(handle.first_result_ms)

    def _finalize(self, t: _Tenant) -> None:
        """Deliver a finished tenant's result, after its last records were
        drained. A preempted tenant with budget left is requeued
        instead."""
        slot, handle, spool = t.slot, t.handle, t.spool
        if slot.preempted and slot.remaining > 0:
            self._requeue_preempted(t)
            return
        if spool is not None:
            spool.close()
            res = load_spool(handle.request.spool_dir)
            res.stats["n_toa"] = np.asarray([self.pool.n_pool])
            handle._finish(res)
            return
        pool = self.pool

        def build():
            return pool.result({f: np.concatenate(c)
                                for f, c in handle._cols.items()})

        handle._finish_lazy(build)

    def _requeue_preempted(self, t: _Tenant) -> None:
        """Turn a preempted tenant's checkpoint into a queued continuation:
        the state reloaded from its spool (which must sit at the frozen
        tenant's next sweep), ``start_sweep`` there and the budget left as
        ``niter``. A deadline-armed tenant at or past its deadline
        resolves with :class:`DeadlineExceeded` instead, carrying the
        spooled prefix."""
        slot, handle = t.slot, t.handle
        t.spool.close()
        next_sweep = slot.start_sweep + slot.done_sweeps
        sdir = handle.request.spool_dir
        if (handle._deadline_sweep is not None
                and next_sweep >= handle._deadline_sweep):
            partial = load_spool(sdir) if slot.done_sweeps > 0 else None
            handle._fail_tenant(DeadlineExceeded(
                slot.tenant_id, handle._deadline_sweep, next_sweep,
                partial=partial))
            return
        state, ck_sweep, _ = load_spool_state(sdir, device="cpu")
        if ck_sweep != next_sweep:
            handle._fail_tenant(TenantError(
                slot.tenant_id,
                f"preemption checkpoint sits at sweep {ck_sweep}, not the "
                f"frozen tenant's {next_sweep}", where="spool"))
            return
        # the aging anchor, the absolute deadline and the preemption
        # count survive the requeue; the admission legs restart
        handle.request = replace(
            handle.request, niter=slot.niter - slot.done_sweeps,
            state=state, start_sweep=ck_sweep, resume_spool=False)
        handle.status = "queued"
        handle.submitted_t = time.monotonic()
        handle.admitted_t = handle.first_result_t = None
        handle.sweeps_done = 0
        handle.preemptions += 1
        self.queue.put_displaced(handle)
        self._stage_wake.set()
        self._queue_depth_peak = max(self._queue_depth_peak,
                                     len(self.queue))

    def _fail_drained(self, handle: TenantHandle, exc: Exception) -> None:
        """Resolve a tenant whose drain or finalize raised (its waiter
        must not hang); the failure then fails the run."""
        if not handle.done():
            handle._fail_tenant(TenantError(
                handle.tenant_id, f"{type(exc).__name__}: {exc}",
                where="drain", cause=exc))

    # ------------------------------------------------------------------
    # the serial quantum loop (the reference executor)
    # ------------------------------------------------------------------

    def step(self) -> bool:
        """One quantum on the calling thread: release cancelled tenants,
        admit, advance, hand out the records, release and finish the
        tenants that are done. Returns True while there is work left
        (resident or queued)."""
        with self._lock:
            for t in self._reap_decided():
                self._finalize(t)
            t0 = time.monotonic()
            self._try_admissions()
            self._admit_apply_ms.append((time.monotonic() - t0) * 1e3)
            if not self._running:
                return len(self.queue) > 0
        # the quantum itself runs outside the lock (only this thread
        # changes the running set; a cancel meanwhile only flags a slot)
        pool = self.pool
        t_d = self._dispatch_start()
        host = pool.materialize(pool.run_quantum())
        with self._lock:
            self._last_dispatch_t = t0 = time.monotonic()
            self._dispatch_ms.append((t0 - t_d) * 1e3)
            q = pool.quantum
            finished = []
            for tid, t in self._running.items():
                slot = t.slot
                slot.done_sweeps += q
                try:
                    self._drain_tenant(
                        slot, t.handle, t.spool, host,
                        slot.start_sweep + slot.done_sweeps,
                        state_fn=lambda s=slot: pool.tenant_state(s))
                except Exception as e:
                    self._fail_drained(t.handle, e)
                    raise
                if slot.remaining <= 0 or slot.cancelled:
                    finished.append(tid)
            self._count_quantum()
            for tid in finished:
                t = self._running.pop(tid)
                self._release(t.slot)
                self._finalize(t)
            self._drain_ms.append((time.monotonic() - t0) * 1e3)
            return bool(self._running) or len(self.queue) > 0

    def _dispatch_start(self) -> float:
        t = time.monotonic()
        if self._last_dispatch_t is not None:
            self._gap_ms.append((t - self._last_dispatch_t) * 1e3)
        return t

    def _count_quantum(self) -> None:
        q = self.pool.quantum
        self.quanta += 1
        self.busy_chain_sweeps += q * sum(t.slot.nchains
                                          for t in self._running.values())
        self.total_lane_sweeps += self.pool.nlanes * q

    # ------------------------------------------------------------------
    # the pipelined executor
    # ------------------------------------------------------------------

    def _take_for_staging(self) -> Optional[TenantHandle]:
        """The staging thread's next job, bounded by the prepared window
        (one lock scope with the count, so an idle check never misses a
        job between states)."""
        with self._prep_lock:
            if len(self._prepared) + self._staging_n >= self._prefetch:
                return None
            h = self.queue.pop_next()
            if h is not None:
                self._staging_n += 1
            return h

    def _stage_worker(self) -> None:
        while not self._workers_stop.is_set():
            self._stage_wake.clear()
            h = self._take_for_staging()
            if h is None:
                self._stage_wake.wait(0.05)
                continue
            try:
                prep = self._prepare(h)
            except BaseException as e:
                with self._prep_lock:
                    self._staging_n -= 1
                h._fail(f"staging failed: {type(e).__name__}: {e}")
                self._worker_error = e
                self._worker_error_label = f"staging tenant {h.tenant_id}"
                return
            with self._prep_lock:
                self._staging_n -= 1
                if h.tenant_id in self._cancelled_prestage:
                    self._cancelled_prestage.discard(h.tenant_id)
                    h._fail("cancelled before admission")
                elif prep is not None:
                    self._prepared.append(prep)

    def _dispatch_one(self, need_snap: bool) -> _Bundle:
        """Dispatch the next quantum (outside ``_lock``: only this thread
        changes the running set), then, under it, its bookkeeping, the
        release of the tenants it finishes, and its drain bundle
        (finalize-only entries of the tenants reaped at this boundary
        first)."""
        t_d = self._dispatch_start()
        recs, snap = self.pool.dispatch_quantum(snapshot=need_snap)
        event = None
        if self._pull_stream is not None:
            event = torch.cuda.Event()
            event.record()
        self._last_dispatch_t = time.monotonic()
        self._dispatch_ms.append((self._last_dispatch_t - t_d) * 1e3)
        q = self.pool.quantum
        with self._lock:
            entries = [(t.slot, t.handle, t.spool,
                        t.slot.start_sweep + t.slot.done_sweeps, True, False)
                       for t in self._reaped]
            self._reaped.clear()
            finished = []
            for tid, t in self._running.items():
                slot = t.slot
                slot.done_sweeps += q
                final = slot.remaining <= 0 or slot.cancelled
                entries.append((slot, t.handle, t.spool,
                                slot.start_sweep + slot.done_sweeps, final,
                                True))
                if final:
                    finished.append(tid)
            self._count_quantum()
            for tid in finished:
                self._release(self._running.pop(tid).slot)
        return _Bundle(recs, snap, event, entries)

    def _drain_bundle(self, b: _Bundle) -> None:
        """Copy a quantum's records (and snapshot) to the host on the side
        stream, after the quantum's event, then drain and finalize its
        entries in order. A failure resolves the handles it touches, and
        is raised on the dispatch thread at its next boundary."""
        host = snap = None
        err = None
        try:
            if b.recs is not None:
                fields = list(b.recs)
                tensors = list(b.recs.values()) + list(b.snap or ())
                pulled = _HostCopy(tensors, self._pull_stream,
                                   after=b.event).wait()
                host = self.pool.materialize(dict(zip(fields, pulled)))
                if b.snap is not None:
                    snap = ChainState(*pulled[len(fields):])
                b.recs = b.snap = None
        except Exception as e:  # noqa: BLE001 - raised on the dispatch side
            for entry in b.entries[b.idx:]:
                self._fail_drained(entry[1], e)
            b.idx = len(b.entries)
            err = (e, "pulling quantum records")
        t0 = time.monotonic()
        while b.idx < len(b.entries):
            slot, handle, spool, sweep_end, final, drained = \
                b.entries[b.idx]
            b.idx += 1
            try:
                if drained:
                    self._drain_tenant(
                        slot, handle, spool, host, sweep_end,
                        state_fn=lambda s=slot:
                        self.pool.tenant_state_from(snap, s))
                if final:
                    self._finalize(_Tenant(slot, handle, spool))
            except Exception as e:  # noqa: BLE001 - raised below
                self._fail_drained(handle, e)
                err = err or (e, f"draining tenant {handle.tenant_id}")
        if host is not None:
            self._drain_ms.append((time.monotonic() - t0) * 1e3)
        if err is not None:
            self._worker_error, self._worker_error_label = err

    def _drain_item(self, item: Optional[_Bundle]) -> None:
        """Drain one queued item (the drain worker's body; also the inline
        flush's) and free its slot."""
        try:
            if item is not None:
                self._drain_bundle(item)
        finally:
            if item is not None:
                self._inflight.release()
            self._drainq.task_done()

    def _drain_worker(self) -> None:
        while True:
            item = self._drainq.get()
            try:
                self._drain_item(item)
            except BaseException as e:
                self._worker_error = e
                self._worker_error_label = "drain worker"
                return
            if item is None:
                return

    def _stop_workers(self, timeout: Optional[float] = None) -> None:
        self._workers_stop.set()
        self._stage_wake.set()
        if self._drain_thread is not None:
            if self._drain_thread.is_alive():
                self._drainq.put(None)
                self._drain_thread.join(timeout)
            self._drain_thread = None
        if self._stage_thread is not None:
            self._stage_thread.join(timeout)
            self._stage_thread = None

    def _ensure_workers(self) -> None:
        self._workers_stop.clear()
        if self._drain_thread is None or not self._drain_thread.is_alive():
            self._drain_thread = threading.Thread(
                target=self._drain_worker, name="serve-drain", daemon=True)
            self._drain_thread.start()
        if self._stage_thread is None or not self._stage_thread.is_alive():
            self._stage_thread = threading.Thread(
                target=self._stage_worker, name="serve-stage", daemon=True)
            self._stage_thread.start()

    def _raise_worker_error(self) -> None:
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            label, self._worker_error_label = self._worker_error_label, ""
            raise RuntimeError(f"serve worker failed ({label})") from err

    def _wait_inflight(self) -> None:
        """Bounded run-ahead: take a drain slot before dispatching, waiting
        while ``MAX_INFLIGHT`` bundles are undrained (outside ``_lock``,
        so the drain never waits on the dispatch thread)."""
        while not self._inflight.acquire(timeout=0.05):
            self._raise_worker_error()
            th = self._drain_thread
            if th is None or not th.is_alive():
                self._flush_drains()

    def _pipeline_idle(self) -> bool:
        """Nothing running, waiting to be drained, queued or staged. The
        drains are checked first: one that requeues a preempted tenant
        does so before it counts as done."""
        if self._running or self._reaped or self._drainq.unfinished_tasks:
            return False
        with self._prep_lock:
            return not (self._staging_n or self._prepared or len(self.queue))

    def _run_pipelined(self, idle_exit: bool, poll_s: float,
                       on_quantum) -> None:
        self._ensure_workers()
        try:
            self._pipeline_loop(idle_exit, poll_s, on_quantum)
        finally:
            # hand back with every dispatched quantum drained and no
            # worker left running
            self._flush_drains()
            self._stop_workers()
        self._raise_worker_error()

    def _pipeline_loop(self, idle_exit: bool, poll_s: float,
                       on_quantum) -> None:
        while not self._stop.is_set():
            self._raise_worker_error()
            self._wait_inflight()
            bundle = None
            with self._lock:
                self._reaped.extend(self._reap_decided())
                t0 = time.monotonic()
                self._apply_admissions()
                self._admit_apply_ms.append((time.monotonic() - t0) * 1e3)
                have_work = bool(self._running)
                need_snap = any(t.spool is not None
                                for t in self._running.values())
                if not have_work and self._reaped:
                    entries = [(t.slot, t.handle, t.spool,
                                t.slot.start_sweep + t.slot.done_sweeps,
                                True, False) for t in self._reaped]
                    self._reaped.clear()
                    bundle = _Bundle(None, None, None, entries)
            if have_work:
                bundle = self._dispatch_one(need_snap)
            if bundle is not None:
                self._drainq.put(bundle)
            else:
                self._inflight.release()
            if on_quantum is not None:
                on_quantum(self)
            if not have_work:
                if idle_exit and self._pipeline_idle():
                    break
                time.sleep(poll_s)

    def _flush_drains(self) -> None:
        """Wait until every queued bundle is drained: by the drain worker
        while it lives, else inline on this thread (so a dead worker
        never leaves the flush waiting)."""
        while self._drainq.unfinished_tasks:
            th = self._drain_thread
            if th is not None and th.is_alive():
                time.sleep(0.002)
                continue
            try:
                item = self._drainq.get_nowait()
            except _queue.Empty:
                break
            self._drain_item(item)

    # ------------------------------------------------------------------
    # drivers
    # ------------------------------------------------------------------

    def run(self, idle_exit: bool = True, poll_s: float = 0.02,
            on_quantum=None) -> None:
        """Serve quanta until :meth:`close` (or, with ``idle_exit``, until
        the pool, the queue, the staging window and the drains are empty)
        with the executor ``pipeline`` picked. ``on_quantum(server)`` is
        called on this thread after every boundary."""
        self._driver = threading.current_thread()
        try:
            if self.pipeline:
                self._run_pipelined(idle_exit, poll_s, on_quantum)
                return
            while not self._stop.is_set():
                had_work = self.step()
                if on_quantum is not None:
                    on_quantum(self)
                if not had_work:
                    if idle_exit:
                        return
                    time.sleep(poll_s)
        finally:
            self._driver = None

    def start(self) -> None:
        """Run the server on a thread of its own until :meth:`close`."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, kwargs={"idle_exit": False}, name="serve",
            daemon=True)
        self._thread.start()

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the server: the driving thread of :meth:`start` ends after
        its boundary, the drains of dispatched quanta flush (no
        spool checkpoint is lost), the workers end, and every handle
        still owned resolves: queued and staged jobs as rejected, running
        ones with a :class:`TenantError` carrying their served prefix.
        ``timeout`` bounds each thread join."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self._flush_drains()
        self._stop_workers(timeout)
        self._fail_all_outstanding("server closed")

    def _fail_all_outstanding(self, reason: str) -> None:
        while True:
            h = self.queue.pop_next()
            if h is None:
                break
            h._fail(f"cancelled before admission: {reason}")
        with self._prep_lock:
            prepared, self._prepared = self._prepared, []
        for p in prepared:
            p.handle._fail(f"cancelled before admission: {reason}")
        with self._lock:
            running = list(self._running.values()) + self._reaped
            self._running.clear()
            self._reaped = []
            for t in running:
                if t.slot.tenant_id in self.pool._slots:
                    self._release(t.slot)
        for t in running:
            partial = None
            if t.spool is not None:
                t.spool.close()
                if t.slot.done_sweeps:
                    partial = load_spool(t.handle.request.spool_dir)
            elif t.handle._cols:
                partial = self.pool.result(
                    {f: np.concatenate(c)
                     for f, c in t.handle._cols.items()})
            t.handle._fail_tenant(TenantError(
                t.slot.tenant_id, reason, where="close", partial=partial))

    # ------------------------------------------------------------------
    # the scheduling surface
    # ------------------------------------------------------------------

    def _sched_block(self) -> dict:
        return {
            "policy": self.scheduler,
            "age_boost_s": self.age_boost_s,
            "preemptions": self._preemptions,
            "sheds": self._sheds,
            "sheds_by_tier": {str(k): v for k, v in
                              sorted(self._sheds_by_tier.items())},
            "queue_tiers": {str(k): v for k, v in
                            sorted(self.queue.depth_by_tier().items())},
            "queue_max": self.queue.maxsize,
            "queue_depth_peak": self._queue_depth_peak,
        }

    def _slo_block(self) -> dict:
        return {"admission_ms": _percentiles(self._admission_ms),
                "first_result_ms": _percentiles(self._first_result_ms)}

    def status(self) -> dict:
        """A live snapshot: pool geometry and occupancy, queue and staging
        depth, the scheduling counters, latency percentiles, and one entry
        per running tenant."""
        with self._lock:
            running = list(self._running.values())
            with self._prep_lock:
                staged = len(self._prepared) + self._staging_n
            busy = sum(t.slot.nchains for t in running)
            tenants = []
            for t in running:
                p = t.handle.progress()
                p.update({"lane0": int(t.slot.lanes[0]),
                          "lane_groups": len(t.slot.lanes) // self.pool.group,
                          "cancelled": bool(t.slot.cancelled)})
                tenants.append(p)
            return {
                "schema": 1,
                "t": time.time(),
                "uptime_s": time.monotonic() - self._t_started,
                "quanta": self.quanta,
                "nlanes": self.pool.nlanes,
                "group": self.pool.group,
                "quantum": self.pool.quantum,
                "busy_lanes": busy,
                "free_groups": len(self._free_groups),
                "occupancy_now": busy / self.pool.nlanes,
                "occupancy": (self.busy_chain_sweeps / self.total_lane_sweeps
                              if self.total_lane_sweeps else 0.0),
                "queue_depth": len(self.queue),
                "staged": staged,
                "pipeline": self.pipeline,
                "sched": self._sched_block(),
                "slo": self._slo_block(),
                "tenants": tenants,
            }

    def summary(self) -> dict:
        """Run-level serving numbers: ``occupancy`` is the chain-lane
        sweeps served over the lane sweeps advanced; ``busy_chain_sweeps``
        the sum over served tenants of chains x sweeps; ``host_ms`` the
        per-quantum host ms of admission, the dispatch (serial: until the
        records are on the host), the drain (after the records are on the
        host) and the gap from one dispatch's end to the next one's start;
        ``sched`` the scheduling counters."""
        occ = (self.busy_chain_sweeps / self.total_lane_sweeps
               if self.total_lane_sweeps else 0.0)
        return {"nlanes": self.pool.nlanes, "quantum": self.pool.quantum,
                "quanta": self.quanta, "occupancy": occ,
                "busy_chain_sweeps": self.busy_chain_sweeps,
                "pipeline": self.pipeline,
                "admission_ms": (float(np.mean(self._admission_ms))
                                 if self._admission_ms else None),
                "host_ms": {"admission": _percentiles(self._admit_apply_ms),
                            "dispatch": _percentiles(self._dispatch_ms),
                            "drain": _percentiles(self._drain_ms),
                            "dispatch_gap": _percentiles(self._gap_ms)},
                "sched": self._sched_block(),
                "slo": self._slo_block()}
