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

Fault containment (``supervise=True``, the default; the JAX server's
``GST_SERVE_SUPERVISE=auto``): a failure that belongs to one tenant (its
``on_chunk`` callback raising, its spool write failing, the drain thread
dying in its entry) fails only that tenant. Its lanes freeze and release
at the next boundary, as a cancel's do, and its handle resolves to a
:class:`TenantError` carrying the cause and the prefix drained before it
(bitwise the uninterrupted run's first rows); a supervisor restarts a dead
staging or drain thread with a capped backoff, and only a worker past its
restart budget, or a failure of the pool itself, fails every tenant. A
drain thread that died in a bundle leaves the rest of that bundle to its
successor, so no other tenant loses a quantum. Lane health: at each
boundary the previous quantum's sticky ``diverged`` telemetry flags are
folded, and a tenant's ``on_divergence`` policy fails it, quarantines the
diverged chains or re-draws them from the prior; the fold waits for that
quantum only while some running tenant has a policy. ``supervise=False``
keeps the fail-fast reference: the failure fails its tenant and then the
run. The injection points of serve/faults.py make each path reproducible.

Crash recovery: with ``manifest_dir``, the server journals its geometry,
admissions, spool checkpoints, completions and containment events to an
append-only manifest (serve/manifest.py), and :meth:`ChainServer.recover`
rebuilds the pool after a process kill and resubmits every spooled tenant
from its last checkpoint, bitwise its uninterrupted run.

The observability plane: a request's ``monitor`` streams its ESS and
split-R-hat from the drained rows (serve/monitor.py; ``progress()``), and
``on_converged="evict"`` ends a converged tenant at the next boundary.
``spans`` records each staging, admission, dispatch, drain and finalize
step per tenant (obs/spans.py; :meth:`ChainServer.export_trace`); each
quantum's dispatch wall is attributed to its tenants by active-lane share
(``TenantHandle.cost()``); ``obs_dir`` refreshes ``status.json`` and
``metrics.prom`` at each quantum; the flight recorder (obs/flight.py)
keeps the last quanta, events and heartbeats and dumps a postmortem on a
pool failure, a contained tenant fault, a watchdog trip, SIGTERM or exit;
the watchdog (obs/watchdog.py) trips on a stalled dispatch, a growing
drain backlog or a throughput collapse, and :meth:`ChainServer.healthz`
reports it without taking the server lock. The plane adds no device work:
chains and launches are the same with it on or off.

The capacity arms, each gated as in the JAX server:

- **Recycling** (``recycle``; ``GST_RECYCLE``, auto -> on;
  parallel/recycle.py): the drain tags the partial-scan states each sweep
  already computed as recycled rows (rebuilt from adjacent recorded rows,
  so no device work), streams a ``row_class`` array beside each
  quantum's records, counts them per tenant (quarantined lanes excluded)
  and folds them into the monitor's weighted moments. Chains, spool bytes
  and scan-end rows are bitwise the same on or off.
- **Warm starts** (``TenantRequest.warm_start``; ``GST_WARM_START``;
  serve/warm.py): the pipelined executor serves each warm tenant's pilot
  on the pool itself, as an internal tenant that neither the manifest nor
  the SLO series sees, together with the pilots of warm tenants queued
  behind it (one wave, one wait); the serial executor runs a standalone
  pilot. The fit is journaled in the manifest's admit record, so
  ``recover`` replays the init without a pilot. A failed pilot degrades
  the tenant to the cold init.
- **Adaptive block scans** (``TenantRequest.adapt_scan``;
  ``GST_ADAPT_SCAN``; serve/adapt.py): at each drain boundary a monitored
  tenant's converged white and hyper blocks thin to a learned selection
  probability, and its gates, drawn from ``(seed, tenant, sweep)``, go to
  the pool's lanes for the next dispatch.

The wire for one pool: ``http_port`` mounts the read-only HTTP endpoints
(obs/http.py: ``/healthz``, ``/status``, ``/metrics``, ``/trace``,
``/tenants/<id-or-name>/progress``, ``/postmortem``) on the in-memory
forms of what ``obs_dir``, :meth:`export_trace` and
:meth:`dump_postmortem` write; serve/rpc.py's ``RpcServer`` mounts the
mutating edge beside a server, and serve/pool_main.py runs one server as
a worker process behind both. A request's ``trace_id`` tags every span the
server records for its tenant, rides ``progress()`` and the manifest, and
is restored by :meth:`recover`; chains do not depend on it.

The fleet: serve/router.py's ``FleetRouter`` places tenants on several
such servers (in process, or workers), fails a dead worker over through
its manifest and :meth:`recover`, and migrates tenants between them live
(a cancel at the next boundary, then ``resume_spool`` on the target).

Record tiers and heterogeneous pools (serve/pool.py): the pool's quanta
reach the drain in the tier's wire dtypes (``record="compact8"`` by
default, as in the JAX server). An in-memory tenant keeps its lanes'
narrow slices and is turned into float32 once, when its result is built;
a spooled tenant and an ``on_chunk`` callback get float32 records each
quantum, as the spool files and the wire's result frames hold them. A
heterogeneous pool (``heterogeneous=True``; the JAX server reads the
pool's flag and takes no argument) admits a tenant with fewer TOAs than
the template, padded with masked rows; its records and ``stats["n_toa"]``
are its own TOA count's.

The profiling plane: ``kernel_timers`` (``"auto"`` follows
``GST_KERNEL_TIMERS``, auto -> off, where the JAX server's auto is on: a
bracket here costs the host microseconds, not an rdtsc read; ``True``
turns them on) holds the sweep's stage timers up from construction to
:meth:`ChainServer.close` (ops/timers.py: a CUDA event pair around each
stage of every sweep on the card, a host clock on the CPU; the flag is
process-global and counts its holders). At each drain, once the quantum's records
are on the host, the server differences the timers' cumulative snapshot
and folds the delta into ``summary()["stages"]`` and ``status()["stages"]``
(per stage: total ms, ms a counted quantum, share of the dispatch wall),
into each tenant's ``cost()["stage_device_ms"]`` (split by active lanes,
as ``device_ms`` is; the shares add up to the totals) and into the flight
ring's ``stage_device_ms`` (the flight context carries
``stage_totals_ms`` and ``kernel_timers``). An event pair measures the
stream's time between two points, the stream's idle waits for the host
included: on a host-bound pool a stage's ms are mostly that wait. Under
the pipelined executor the next quantum may already have recorded
brackets when a drain reads, so a quantum's delta can lend a sliver to its
neighbour; the totals are exact. The timers are the process's, not the
server's: where several servers (a ``LocalPool`` fleet) or a server and a
``TorchGibbs`` sweep in one process, each server's deltas take in the
others' brackets too. ``/status`` over HTTP and a worker
process carry the block through ``status()``; the fleet's merged snapshot
(obs/aggregate.py) keeps the JAX one's placement subset, which has no
``stages``.

Not ported from the JAX server: the persistent compile cache of
``recover``.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import queue as _queue
import signal
import tempfile
import threading
import time
import warnings
import weakref
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
from gibbs_student_t_tpu_torch.obs.export import (
    prometheus_text,
    write_prometheus,
)
from gibbs_student_t_tpu_torch.obs.flight import FlightRecorder
from gibbs_student_t_tpu_torch.obs.health import chain_health
from gibbs_student_t_tpu_torch.obs.http import ObsHttpServer
from gibbs_student_t_tpu_torch.obs.metrics import MetricsRegistry, _jsonable
from gibbs_student_t_tpu_torch.obs.spans import (
    ROLE_DISPATCH,
    ROLE_DRAIN,
    ROLE_STAGING,
    SpanRecorder,
)
from gibbs_student_t_tpu_torch.obs.telemetry import Telemetry
from gibbs_student_t_tpu_torch.obs.watchdog import (
    Watchdog,
    WatchdogSpec,
    serve_watchdog_env,
)
from gibbs_student_t_tpu_torch.ops import timers as _timers
from gibbs_student_t_tpu_torch.ops.rng import check_counter
from gibbs_student_t_tpu_torch.parallel.ensemble import (
    _localize_names,
    _structure,
    check_kernel_structure,
    pad_model_arrays,
)
from gibbs_student_t_tpu_torch.parallel.recycle import row_class_pattern
from gibbs_student_t_tpu_torch.serve import adapt as _adapt
from gibbs_student_t_tpu_torch.serve import faults as _faults
from gibbs_student_t_tpu_torch.serve.manifest import (
    ServerManifest,
    load_server_state,
    load_tenant_model,
    outstanding_tenants,
)
from gibbs_student_t_tpu_torch.serve.monitor import (
    MonitorSpec,
    TenantMonitor,
    resolve_params,
)
from gibbs_student_t_tpu_torch.serve.pool import SlotPool, TenantSlot
from gibbs_student_t_tpu_torch.serve.scheduler import (
    CONVERGED_POLICIES,
    DIVERGENCE_POLICIES,
    AdmissionQueue,
    DeadlineExceeded,
    QueueFull,
    RetryAfter,
    TenantError,
    TenantHandle,
    TenantRequest,
    schedule_score,
)
from gibbs_student_t_tpu_torch.serve.warm import (
    WarmStartFit,
    WarmStartSpec,
    fit_from_rows,
    fit_warm_start,
    resolve_warm_start,
)
from gibbs_student_t_tpu_torch.utils.env import env_choice
from gibbs_student_t_tpu_torch.utils.spool import (
    ChainSpool,
    load_spool,
    load_spool_prefix,
    load_spool_state,
)


def serve_recycle_env() -> str:
    """The validated ``GST_RECYCLE`` (``auto`` when unset), strictly
    ``auto|1|0``: recycling Gibbs row tagging in the drain
    (parallel/recycle.py). ``auto`` resolves to on; a set value overrides
    the constructor's ``recycle``. ``0`` is today's drain: no tag, no
    count, no weighting, no new key in records, stats or spools."""
    return env_choice("GST_RECYCLE")


@dataclass
class _Prepared:
    """A staged tenant: what admission needs except its lanes.
    ``warm_fit`` is the fit whose draws made ``state`` (None: cold),
    journaled at admission; ``n_real`` the tenant's own TOA count."""

    handle: TenantHandle
    backend: TorchGibbs
    state: object
    groups_needed: int
    monitor: Optional[TenantMonitor] = None
    warm_fit: Optional[WarmStartFit] = None
    n_real: Optional[int] = None


@dataclass
class _Tenant:
    """A running tenant's entry. ``backend`` is kept only for an
    ``on_divergence="reinit"`` tenant (its prior re-draw)."""

    slot: TenantSlot
    handle: TenantHandle
    spool: Optional[ChainSpool] = None
    backend: Optional[TorchGibbs] = None


@dataclass
class _Bundle:
    """One quantum's deferred drain. ``entries`` rows are ``(slot, handle,
    spool, sweep_end, final, drained)``: ``drained`` False marks a
    finalize-only entry (a tenant released at a boundary after its last
    records rode an earlier bundle). ``tl`` is the quantum's telemetry;
    ``event`` follows the quantum on the device (None on the CPU);
    ``idx`` is the next entry to drain; ``host`` the pulled records,
    telemetry and snapshot, kept for a drain that resumes the bundle.
    ``qidx`` is the quantum's index; ``cost`` its dispatch wall and the
    ``(handle, active lanes)`` shares it is attributed by, consumed once
    by the drain."""

    recs: Optional[Dict[str, torch.Tensor]]
    tl: Optional[Telemetry]
    snap: Optional[ChainState]
    event: object
    entries: list
    idx: int = 0
    host: Optional[tuple] = None
    qidx: Optional[int] = None
    cost: Optional[tuple] = None


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

    ``nlanes``, ``quantum``, ``record`` (the tier, ``"compact8"`` by
    default), ``heterogeneous`` and ``device`` configure the pool
    (serve/pool.py);
    ``max_queue`` bounds the admission queue, and ``backpressure`` says
    what :meth:`submit` does when it is full: ``"reject"`` sheds at once,
    ``"block"`` waits for room (with no other thread driving the server,
    it serves quanta itself until a queued job is admitted), and sheds if
    none frees. ``scheduler`` is ``"fifo"`` (arrival order, first fit) or
    ``"priority"`` (:func:`schedule_score`, with lossless preemption);
    ``age_boost_s`` is the priority scheduler's starvation bound: a queued
    job gains one tier for each that many seconds waited. ``pipeline``
    picks the executor :meth:`run` uses (True: pipelined; False: the
    serial loop), and ``prefetch`` bounds the staged-tenant window.
    ``telemetry`` carries the pool's per-lane telemetry (the lane-health
    policies need it); ``supervise`` picks fault containment (True) or the
    fail-fast reference (False); ``manifest_dir`` journals the server to
    a crash-recovery manifest there (:meth:`recover`).

    The observability plane, with the JAX server's names and defaults:
    ``spans`` (on) records per-tenant executor spans into a ring of
    ``span_capacity`` (and the ``trace_jsonl`` sink), exported by
    :meth:`export_trace`; ``obs_dir`` refreshes ``status.json`` (the
    :meth:`status` snapshot) and ``metrics.prom`` (the Prometheus text of
    ``metrics``, a :class:`MetricsRegistry` made in memory when none is
    given) at every quantum; ``flight`` (on) keeps a ring of
    ``flight_capacity`` quanta, synced without spans to
    ``<flight_dir>/flight.json`` every ``flight_sync_every`` quanta
    (``flight_dir`` defaults to ``obs_dir``, then ``manifest_dir``) and
    dumped in full to ``postmortem.json`` by :meth:`dump_postmortem`;
    ``http_port`` (None: off; 0: an ephemeral port, read back from
    ``server.http.port``) serves the plane over HTTP on ``http_host``
    (obs/http.py); a bind failure warns and the server runs without it.
    ``watchdog`` (``"auto"`` follows ``GST_SERVE_WATCHDOG``, auto ->
    ``"dump"``; ``False`` turns it off; ``"warn"``, ``"dump"`` or
    ``"fail"`` set the trip policy, which a set ``GST_SERVE_WATCHDOG``
    overrides) runs the stall watchdog with the
    thresholds of ``watchdog_spec``.

    ``kernel_timers`` (``"auto"`` follows ``GST_KERNEL_TIMERS``, auto ->
    off; ``True`` or ``False``, which a set ``GST_KERNEL_TIMERS``
    overrides): on, the server holds the process-global stage-timer flag
    up from construction until :meth:`close` (see the module docstring);
    off, it leaves the flag as it is and reports no stages.

    ``recycle`` (``"auto"`` follows ``GST_RECYCLE``, auto -> on; ``True``
    or ``False``, which a set ``GST_RECYCLE`` overrides) arms recycling's
    row tagging (see the module docstring); warm starts and adaptive scans
    ride the requests."""

    #: quanta dispatched and not yet drained, at most
    MAX_INFLIGHT = 2
    #: restarts of one worker kind before its death is a pool failure
    MAX_WORKER_RESTARTS = 5

    def __init__(self, template_ma: ModelArrays, config: GibbsConfig,
                 nlanes: int = 1024, quantum: int = 25,
                 record: str = "compact8", device=None, max_queue: int = 64,
                 backpressure: str = "block", pipeline: bool = True,
                 prefetch: int = 2, scheduler: str = "fifo",
                 age_boost_s: float = 30.0, telemetry: bool = True,
                 supervise: bool = True,
                 manifest_dir: Optional[str] = None, metrics=None,
                 spans: bool = True, span_capacity: int = 65536,
                 trace_jsonl: Optional[str] = None,
                 obs_dir: Optional[str] = None,
                 http_port: Optional[int] = None,
                 http_host: str = "127.0.0.1", watchdog="auto",
                 watchdog_spec: Optional[WatchdogSpec] = None,
                 flight: bool = True, flight_dir: Optional[str] = None,
                 flight_capacity: int = 64, flight_sync_every: int = 4,
                 kernel_timers="auto", recycle="auto",
                 heterogeneous: bool = False):
        if pipeline not in (True, False):
            raise ValueError(f"pipeline must be True or False, got "
                             f"{pipeline!r}")
        if supervise not in (True, False):
            raise ValueError(f"supervise must be True or False, got "
                             f"{supervise!r}")
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        if scheduler not in ("fifo", "priority"):
            raise ValueError(f"scheduler must be 'fifo' or 'priority', "
                             f"got {scheduler!r}")
        if watchdog not in ("auto", False, "warn", "dump", "fail"):
            raise ValueError(
                f"watchdog must be 'auto', False, 'warn', 'dump' or "
                f"'fail', got {watchdog!r}")
        wd_env = serve_watchdog_env()
        if recycle not in ("auto", True, False):
            raise ValueError(f"recycle must be 'auto', True or False, got "
                             f"{recycle!r}")
        if kernel_timers not in ("auto", True, False):
            raise ValueError(f"kernel_timers must be 'auto', True or False, "
                             f"got {kernel_timers!r}")
        # the stage timers (ops/timers.py) follow GST_KERNEL_TIMERS, then
        # the argument (auto -> off). On, the server holds the
        # process-global flag until close, or until it is collected unclosed
        kt_env = _timers.kernel_timers_env()
        self.kernel_timers = (kt_env == "1" if kt_env != "auto"
                              else kernel_timers is True)
        self._timers_hold = None
        if self.kernel_timers:
            _timers.timers_acquire()
            self._timers_hold = weakref.finalize(self, _timers.timers_release)
        rec_env = serve_recycle_env()
        self.recycle = (rec_env == "1" if rec_env != "auto"
                        else recycle in ("auto", True))
        self.config = config
        self.pipeline = bool(pipeline)
        self.supervise = bool(supervise)
        self.scheduler = scheduler
        self.age_boost_s = float(age_boost_s)
        self.queue = AdmissionQueue(
            max_queue, backpressure,
            score=(None if scheduler == "fifo" else
                   (lambda h: schedule_score(h,
                                             age_boost_s=self.age_boost_s))))
        self.pool = SlotPool(template_ma, config, nlanes=nlanes,
                             quantum=quantum, device=device, record=record,
                             telemetry=telemetry, heterogeneous=heterogeneous)
        # the dispatch thread's state; reentrant, so a callback on the
        # serial path may read status()
        self._lock = threading.RLock()
        self._running: Dict[int, _Tenant] = {}
        # every handle this server made, by tenant id (the wire's and the
        # HTTP endpoints' lookup by id or name)
        self._handles: Dict[int, TenantHandle] = {}
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
        # fault containment: each worker kind's restarts and the earliest
        # time of its next one; the bundle a dead drain thread left for
        # its successor
        self._restarts = {"drain": {"n": 0, "next_t": 0.0},
                          "stage": {"n": 0, "next_t": 0.0}}
        self._resume_bundle: Optional[_Bundle] = None
        self._fault_counts = {"tenant_failures": 0, "quarantined_lanes": 0,
                              "reinits": 0, "worker_restarts": 0,
                              "pool_failures": 0}
        # the lane-health fold: the last quantum's telemetry (host arrays
        # on the serial loop, device tensors when pipelined) and the
        # tenants that quantum advanced (one admitted after it must not
        # inherit its lanes' previous owner's flags)
        self._last_tl = None
        self._last_tl_tids: set = set()
        # the crash-recovery manifest; the jobs recover() could not resume
        self._manifest = None
        self.lost_tenants: List[dict] = []
        if manifest_dir is not None:
            self._manifest = ServerManifest(manifest_dir)
            self._manifest.record_server(template_ma, config, {
                "nlanes": nlanes, "quantum": quantum, "record": record,
                "heterogeneous": self.pool.heterogeneous,
                "max_queue": max_queue, "backpressure": backpressure,
                "telemetry": bool(telemetry), "scheduler": scheduler})
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
        # the warm-start fits a pilot wave made for tenants still queued
        self._pilot_fits: Dict[int, WarmStartFit] = {}
        self._zero_capacity_counters()
        self._init_plane(metrics, spans, span_capacity, trace_jsonl,
                         obs_dir, manifest_dir, wd_env, watchdog,
                         watchdog_spec, flight, flight_dir, flight_capacity,
                         flight_sync_every)
        # the read-only HTTP endpoints on a daemon thread; a failure to
        # mount them warns and the server serves without them
        self.http = None
        if http_port is not None:
            try:
                self.http = ObsHttpServer(
                    host=http_host, port=http_port,
                    status_fn=self.status, healthz_fn=self.healthz,
                    metrics_fn=self._metrics_text,
                    trace_fn=self._trace_doc,
                    progress_fn=self._tenant_progress,
                    postmortem_fn=self._postmortem_doc)
            except Exception as e:  # noqa: BLE001 - observability contract
                warnings.warn(
                    f"observability HTTP server failed to start on "
                    f"{http_host}:{http_port} ({type(e).__name__}: {e}); "
                    "serving continues without the endpoints",
                    RuntimeWarning)

    def _init_plane(self, metrics, spans, span_capacity, trace_jsonl,
                    obs_dir, manifest_dir, wd_env, watchdog, watchdog_spec,
                    flight, flight_dir, flight_capacity,
                    flight_sync_every) -> None:
        """The plane's state: the metrics registry, the span ring, the
        pull surface, the per-tenant SLO and cost series, the flight
        recorder with its exit hooks, and the watchdog."""
        if obs_dir is not None and metrics is None:
            metrics = MetricsRegistry()    # the exposition needs one
        self.metrics = metrics
        # the pool's first-quantum record goes to the same registry
        self.pool.metrics = metrics
        self.spans = (SpanRecorder(capacity=span_capacity,
                                   jsonl_path=trace_jsonl, metrics=metrics)
                      if spans else None)
        self.obs_dir = obs_dir
        if obs_dir is not None:
            os.makedirs(obs_dir, exist_ok=True)
        self._obs_warned = False
        self._tenant_names: Dict[int, object] = {}
        self._converged_ms: List[float] = []
        # tier -> leg -> ms (the per-priority SLO series)
        self._tier_slo: Dict[int, Dict[str, List[float]]] = {}
        self._converged_evictions = 0
        # the sum of the quanta's dispatch walls, which the tenants' cost
        # shares add up to
        self._dispatch_wall_ms = 0.0
        # the stage timers' accounting: the cumulative snapshot is
        # differenced at each drain, once the quantum's records are on the
        # host (one writer: the drain thread, or the serial loop's)
        self._reset_stages()
        # host ms of the plane's own work: the monitor feed (a drained
        # quantum, all its tenants) and the obs_dir refresh
        self._monitor_ms: List[float] = []
        self._refresh_ms: List[float] = []
        self._monitor_t = 0.0
        self._flight_dir = flight_dir or obs_dir or manifest_dir
        self.flight = None
        self._atexit_registered = False
        self._sigterm_prev = None
        if flight:
            sync_path = (os.path.join(self._flight_dir, "flight.json")
                         if self._flight_dir is not None else None)
            self.flight = FlightRecorder(
                capacity=flight_capacity, sync_path=sync_path,
                sync_every=flight_sync_every,
                context_fn=self._flight_context,
                spans_fn=(self.spans.spans if self.spans is not None
                          else None))
            # evidence on the way down: atexit covers a normal exit,
            # SIGTERM a polite kill; os._exit skips both, which the
            # periodic flight.json sync covers. close() undoes both
            atexit.register(self._atexit_dump)
            self._atexit_registered = True
            try:
                if (threading.current_thread() is threading.main_thread()
                        and signal.getsignal(signal.SIGTERM)
                        == signal.SIG_DFL):
                    self._sigterm_prev = signal.signal(
                        signal.SIGTERM, self._on_sigterm)
            except (ValueError, OSError):
                pass   # not installable here; atexit and the sync remain
        if wd_env != "auto":
            policy = None if wd_env == "0" else wd_env
        elif watchdog is False:
            policy = None
        else:
            policy = "dump" if watchdog == "auto" else watchdog
        self._watchdog = None
        # the stall detector owes heartbeats only while a driver is inside
        # run(): an idle server with parked tenants is not stalled
        self._driving = False
        if policy is not None:
            self._watchdog = Watchdog(
                policy=policy, spec=watchdog_spec,
                active_fn=lambda: self._driving and bool(self._running),
                on_trip=self._watchdog_trip)

    def reset_counters(self) -> None:
        """Zero the run-level aggregates (a benchmark's warm-up boundary)
        without touching tenants or the pool."""
        self.quanta = 0
        self.busy_chain_sweeps = 0
        self.total_lane_sweeps = 0
        for series in (self._admission_ms, self._first_result_ms,
                       self._converged_ms, self._admit_apply_ms,
                       self._dispatch_ms, self._drain_ms, self._gap_ms,
                       self._monitor_ms, self._refresh_ms):
            series.clear()
        self._last_dispatch_t = None
        self._dispatch_wall_ms = 0.0
        for k in self._fault_counts:
            self._fault_counts[k] = 0
        self._converged_evictions = 0
        self._preemptions = 0
        self._sheds = 0
        self._sheds_by_tier = {}
        self._queue_depth_peak = 0
        self._tier_slo = {}
        self._zero_capacity_counters()
        self._reset_stages()

    def _reset_stages(self) -> None:
        """Restart the stage accounting from the timers' current snapshot,
        so that nothing recorded before (a warm-up's sweeps) leaks into the
        window."""
        self._stage_prev = (_timers.timers_snapshot() if self.kernel_timers
                            else {})
        self._stage_ms_total: Dict[str, float] = {}
        self._stage_quanta = 0
        self._last_stage_ms: Dict[str, float] = {}

    def _zero_capacity_counters(self) -> None:
        """The capacity arms' counters: recycled chain-rows delivered; warm
        starts served, degraded to cold, their pilots' wall, the pilot
        waves and the fits served from a wave; flow fits and flow requests
        served the mixture; the adaptive scan's gate updates and the
        tenants ever thinned."""
        self._recycled_lane_rows = 0
        self._warm_starts = 0
        self._warm_degraded = 0
        self._warm_pilot_ms = 0.0
        self._warm_pilot_batches = 0
        self._warm_pilot_batched = 0
        self._warm_flow_fits = 0
        self._warm_flow_degraded = 0
        self._adapt_updates = 0
        self._adapt_tenants: set = set()

    def _span(self, name: str, role: str, tenant=None,
              quantum: Optional[int] = None):
        """A span context of the recorder, or a null context with spans
        off."""
        if self.spans is None:
            return contextlib.nullcontext()
        return self.spans.span(name, role, tenant=tenant, quantum=quantum)

    def _tier_leg(self, request, leg: str) -> List[float]:
        """The per-tier SLO series of one leg (made at first use)."""
        legs = self._tier_slo.setdefault(
            int(request.priority), {"admission_ms": [],
                                    "first_result_ms": [],
                                    "converged_ms": []})
        return legs[leg]

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
        if request.on_divergence not in DIVERGENCE_POLICIES:
            raise ValueError(
                f"on_divergence must be one of {DIVERGENCE_POLICIES}, "
                f"got {request.on_divergence!r}")
        if (request.monitor is not None
                and not isinstance(request.monitor, MonitorSpec)):
            raise ValueError(
                f"monitor must be a serve.monitor.MonitorSpec or None, "
                f"got {type(request.monitor).__name__}")
        if request.on_converged not in CONVERGED_POLICIES:
            raise ValueError(
                f"on_converged must be one of {CONVERGED_POLICIES}, "
                f"got {request.on_converged!r}")
        if request.on_converged == "evict":
            mon = request.monitor
            if mon is None or (mon.ess_target is None
                               and mon.rhat_target is None):
                raise ValueError(
                    "on_converged='evict' needs a monitor with an armed "
                    "target (ess_target and/or rhat_target): the "
                    "streaming convergence verdict triggers the eviction")
        if request.warm_start is not None and not isinstance(
                request.warm_start, (WarmStartSpec, WarmStartFit, dict)):
            raise ValueError(
                "warm_start must be a serve.warm.WarmStartSpec, a "
                "WarmStartFit (or its journaled JSON dict), or None, got "
                f"{type(request.warm_start).__name__}")
        if request.adapt_scan is not None:
            if not isinstance(request.adapt_scan, _adapt.AdaptScanSpec):
                raise ValueError(
                    "adapt_scan must be a serve.adapt.AdaptScanSpec or "
                    f"None, got {type(request.adapt_scan).__name__}")
            mon = request.monitor
            if mon is None:
                raise ValueError(
                    "adapt_scan needs a monitor: the per-block ESS the "
                    "policy thins on is the streaming monitor's")
            if request.adapt_scan.ess_target is None \
                    and mon.ess_target is None:
                raise ValueError(
                    "adapt_scan needs an ESS target: set "
                    "AdaptScanSpec.ess_target or arm the monitor's "
                    "ess_target")
        if request.on_divergence != "none":
            if not self.supervise:
                raise ValueError(
                    "on_divergence policies need a supervised server "
                    "(supervise=False keeps the fail-fast reference)")
            if not self.pool.telemetry:
                raise ValueError(
                    "on_divergence policies need pool telemetry: its "
                    "sticky diverged flags are what lane health folds at "
                    "quantum boundaries")
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
        with self._lock:
            self._handles[handle.tenant_id] = handle
        if dls is not None:
            handle._deadline_sweep = request.start_sweep + dls
        if self.spans is not None:
            # registered at submit, so every span of the tenant carries it
            # (a preempted tenant's continuation keeps its handle)
            self.spans.set_trace_id(handle.tenant_id, request.trace_id)
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
            if self.metrics is not None:
                self.metrics.counter("serve_sheds_total").inc()
            handle._fail_shed(err)
            with self._lock:
                self._handles.pop(handle.tenant_id, None)
            raise err from e
        self._stage_wake.set()
        depth = len(self.queue)
        self._queue_depth_peak = max(self._queue_depth_peak, depth)
        if self.metrics is not None:
            self.metrics.gauge("serve_queue_depth").set(depth)
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
        against the template, and its initial state (the request's, or
        the solo sampler's at the same seed from ``x0``, a warm-start fit's
        draws or the prior), or None when the model does not fit the pool
        (the handle is rejected)."""
        req, pool = handle.request, self.pool
        t0 = time.monotonic()
        monitor = None
        try:
            _faults.fire("staging", tenant=handle.fault_key)
            ma = _localize_names(req.ma)
            t = pool.template_ma
            if req.monitor is not None:
                pidx = resolve_params(req.monitor, t.param_names)
                monitor = TenantMonitor(
                    req.monitor, req.nchains, pidx,
                    param_names=t.param_names,
                    blocks=_adapt.param_blocks(pidx, t.white_indices,
                                               t.hyper_indices),
                    block_names=_adapt.BLOCK_NAMES)
                if req.spool_dir is not None and req.start_sweep > 0:
                    self._backfill_monitor(monitor, req)
                # the tenant's adaptive-scan policy under GST_ADAPT_SCAN
                # (None: the full-rate scan); it acts only on gates
                handle._adapt_spec = (
                    _adapt.resolve_adapt_scan(req.adapt_scan, req.monitor)
                    if pool.adaptive else None)
            if ma.row_mask is not None:
                raise ValueError("tenant models must be unpadded; the "
                                 "pool pads to its own TOA axis")
            if pool.heterogeneous:
                if ma.n > pool.n_pool:
                    raise ValueError(
                        f"tenant n={ma.n} exceeds the pool TOA axis "
                        f"{pool.n_pool}")
            elif ma.n != pool.n_pool:
                raise ValueError(
                    f"tenant n={ma.n} != pool n={pool.n_pool}; a "
                    "homogeneous pool admits only matching TOA counts "
                    "(construct the pool with heterogeneous=True to "
                    "accept suffix-padded tenants)")
            if ma.m != t.m:
                raise ValueError(f"tenant basis size {ma.m} != pool {t.m}")
            n_real = ma.n
            if pool.heterogeneous:
                (ma,) = pad_model_arrays([ma], n_to=pool.n_pool)
            if _structure(ma) != _structure(t):
                raise ValueError(
                    "tenant model structure (parameters, noise groups, "
                    "phi blocks) differs from the pool template")
            backend = TorchGibbs(ma, self.config, nchains=req.nchains,
                                 device=pool.device, tnt_block_size=None)
            check_kernel_structure(backend, pool.drawer)
            warm_fit = None
            if req.state is not None:
                state = req.state
            else:
                x0 = req.x0
                if x0 is None:
                    warm_fit = self._warm_fit_for(handle, ma)
                    if warm_fit is not None:
                        x0 = warm_fit.draw_x0(req.nchains, req.seed,
                                              ma.specs_np)
                state = backend.init_state(x0, seed=req.seed)
        except Exception as e:  # noqa: BLE001 - reject it, keep the pool
            handle._fail(f"{type(e).__name__}: {e}")
            return None
        if self.spans is not None:
            self.spans.record("stage", ROLE_STAGING, t0,
                              time.monotonic() - t0,
                              tenant=handle.tenant_id)
        return _Prepared(handle, backend, state, self._groups_needed(handle),
                         monitor=monitor, warm_fit=warm_fit, n_real=n_real)

    def _warm_fit_for(self, handle: TenantHandle, ma):
        """The tenant's warm-start fit under ``GST_WARM_START``: a
        journaled fit replayed, a pilot's fit (served on the pool by the
        pipelined executor, standalone by the serial one), or None (cold).
        Runs inside ``_prepare``'s scope, but only an invalid
        ``warm_start`` rejects the tenant: a failed pilot or fit degrades
        it to the cold init. Sets the handle's ``warm`` view, the
        counters, and the ``warm_start`` / ``warm_start_degraded`` /
        ``warm_flow_degraded`` events."""
        if getattr(handle, "_internal", False):
            return None        # a pilot never warm-starts itself
        req = handle.request
        warm_in = resolve_warm_start(req.warm_start)   # invalid: rejects
        if warm_in is None:
            if req.warm_start is not None:
                # requested but turned off: cold, bitwise today's init
                handle.warm = {"degraded": "GST_WARM_START=0"}
            return None
        batched = False
        try:
            if isinstance(warm_in, WarmStartFit):
                fit = warm_in                 # journaled: a replay
            elif self.pipeline:
                # a wave staged for an earlier tenant may have fitted this
                # one already: then no pilot wait at all
                fit = self._pilot_fits.pop(handle.tenant_id, None)
                batched = fit is not None
                if batched:
                    self._warm_pilot_batched += 1
                else:
                    fit = self._pool_pilot_fit(handle, warm_in)
            else:
                # the serial executor stages on the driving thread: a
                # pilot served by the pool would wait on itself
                fit = fit_warm_start(ma, self.config, warm_in,
                                     seed=req.seed, device=self.pool.device)
        except Exception as e:  # noqa: BLE001 - degrade, never reject
            self._warm_degraded += 1
            handle.warm = {"degraded": f"{type(e).__name__}: {e}"}
            warnings.warn(
                f"tenant {handle.tenant_id} warm-start fit failed "
                f"({type(e).__name__}: {e}); serving from the cold prior "
                "init", RuntimeWarning)
            if self.metrics is not None:
                self.metrics.counter("serve_warm_degraded").inc()
                self.metrics.emit("warm_start_degraded",
                                  tenant=handle.tenant_id,
                                  error=f"{type(e).__name__}: {e}")
            return None
        self._warm_starts += 1
        if not batched:
            # a batched fit's pilot wall was its wave's, counted once
            self._warm_pilot_ms += fit.pilot_ms
        handle.warm = {"kind": fit.kind,
                       "pilot_sweeps": fit.pilot_sweeps,
                       "pilot_chains": fit.pilot_chains,
                       "pilot_ms": round(fit.pilot_ms, 1),
                       "replayed": fit.pilot_ms == 0.0,
                       "batched": batched}
        if fit.kind == "flow":
            self._warm_flow_fits += 1
        fdeg = (fit.meta or {}).get("flow_degraded")
        if fdeg:
            # a flow request served the mixture: still warm
            self._warm_flow_degraded += 1
            handle.warm["flow_degraded"] = fdeg
            if self.metrics is not None:
                self.metrics.counter("serve_warm_flow_degraded").inc()
                self.metrics.emit("warm_flow_degraded",
                                  tenant=handle.tenant_id, reason=fdeg)
        if self.metrics is not None:
            self.metrics.counter("serve_warm_starts").inc()
            self.metrics.emit("warm_start", tenant=handle.tenant_id,
                              kind=fit.kind, pilot_sweeps=fit.pilot_sweeps,
                              pilot_ms=round(fit.pilot_ms, 1))
        return fit

    #: the longest one pilot wave is waited for (a full pool admits a
    #: pilot as soon as a group frees; past this the tenant starts cold)
    PILOT_TIMEOUT_S = 300.0

    def _pilot_wave(self, handle: TenantHandle, spec) -> list:
        """The pilots of one staging pickup: this tenant's, and one for
        each queued warm-start tenant behind it (at most one a lane
        group), so N queued warm tenants wait for one pilot wall, not N.
        Returns ``[(handle, spec)]``, this tenant first."""
        wave = [(handle, spec)]
        cap = max(1, self.pool.nlanes // self.pool.group)
        for rh in self.queue.snapshot():
            if len(wave) >= cap:
                break
            rr = rh.request
            if (rh is handle or rh.done()
                    or getattr(rh, "_internal", False)
                    or rh.tenant_id in self._pilot_fits
                    or rr.state is not None or rr.x0 is not None):
                continue
            try:
                rspec = resolve_warm_start(rr.warm_start)
            except Exception:  # noqa: BLE001 - its own staging rejects it
                continue
            if isinstance(rspec, WarmStartSpec):
                wave.append((rh, rspec))
        return wave

    def _pool_pilot_fit(self, handle: TenantHandle, spec):
        """Serve a wave of pilots on the pool and fit them. Each pilot is
        an internal tenant (``pilot_chains`` chains of its warm tenant's
        model and seed, its sweeps rounded up to whole quanta) put straight
        into the staged window (this is the staging thread: a queued pilot
        would wait on itself), served by the dispatch thread beside the
        running tenants, and fitted by ``fit_from_rows``. The wave is
        waited for once; riders' fits go to ``_pilot_fits`` for their own
        staging. Pilots do real, accounted work, but the manifest and the
        SLO series do not see them. A rider's failure is its own (it runs
        its own pilot later); this tenant's raises (and degrades it)."""
        t0 = time.monotonic()
        q = self.pool.quantum
        pilots = []
        for wh, wspec in self._pilot_wave(handle, spec):
            niter = -(-int(wspec.pilot_sweeps) // q) * q
            ph = TenantHandle(next(self._ids), TenantRequest(
                ma=wh.request.ma, niter=niter, nchains=wspec.pilot_chains,
                seed=wh.request.seed, name=f"__warm_pilot_{wh.tenant_id}"))
            ph._internal = True
            with self._lock:
                self._handles[ph.tenant_id] = ph
            prep = self._prepare(ph)
            if prep is None:
                if wh is handle:
                    raise RuntimeError(f"pilot rejected: {ph.error}")
                continue
            with self._prep_lock:
                self._prepared.append(prep)
            pilots.append((wh, wspec, ph, prep))
        if len(pilots) > 1:
            self._warm_pilot_batches += 1
            if self.metrics is not None:
                self.metrics.counter("serve_pilot_batches").inc()
                self.metrics.emit("pilot_batch", tenant=handle.tenant_id,
                                  size=len(pilots))
        # one wait for the wave, which a stopping server ends (close()
        # joins this thread)
        deadline = t0 + self.PILOT_TIMEOUT_S
        fit_out = None
        timed_out = False

        def cancel_rest():
            for _, _, p2, _ in pilots:
                if not p2.done():
                    self.cancel(p2)

        for wh, wspec, ph, prep in pilots:
            while not ph.done() and not timed_out:
                if self._workers_stop.is_set() or self._stop.is_set():
                    cancel_rest()
                    raise RuntimeError("server stopping mid-pilot")
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                ph._done.wait(0.05)
            if timed_out and not ph.done():
                self.cancel(ph)
                if wh is handle:
                    cancel_rest()
                    raise TimeoutError(
                        f"warm-start pilot not served within "
                        f"{self.PILOT_TIMEOUT_S:.0f}s")
                continue
            try:
                res = ph.result(timeout=0)
                fit = fit_from_rows(np.asarray(res.chain), wspec,
                                    prep.backend._ma.specs_np,
                                    pilot_ms=(time.monotonic() - t0) * 1e3)
            except Exception:  # noqa: BLE001 - a rider degrades alone
                if wh is handle:
                    raise
                continue
            if wh is handle:
                fit_out = fit
            else:
                self._pilot_fits[wh.tenant_id] = fit
        return fit_out

    def _apply_prepared(self, prep: _Prepared) -> None:
        """Place a prepared tenant into the first free groups (the caller
        holds ``_lock`` and has checked that they fit)."""
        handle, req, pool = prep.handle, prep.handle.request, self.pool
        with self._prep_lock:
            if handle.tenant_id in self._cancelled_prestage:
                self._cancelled_prestage.discard(handle.tenant_id)
                handle._fail("cancelled before admission")
                return
        t_admit0 = time.monotonic()
        taken = sorted(self._free_groups.pop(0)
                       for _ in range(prep.groups_needed))
        G = pool.group
        lanes = np.concatenate([np.arange(g * G, (g + 1) * G)
                                for g in taken])
        slot = TenantSlot(handle.tenant_id, lanes, req.nchains, req.niter,
                          req.start_sweep, req.seed, n_real=prep.n_real)
        pool.write_tenant(slot, prep.backend, prep.state)
        spool = None
        if req.spool_dir is not None:
            # the spool keeps scan-end rows either way; with recycling on
            # its meta records that (a resume may not flip it)
            spool = ChainSpool(
                req.spool_dir, req.seed, resume=req.start_sweep > 0,
                resume_at=req.start_sweep or None,
                record_mode=pool.drawer.record_mode,
                recycle=True if self.recycle else None,
                extra_meta={"tenant": handle.tenant_id,
                            "n_toa": [slot.n_real]},
                fault_key=handle.fault_key)
        handle.admitted_t = time.monotonic()
        handle.status = "running"
        handle._monitor = prep.monitor
        self._tenant_names[handle.tenant_id] = req.name
        self._running[handle.tenant_id] = _Tenant(
            slot, handle, spool,
            backend=prep.backend if req.on_divergence == "reinit" else None)
        # a warm-start pilot stays out of the SLO series and the manifest
        # (a recovered server must not resurrect a pilot)
        internal = getattr(handle, "_internal", False)
        if not internal:
            self._admission_ms.append(handle.admission_ms)
            self._tier_leg(req, "admission_ms").append(handle.admission_ms)
        if self.spans is not None:
            self.spans.record("admit", ROLE_DISPATCH, t_admit0,
                              time.monotonic() - t_admit0,
                              tenant=handle.tenant_id, quantum=self.quanta)
        if self._manifest is not None and not internal:
            self._manifest.record_admit(
                handle.tenant_id, req,
                model=req.ma if req.spool_dir is not None else None,
                warm=(prep.warm_fit.to_json()
                      if prep.warm_fit is not None else None))
        if self.metrics is not None:
            self.metrics.histogram("serve_admission_ms").observe(
                handle.admission_ms)
            self.metrics.counter("serve_admissions").inc()
            self.metrics.emit("admit", tenant=handle.tenant_id,
                              nchains=req.nchains, niter=req.niter,
                              lanes=int(lanes[0]),
                              admission_ms=handle.admission_ms)
        if self.flight is not None:
            self.flight.note_event("admit", tenant=handle.tenant_id,
                                   nchains=req.nchains, niter=req.niter,
                                   lane0=int(lanes[0]))

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
            if t.slot.cancelled or t.slot.failed:
                needed -= len(t.slot.lanes) // self.pool.group
        if needed <= 0:
            return 0
        victims = [t for t in self._running.values()
                   if t.spool is not None and not t.slot.cancelled
                   and not t.slot.failed
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
        if self.metrics is not None:
            self.metrics.emit("evict", tenant=slot.tenant_id,
                              sweeps=slot.done_sweeps)
        if self.flight is not None:
            self.flight.note_event("evict", tenant=slot.tenant_id,
                                   sweeps=slot.done_sweeps)

    def _reap_decided(self) -> List[_Tenant]:
        """Release the running tenants whose freeze was decided since the
        last dispatch (cancels, preemptions, contained failures), so their
        groups backfill at this boundary. Returns them for a finalize
        after their last drain."""
        reaped = []
        for tid, t in list(self._running.items()):
            slot = t.slot
            if (slot.cancelled or slot.failed) and slot.done_sweeps > 0:
                self._running.pop(tid)
                self._release(slot)
                reaped.append(t)
        return reaped

    # ------------------------------------------------------------------
    # draining and finishing
    # ------------------------------------------------------------------

    def _host_tele(self, tl: Optional[Telemetry]) -> Optional[Telemetry]:
        """A quantum's telemetry (``(G, 16)`` tensors, or the host copies
        a drain pulled) as ``(nlanes,)`` numpy arrays."""
        if tl is None:
            return None
        return Telemetry(*(np.asarray(t.cpu() if torch.is_tensor(t) else t)
                           .reshape(self.pool.nlanes) for t in tl))

    def _drain_tenant(self, slot: TenantSlot, handle: TenantHandle,
                      spool: Optional[ChainSpool], wire: dict,
                      tele: Optional[Telemetry], sweep_end: int,
                      state_fn) -> None:
        """Hand one tenant its share of a quantum (both executors), from
        the quantum's records on the host in wire dtypes: float32 records
        to its spool, with the checkpoint ``state_fn()`` at ``sweep_end``
        (journaled), or its lanes' wire slice to its handle (turned into
        float32 once, at finalize); then the ``on_chunk`` callback (float32
        records), and the quantum's telemetry into its running stats."""
        pool = self.pool
        records = wire_cols = None
        if spool is not None or handle.request.on_chunk is not None:
            records = pool.tenant_quantum_records(wire, slot)
        if spool is not None:
            spool.append(records, state_fn(), sweep_end)
            if self._manifest is not None:
                self._manifest.record_checkpoint(slot.tenant_id, sweep_end)
        else:
            wire_cols = pool.tenant_wire(wire, slot)
            handle._append(wire_cols)
        first = handle.first_result_t is None
        rec_rows, stream = self._recycle_rows(handle, slot, records, first)
        handle._stream(sweep_end, stream)
        if (first and handle.first_result_ms is not None
                and not getattr(handle, "_internal", False)):
            ms = handle.first_result_ms
            self._first_result_ms.append(ms)
            self._tier_leg(handle.request, "first_result_ms").append(ms)
            if self.metrics is not None:
                self.metrics.histogram("serve_first_result_ms").observe(ms)
        if tele is not None:
            self._accumulate_tele(handle, slot, tele)
        # x has no cast: its wire slice is its float32 record
        x = records["x"] if records is not None else wire_cols["x"].numpy()
        self._feed_monitor(handle, slot, x, sweep_end, recycled=rec_rows)

    def _recycle_rows(self, handle: TenantHandle, slot: TenantSlot,
                      records: dict, first: bool):
        """Recycling's share of one drained quantum: ``(recycled rows,
        the records to stream)``. One recycled row stands before each
        scan-end row (the mid-scan state leading to it), except before a
        stream's very first row, whose predecessor was the init; the
        streamed records are a copy with the ``row_class`` tag (the spool
        and the result keep the records as they are; None, with no
        ``on_chunk`` to stream to, stays None). Quarantined lanes
        advanced no scan, so they are not counted. ``(0, records)`` with
        recycling off."""
        if not self.recycle:
            return 0, records
        rows_q = self.pool.quantum
        continuing = not first or handle.request.start_sweep > 0
        rec_rows = rows_q if continuing else rows_q - 1
        if not rec_rows:
            return 0, records
        active = max(slot.nchains - len(slot.quarantined), 0)
        handle.recycled_rows += rec_rows * active
        self._recycled_lane_rows += rec_rows * active
        if self.metrics is not None:
            self.metrics.counter("serve_recycled_rows").inc(
                rec_rows * active)
        if records is None:
            return rec_rows, None
        stream = dict(records)
        stream["row_class"] = row_class_pattern(rows_q, continuing)
        return rec_rows, stream

    def _backfill_monitor(self, monitor: TenantMonitor, req) -> None:
        """Re-arm a resumed monitored tenant's monitor over its whole
        recorded prefix: fold the spooled ``x`` rows below the resume
        point in one pass without an evaluation, so the resumed run
        evaluates (and converges, and evicts) at the same sweeps as the
        uninterrupted one. A failure warns, and the window restarts at
        the resume point; it never fails the tenant."""
        try:
            loaded = load_spool_prefix(req.spool_dir, "x", req.start_sweep)
            if loaded is None:
                return
            rows, base = loaded
            if not len(rows):
                return
            monitor.backfill(
                rows, req.start_sweep,
                updates=(req.start_sweep - base) // self.pool.quantum,
                recycled=len(rows) - 1 if self.recycle else 0)
        except Exception as e:  # noqa: BLE001 - observability contract
            warnings.warn(
                f"monitor backfill from {req.spool_dir!r} failed "
                f"({type(e).__name__}: {e}); the monitor window "
                "restarts at the resume point", RuntimeWarning)

    def _feed_monitor(self, handle: TenantHandle, slot: TenantSlot,
                      x: np.ndarray, sweep_end: int,
                      recycled: int = 0) -> None:
        """Fold one drained quantum's ``x`` rows (and its ``recycled`` row
        count) into the tenant's monitor, from the records already on the
        host (no copy from the device of its own). On convergence record
        the SLO leg and, under ``on_converged="evict"``, freeze the tenant
        at the next boundary through the cancel machinery; then redraw an
        adaptive tenant's block gates. A monitor exception detaches THAT
        tenant's monitor with a warning and the tenant keeps serving."""
        mon = handle._monitor
        if mon is None:
            return
        t0 = time.monotonic()
        try:
            mon.update(x, sweep_end, recycled=recycled)
            if (mon.converged_at is not None
                    and not getattr(handle, "_conv_recorded", False)):
                handle._conv_recorded = True
                conv_t = mon.converged_t
                ms = ((conv_t - handle.submitted_t) * 1e3
                      if conv_t is not None else None)
                if ms is not None:
                    self._converged_ms.append(ms)
                    self._tier_leg(handle.request,
                                   "converged_ms").append(ms)
                if self.metrics is not None:
                    if ms is not None:
                        self.metrics.histogram(
                            "serve_converged_ms").observe(ms)
                    self.metrics.emit(
                        "tenant_converged", tenant=slot.tenant_id,
                        sweep=mon.converged_at, ms=ms)
                # the armed targets hold: the rest of the budget buys no
                # requested statistic. The flag is read at the next
                # boundary (a GIL-atomic write from the drain thread; at
                # worst one more quantum runs, as for a racing cancel())
                if (handle.request.on_converged == "evict"
                        and slot.remaining > 0 and not slot.cancelled
                        and not slot.failed):
                    slot.cancelled = True
                    self._converged_evictions += 1
                    if self.metrics is not None:
                        self.metrics.counter(
                            "serve_converged_evictions").inc()
                        self.metrics.emit(
                            "evict_converged", tenant=slot.tenant_id,
                            sweep=mon.converged_at,
                            budget=handle.request.niter)
                    if self.flight is not None:
                        self.flight.note_event(
                            "evict_converged", tenant=slot.tenant_id,
                            sweep=mon.converged_at)
            # the adaptive scan: gates redrawn from the fresh per-block
            # ESS, a host write the next dispatch uploads
            spec_a = getattr(handle, "_adapt_spec", None)
            if spec_a is not None and not slot.cancelled \
                    and not slot.failed:
                self._adapt_update(handle, slot, mon, spec_a, sweep_end)
        except Exception as e:  # noqa: BLE001 - observability contract
            handle._monitor = None
            warnings.warn(
                f"tenant {slot.tenant_id} convergence monitor failed "
                f"({type(e).__name__}: {e}); monitoring disabled for "
                "this tenant, serving continues", RuntimeWarning)
            if self.metrics is not None:
                self.metrics.counter("serve_monitor_errors").inc()
                self.metrics.emit("monitor_error", tenant=slot.tenant_id,
                                  error=f"{type(e).__name__}: {e}")
        finally:
            self._monitor_t += time.monotonic() - t0

    def _adapt_update(self, handle: TenantHandle, slot: TenantSlot, mon,
                      spec, sweep_end: int) -> None:
        """One adaptive-scan boundary update (serve/adapt.py): every
        converged thinnable block thins to its selection probability, and
        this boundary's 0/1 gates are drawn from the ``(seed, tenant,
        sweep)`` stream into the tenant's lanes. Runs in
        ``_feed_monitor``'s failure scope."""
        target = spec.ess_target
        if target is None:
            target = handle.request.monitor.ess_target
        bess = mon.block_ess()
        if target is None or not bess:
            return
        probs = _adapt.selection_probs(bess, float(target), spec.floor)
        if not (probs < 1.0).any() and handle.adapt is None:
            return          # never thinned: the gates stay ones
        gates = _adapt.draw_gates(probs, slot.seed, slot.tenant_id,
                                  int(sweep_end))
        if not self.pool.set_block_gates(slot.lanes, gates,
                                         tenant_id=slot.tenant_id):
            return          # released: its lanes may hold another tenant
        self._adapt_updates += 1
        first = slot.tenant_id not in self._adapt_tenants
        self._adapt_tenants.add(slot.tenant_id)
        handle.adapt = {
            "sweep": int(sweep_end),
            "probs": {n: round(float(p), 4)
                      for n, p in zip(_adapt.BLOCK_NAMES, probs) if p < 1.0},
            "gates": [int(g) for g in gates],
            "updates": (handle.adapt or {}).get("updates", 0) + 1,
        }
        if self.metrics is not None:
            self.metrics.counter("serve_adapt_updates").inc()
            if first:
                self.metrics.emit("adapt_scan", tenant=slot.tenant_id,
                                  sweep=int(sweep_end),
                                  probs=handle.adapt["probs"])
        if first and self.flight is not None:
            self.flight.note_event("adapt_scan", tenant=slot.tenant_id,
                                   sweep=int(sweep_end))

    @staticmethod
    def _accumulate_tele(handle: TenantHandle, slot: TenantSlot,
                         tele: Telemetry) -> None:
        """Fold one quantum's telemetry (``(nlanes,)`` host arrays) into
        the tenant's ``tele_*`` stats as the solo sampler aggregates them
        (obs/telemetry.TelemetryAccumulator): sweeps and non-finite counts
        sum, accept rates are means a sweep, the diverged flag ORs, the
        log-posterior is the latest quantum's."""
        lanes = slot.chain_lanes
        sub = Telemetry(*(a[lanes] for a in tele))
        d = handle._tele_stats
        q = int(sub.sweeps.flat[0])
        prev = int(d.get("tele_sweeps", 0))
        total = max(prev + q, 1)
        for blk, val in (("white", sub.accept_white),
                         ("hyper", sub.accept_hyper)):
            key = f"tele_accept_{blk}"
            prev_rate = np.asarray(d.get(key, np.zeros(len(lanes))),
                                   np.float64)
            d[key] = ((prev_rate * prev + np.asarray(val, np.float64))
                      / total).astype(np.float32)
        d["tele_sweeps"] = np.asarray(prev + q)
        d["tele_nonfinite"] = (np.asarray(sub.nonfinite, np.int64)
                               + d.get("tele_nonfinite", 0))
        d["tele_diverged"] = (np.asarray(sub.diverged, bool)
                              | d.get("tele_diverged", False))
        d["tele_logpost"] = np.asarray(sub.logpost, np.float32)

    def _finish(self, t: _Tenant) -> None:
        """Deliver a released tenant: its failure or its result."""
        if t.slot.failed:
            self._finalize_failed(t)
        else:
            self._finalize(t)

    def _finalize(self, t: _Tenant) -> None:
        """Deliver a finished tenant's result, after its last records were
        drained, with its telemetry stats and health report. A preempted
        tenant with budget left is requeued instead."""
        slot, handle, spool = t.slot, t.handle, t.spool
        if slot.preempted and slot.remaining > 0:
            self._requeue_preempted(t)
            return
        handle.health = health = self._tenant_health(t)
        if self._manifest is not None:
            self._manifest.record_done(slot.tenant_id, "done",
                                       slot.done_sweeps)
        if self.metrics is not None and health is not None:
            self.metrics.emit(
                "tenant_health", tenant=slot.tenant_id,
                n_ok=health["n_ok"], n_diverged=health["n_diverged"],
                n_stuck=health["n_stuck"], n_dead=health["n_dead"],
                n_quarantined=health["n_quarantined"],
                n_reinits=health["n_reinits"])
        extra = dict(handle._tele_stats)
        extra["n_toa"] = np.asarray([slot.n_real])
        if health is not None:
            extra["health"] = health
        # the monitor's final view and the cost ride the result's stats
        # (the tenant's last quantum was attributed before this finalize)
        if handle._monitor is not None:
            extra["monitor"] = handle._monitor.snapshot()
            extra["converged_at"] = handle._monitor.converged_at
        extra["cost"] = handle.cost()
        if self.recycle:
            # the count only: the recycled rows are rebuilt from the chains
            # (parallel/recycle.recycled_result), never stored
            extra["recycle"] = {"enabled": True,
                                "recycled_lane_rows":
                                    int(handle.recycled_rows)}
        if handle.warm is not None:
            extra["warm"] = dict(handle.warm)
        if spool is not None:
            spool.close()
            res = load_spool(handle.request.spool_dir)
            res.stats.update(extra)
            handle._finish(res)
            return

        def build():
            res = self._memory_result(slot, handle)
            res.stats.update(extra)
            return res

        handle._finish_lazy(build)

    def _memory_result(self, slot: TenantSlot, handle: TenantHandle):
        """An in-memory tenant's result from the wire slices its handle
        accumulated: one concatenation, then one pass to float32."""
        pool = self.pool
        return pool.result(pool.materialize_tenant(
            {f: torch.cat(c) for f, c in handle._cols.items()},
            slot.n_real), slot.n_real)

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
            if self._manifest is not None:
                self._manifest.record_done(slot.tenant_id, "failed",
                                           slot.done_sweeps)
            if self.metrics is not None:
                self.metrics.emit(
                    "tenant_deadline_exceeded", tenant=slot.tenant_id,
                    deadline_sweep=handle._deadline_sweep,
                    at_sweep=next_sweep)
            return
        state, ck_sweep, _ = load_spool_state(sdir, device="cpu")
        if ck_sweep != next_sweep:
            handle._fail_tenant(TenantError(
                slot.tenant_id,
                f"preemption checkpoint sits at sweep {ck_sweep}, not the "
                f"frozen tenant's {next_sweep}", where="spool"))
            return
        # the aging anchor, the absolute deadline, the preemption count
        # and the telemetry survive the requeue; the admission legs restart
        handle.request = replace(
            handle.request, niter=slot.niter - slot.done_sweeps,
            state=state, start_sweep=ck_sweep, resume_spool=False)
        handle.status = "queued"
        handle.submitted_t = time.monotonic()
        handle.admitted_t = handle.first_result_t = None
        handle.sweeps_done = 0
        handle.preemptions += 1
        # re-armed and backfilled from the spool at the re-admission
        handle._monitor = None
        self.queue.put_displaced(handle)
        self._stage_wake.set()
        depth = len(self.queue)
        self._queue_depth_peak = max(self._queue_depth_peak, depth)
        if self.metrics is not None:
            self.metrics.gauge("serve_queue_depth").set(depth)
        if self.flight is not None:
            self.flight.note_event(
                "preempt_requeued", tenant=slot.tenant_id,
                next_sweep=next_sweep,
                remaining=slot.niter - slot.done_sweeps)

    def _fail_drained(self, handle: TenantHandle, exc: Exception) -> None:
        """Fail-fast (``supervise=False``): resolve a tenant whose drain or
        finalize raised (its waiter must not hang); the failure then
        fails the run."""
        if not handle.done():
            handle._fail_tenant(TenantError(
                handle.tenant_id, f"{type(exc).__name__}: {exc}",
                where="drain", cause=exc))

    # ------------------------------------------------------------------
    # fault containment
    # ------------------------------------------------------------------

    def _note_fault(self, t: _Tenant, where: str, cause) -> None:
        """Mark a tenant failed (it freezes and releases at the next
        boundary, as a cancel does) and count and journal the fault. Only
        the first cause is kept."""
        slot = t.slot
        if slot.failed:
            return
        slot.failed = True
        slot.fail_where = where
        slot.fail_cause = cause
        self._fault_counts["tenant_failures"] += 1
        error = f"{type(cause).__name__}: {cause}"
        if self.metrics is not None:
            self.metrics.counter("serve_tenant_faults").inc()
            self.metrics.emit("tenant_fault", tenant=slot.tenant_id,
                              where=where, error=error)
        if self._manifest is not None:
            self._manifest.record(
                "fault", tenant=slot.tenant_id, where=where, error=error)
        if self.flight is not None:
            # a contained failure is a dump trigger: the bundle keeps the
            # quanta and spans around the fault while they are in the ring
            self.flight.note_event("tenant_fault", tenant=slot.tenant_id,
                                   where=where, error=error)
            self._dump_flight(f"tenant_fault:{slot.tenant_id}")

    def _tenant_health(self, t: _Tenant) -> Optional[dict]:
        """The tenant's health report (obs/health.chain_health over its
        telemetry, with the quarantined chains and re-draws), or None when
        the pool runs telemetry off."""
        handle, slot = t.handle, t.slot
        if not handle._tele_stats:
            return None
        report = chain_health(handle._tele_stats)
        report["n_quarantined"] = len(slot.quarantined)
        report["quarantined_chains"] = sorted(slot.quarantined)
        report["n_reinits"] = slot.n_reinits
        return report

    def _finalize_failed(self, t: _Tenant) -> None:
        """Deliver a contained failure, after the tenant's last drain: a
        :class:`TenantError` carrying the cause and the prefix drained
        before it (a bitwise prefix of the uninterrupted run, as a
        cancel's), with the health report."""
        slot, handle, spool = t.slot, t.handle, t.spool
        if handle.done():
            return
        partial = None
        try:
            if spool is not None:
                spool.close()
                partial = load_spool(handle.request.spool_dir)
            elif handle._cols:
                partial = self._memory_result(slot, handle)
        except Exception:  # noqa: BLE001 - the prefix itself is broken
            partial = None
        handle.health = self._tenant_health(t)
        if partial is not None:
            partial.stats.update(handle._tele_stats)
            if handle.health is not None:
                partial.stats["health"] = handle.health
        cause = slot.fail_cause
        handle._fail_tenant(TenantError(
            slot.tenant_id,
            (f"{type(cause).__name__}: {cause}" if cause is not None
             else "unknown"),
            where=slot.fail_where or "drain", cause=cause, partial=partial))
        if self._manifest is not None:
            self._manifest.record_done(slot.tenant_id, "failed",
                                       slot.done_sweeps)

    def _fold_lane_health(self) -> List[_Tenant]:
        """At a boundary (the caller holds ``_lock``), fold the previous
        quantum's sticky ``diverged`` flags and apply each tenant's
        ``on_divergence`` policy. Reading them waits for that quantum, so
        it happens only while a running tenant has a policy. Returns the
        tenants the policy failed, released, for a finalize after their
        last drain."""
        tl = self._last_tl
        if tl is None or not any(
                t.handle.request.on_divergence != "none"
                for t in self._running.values()):
            return []
        self._last_tl = None
        div = tl.diverged
        div = np.asarray(div.cpu() if torch.is_tensor(div) else div,
                         bool).reshape(-1)
        failed: List[_Tenant] = []
        for tid, t in list(self._running.items()):
            slot, handle = t.slot, t.handle
            pol = handle.request.on_divergence
            if pol == "none" or slot.failed or tid not in self._last_tl_tids:
                continue
            mask = div[slot.chain_lanes].copy()
            if slot.quarantined:
                mask[sorted(slot.quarantined)] = False
            chains = np.flatnonzero(mask)
            if chains.size == 0:
                continue
            sweep_now = slot.start_sweep + slot.done_sweeps
            fail_now = pol == "fail"
            if pol == "quarantine":
                self.pool.quarantine_lanes(slot.chain_lanes[chains])
                slot.quarantined.update(int(c) for c in chains)
                self._fault_counts["quarantined_lanes"] += int(chains.size)
                if self.metrics is not None:
                    self.metrics.counter("serve_quarantined_lanes").inc(
                        int(chains.size))
                    self.metrics.emit("quarantine", tenant=tid,
                                      sweep=sweep_now,
                                      chains=[int(c) for c in chains])
                if self._manifest is not None:
                    self._manifest.record(
                        "quarantine", tenant=tid, sweep=sweep_now,
                        chains=[int(c) for c in chains])
                # no chain left to serve is a failure, not a freeze
                fail_now = len(slot.quarantined) >= slot.nchains
            elif pol == "reinit":
                fresh = t.backend.init_state(
                    seed=handle.request.seed + 7919 * sweep_now)
                self.pool.reinit_lanes(slot.chain_lanes[chains], fresh,
                                       chains)
                slot.n_reinits += int(chains.size)
                self._fault_counts["reinits"] += int(chains.size)
                if self.metrics is not None:
                    self.metrics.counter("serve_reinits").inc(
                        int(chains.size))
                    self.metrics.emit("reinit", tenant=tid,
                                      sweep=sweep_now,
                                      chains=[int(c) for c in chains])
                if self._manifest is not None:
                    self._manifest.record(
                        "reinit", tenant=tid, sweep=sweep_now,
                        chains=[int(c) for c in chains])
            if fail_now:
                why = (f"{chains.size} chain(s) diverged" if pol == "fail"
                       else f"all {slot.nchains} chains diverged/quarantined")
                self._note_fault(t, "divergence", RuntimeError(why))
                self._running.pop(tid)
                self._release(slot)
                failed.append(t)
        return failed

    def _boundary_faults(self) -> None:
        """The ``lane_nan`` injection point, before a dispatch: a spec
        firing for a running tenant poisons its first chain's lane, which
        the quantum's telemetry then flags as a real divergence."""
        for t in self._running.values():
            if t.slot.failed:
                continue
            try:
                _faults.fire("lane_nan", tenant=t.handle.fault_key)
            except Exception:  # noqa: BLE001 - the firing is the signal
                self.pool.poison_lanes(t.slot.chain_lanes[:1])

    @staticmethod
    def _drains(slot: TenantSlot) -> bool:
        """Whether a tenant's records of a dispatched quantum are still
        drained: not once the drain side failed it (the serial loop would
        have released it before that quantum); a divergence failure is
        decided at the boundary after the quantum, which drains."""
        return not slot.failed or slot.fail_where == "divergence"

    def _pool_failure(self, err: BaseException, label: str = ""):
        """A pool-level fault (a worker's error under the fail-fast
        reference, a pull of records failing, a worker past its restart
        budget): under supervision every outstanding handle resolves;
        then the run raises."""
        self._fault_counts["pool_failures"] += 1
        if self.metrics is not None:
            self.metrics.emit("pool_failure", error=str(err), label=label)
        if self.flight is not None:
            self.flight.note_event("pool_failure", error=str(err),
                                   label=label)
            self._dump_flight("pool_failure")
        if self.supervise:
            self._fail_all_outstanding(
                f"pool failure: {type(err).__name__}: {err}", where="pool")
        raise RuntimeError("serve worker thread failed"
                           + (f" ({label})" if label else "")) from err

    def _supervise_workers(self) -> None:
        """Restart dead workers with a capped exponential backoff; a
        worker kind past ``MAX_WORKER_RESTARTS`` is a pool failure (one
        crash-looping would fail every tenant a bundle at a time)."""
        now = time.monotonic()
        for kind, th in (("drain", self._drain_thread),
                         ("stage", self._stage_thread)):
            if th is not None and th.is_alive():
                continue
            st = self._restarts[kind]
            if st["n"] >= self.MAX_WORKER_RESTARTS:
                self._pool_failure(
                    RuntimeError(f"{kind} worker crash-looping "
                                 f"({st['n']} restarts)"),
                    label=f"{kind} worker crash-looping")
            if now < st["next_t"]:
                continue
            st["n"] += 1
            st["next_t"] = now + min(0.05 * 2 ** st["n"], 1.0)
            self._fault_counts["worker_restarts"] += 1
            if self.metrics is not None:
                self.metrics.counter("serve_worker_restarts").inc()
                self.metrics.emit("worker_restart", worker=kind, n=st["n"])
            if kind == "drain":
                self._drain_thread = None
            else:
                self._stage_thread = None
            self._ensure_workers()

    # ------------------------------------------------------------------
    # the serial quantum loop (the reference executor)
    # ------------------------------------------------------------------

    def step(self) -> bool:
        """One quantum on the calling thread: fold lane health, release
        cancelled and failed tenants, admit, advance, hand out the
        records, release and finish the tenants that are done. Returns
        True while there is work left (resident or queued)."""
        with self._lock:
            for t in self._fold_lane_health():
                self._finalize_failed(t)
            for t in self._reap_decided():
                self._finish(t)
            t0 = time.monotonic()
            self._try_admissions()
            self._admit_apply_ms.append((time.monotonic() - t0) * 1e3)
            if not self._running:
                return len(self.queue) > 0
        # the quantum itself runs outside the lock (only this thread
        # changes the running set; a cancel meanwhile only flags a slot)
        pool = self.pool
        self._boundary_faults()
        self._beat("dispatch")
        _faults.fire("dispatch_stall")
        qidx = self.quanta
        t_d = self._dispatch_start()
        recs, tl = pool.run_quantum()
        wire = pool.wire_host(recs)
        tele = self._host_tele(tl)
        with self._lock:
            self._last_tl, self._last_tl_tids = tele, set(self._running)
            self._last_dispatch_t = t0 = time.monotonic()
            disp_ms = (t0 - t_d) * 1e3
            self._dispatch_ms.append(disp_ms)
            self._dispatch_wall_ms += disp_ms
            # the pull above waited for the quantum: its brackets are done
            stage_ms = self._stage_delta()
            self._attribute_cost(disp_ms,
                                 self._cost_shares(self._running.values()),
                                 stage_ms=stage_ms)
            self._quantum_spans(t_d, t0, qidx)
            self._monitor_t = 0.0
            q = pool.quantum
            finished = []
            busy = 0
            for tid, t in self._running.items():
                slot = t.slot
                slot.done_sweeps += q
                busy += slot.nchains
                if not slot.failed:
                    try:
                        with self._span("drain", ROLE_DRAIN, tenant=tid,
                                        quantum=qidx):
                            self._drain_tenant(
                                slot, t.handle, t.spool, wire, tele,
                                slot.start_sweep + slot.done_sweeps,
                                state_fn=lambda s=slot: pool.tenant_state(s))
                    except Exception as e:  # noqa: BLE001 - contained
                        if not self.supervise:
                            self._fail_drained(t.handle, e)
                            raise
                        self._note_fault(t, "drain", e)
                if slot.remaining <= 0 or slot.cancelled or slot.failed:
                    finished.append(tid)
            self._count_quantum()
            for tid in finished:
                t = self._running.pop(tid)
                self._release(t.slot)
                try:
                    with self._span("finalize", ROLE_DRAIN, tenant=tid,
                                    quantum=qidx):
                        self._finish(t)
                except Exception as e:  # noqa: BLE001 - contained
                    if not self.supervise:
                        self._fail_drained(t.handle, e)
                        raise
                    self._note_fault(t, "finalize", e)
                    self._finalize_failed(t)
            drain_ms = (time.monotonic() - t0) * 1e3
            self._drain_ms.append(drain_ms)
            self._beat("drain")
            self._note_quantum_done(qidx, disp_ms, busy, drain_ms, 0,
                                    stage_ms)
            self._refresh_obs(locked=True)
            return bool(self._running) or len(self.queue) > 0

    def _dispatch_start(self) -> float:
        t = time.monotonic()
        if self._last_dispatch_t is not None:
            self._gap_ms.append((t - self._last_dispatch_t) * 1e3)
        return t

    def _count_quantum(self) -> None:
        q = self.pool.quantum
        busy = sum(t.slot.nchains for t in self._running.values())
        self.quanta += 1
        self.busy_chain_sweeps += q * busy
        self.total_lane_sweeps += self.pool.nlanes * q
        if self.metrics is not None:
            self.metrics.gauge("serve_occupancy").set(busy / self.pool.nlanes)
            self.metrics.gauge("serve_queue_depth").set(len(self.queue))
            self.metrics.counter("serve_sweeps_total").inc(busy * q)

    def _beat(self, role: str) -> None:
        """An executor role's heartbeat, to the watchdog and the flight
        recorder."""
        if self._watchdog is not None:
            self._watchdog.beat(role)
        if self.flight is not None:
            self.flight.beat(role)

    def _quantum_spans(self, t_d: float, t_end: float, qidx: int) -> None:
        """One dispatch-role span for each tenant the quantum advanced."""
        if self.spans is not None:
            for tid in list(self._running):
                self.spans.record("quantum", ROLE_DISPATCH, t_d,
                                  t_end - t_d, tenant=tid, quantum=qidx)

    def _note_quantum_done(self, qidx: int, disp_ms: float, busy: int,
                           drain_ms: Optional[float], backlog: int,
                           stage_ms: Dict[str, float]) -> None:
        """A drained quantum's evidence: the watchdog's wall, throughput
        and backlog, the flight ring's entry, and the monitor feed's host
        ms (the serial loop's thread, or the drain thread)."""
        if self._monitor_t:
            self._monitor_ms.append(self._monitor_t * 1e3)
        if self._watchdog is not None:
            q = self.pool.quantum
            self._watchdog.note_quantum(
                disp_ms, sweeps_per_s=(busy * q / (disp_ms / 1e3)
                                       if disp_ms > 0 else None),
                backlog=backlog)
        self._flight_quantum(qidx, disp_ms, busy, drain_ms, stage_ms)

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
            if self._watchdog is not None:
                self._watchdog.beat("staging")
            self._stage_wake.clear()
            h = self._take_for_staging()
            if h is None:
                self._stage_wake.wait(0.05)
                continue
            try:
                prep = self._prepare(h)  # rejects the tenant's Exceptions
            except BaseException as e:
                # a worker death (or an interpreter exit): balance the
                # count and resolve the handle before the thread ends;
                # the supervisor decides on a successor
                with self._prep_lock:
                    self._staging_n -= 1
                if not h.done():
                    h._fail(f"staging worker died: {type(e).__name__}: {e}")
                if isinstance(e, _faults.WorkerDeath):
                    return
                raise
            with self._prep_lock:
                self._staging_n -= 1
                if h.tenant_id in self._cancelled_prestage:
                    self._cancelled_prestage.discard(h.tenant_id)
                    h._fail("cancelled before admission")
                elif prep is not None:
                    self._prepared.append(prep)

    def _dispatch_one(self, need_snap: bool) -> _Bundle:
        """Dispatch the next quantum (outside ``_lock``: only this thread
        changes the running set), after the boundary's injection points;
        then, under the lock, its bookkeeping, the release of the tenants
        it finishes, and its drain bundle (finalize-only entries of the
        tenants released at this boundary first)."""
        self._boundary_faults()
        self._beat("dispatch")
        _faults.fire("dispatch_stall")
        qidx = self.quanta
        t_d = self._dispatch_start()
        recs, tl, snap = self.pool.dispatch_quantum(snapshot=need_snap)
        event = None
        if self._pull_stream is not None:
            event = torch.cuda.Event()
            event.record()
        self._last_dispatch_t = time.monotonic()
        disp_ms = (self._last_dispatch_t - t_d) * 1e3
        self._dispatch_ms.append(disp_ms)
        self._dispatch_wall_ms += disp_ms
        self._quantum_spans(t_d, self._last_dispatch_t, qidx)
        q = self.pool.quantum
        with self._lock:
            # the attribution itself runs on the drain thread
            cost = (disp_ms, self._cost_shares(self._running.values()))
            self._last_tl, self._last_tl_tids = tl, set(self._running)
            entries = [(t.slot, t.handle, t.spool,
                        t.slot.start_sweep + t.slot.done_sweeps, True, False)
                       for t in self._reaped]
            self._reaped.clear()
            finished = []
            for tid, t in self._running.items():
                slot = t.slot
                slot.done_sweeps += q
                final = (slot.remaining <= 0 or slot.cancelled
                         or slot.failed)
                entries.append((slot, t.handle, t.spool,
                                slot.start_sweep + slot.done_sweeps, final,
                                True))
                if final:
                    finished.append(tid)
            self._count_quantum()
            for tid in finished:
                self._release(self._running.pop(tid).slot)
        return _Bundle(recs, tl, snap, event, entries, qidx=qidx, cost=cost)

    def _drain_bundle(self, b: _Bundle) -> None:
        """Copy a quantum's records, telemetry (and snapshot) to the host
        on the side stream, after the quantum's event, then drain and
        finalize its entries in order. A tenant's failure is contained to
        it (``supervise``) or fails it and then the run; a failed pull
        fails the run. A worker death in an entry fails that entry's
        tenant and leaves ``b.idx`` past it, for the next drain."""
        host = tele = snap = None
        err = None
        try:
            if b.recs is not None:
                # one pull of the wire records, telemetry and snapshot
                fields = list(b.recs)
                tl = list(b.tl) if b.tl is not None else []
                tensors = list(b.recs.values()) + tl + list(b.snap or ())
                pulled = _HostCopy(tensors, self._pull_stream,
                                   after=b.event).wait()
                host = self.pool.wire_host(dict(zip(fields, pulled)))
                k = len(fields)
                if tl:
                    tele = self._host_tele(Telemetry(*pulled[k:k + len(tl)]))
                if b.snap is not None:
                    snap = ChainState(*pulled[k + len(tl):])
                b.recs = b.tl = b.snap = None
                b.host = (host, tele, snap)
            elif b.host is not None:
                host, tele, snap = b.host
        except Exception as e:  # noqa: BLE001 - raised on the dispatch side
            for entry in b.entries[b.idx:]:
                self._fail_drained(entry[1], e)
            b.idx = len(b.entries)
            err = (e, "pulling quantum records")
        # consumed once: a resumed bundle never bills a tenant twice
        cost, b.cost = b.cost, None
        stage_ms = {}
        if cost is not None:
            # the pull waited for the quantum's event, so its brackets are
            # done (the next quantum's may be too: the totals stay exact)
            stage_ms = self._stage_delta()
            self._attribute_cost(*cost, stage_ms=stage_ms)
            self._monitor_t = 0.0
        t0 = time.monotonic()
        while b.idx < len(b.entries):
            slot, handle, spool, sweep_end, final, drained = \
                b.entries[b.idx]
            if handle.done():
                # resolved meanwhile (a pool failure, a fail-fast drain)
                b.idx += 1
                continue
            t = _Tenant(slot, handle, spool)
            try:
                _faults.fire("drain_death", tenant=handle.fault_key)
                if drained and self._drains(slot):
                    with self._span("drain", ROLE_DRAIN,
                                    tenant=slot.tenant_id, quantum=b.qidx):
                        self._drain_tenant(
                            slot, handle, spool, host, tele, sweep_end,
                            state_fn=lambda s=slot:
                            self.pool.tenant_state_from(snap, s))
                if final:
                    with self._span("finalize", ROLE_DRAIN,
                                    tenant=slot.tenant_id, quantum=b.qidx):
                        self._finish(t)
            except Exception as e:  # noqa: BLE001 - contained or raised
                if not self.supervise:
                    self._fail_drained(handle, e)
                    err = err or (e, f"draining tenant {handle.tenant_id}")
                else:
                    self._note_fault(t, "drain", e)
                    if final:
                        self._finalize_failed(t)
            except BaseException as e:
                # the worker dies here: this entry's tenant has lost its
                # quantum; the next drain resumes after it
                self._note_fault(t, "worker", e)
                if final:
                    self._finalize_failed(t)
                b.idx += 1
                raise
            b.idx += 1
        drain_ms = None
        if host is not None:
            drain_ms = (time.monotonic() - t0) * 1e3
            self._drain_ms.append(drain_ms)
        if cost is not None:
            disp_ms, shares = cost
            self._note_quantum_done(b.qidx, disp_ms,
                                    sum(a for _, a in shares), drain_ms,
                                    self._drainq.unfinished_tasks, stage_ms)
            self._refresh_obs()
        if err is not None:
            self._worker_error, self._worker_error_label = err

    def _drain_one(self, item: _Bundle) -> bool:
        """Drain a queued bundle and free its slot (the drain worker's
        body, and the inline flush's). False when the draining thread
        died in it: the bundle stays unfinished, kept for the next
        drain, which resumes it before anything queued after it."""
        try:
            self._drain_bundle(item)
        except Exception as e:  # noqa: BLE001 - latched, raised below
            self._worker_error, self._worker_error_label = (
                e, "draining a quantum")
        except BaseException:
            self._resume_bundle = item
            raise
        self._inflight.release()
        self._drainq.task_done()
        return True

    def _drain_worker(self) -> None:
        while True:
            item, self._resume_bundle = self._resume_bundle, None
            if item is None:
                item = self._drainq.get()
                if item is None:
                    self._drainq.task_done()
                    return
            self._beat("drain")
            try:
                self._drain_one(item)
            except _faults.WorkerDeath:
                return      # an injected death: end quietly

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
            self._pool_failure(err, label)

    def _wait_inflight(self) -> None:
        """Bounded run-ahead: take a drain slot before dispatching, waiting
        while ``MAX_INFLIGHT`` bundles are undrained (outside ``_lock``,
        so the drain never waits on the dispatch thread). A dead drain
        thread is replaced (``supervise``) or its work done inline."""
        while not self._inflight.acquire(timeout=0.05):
            self._raise_worker_error()
            th = self._drain_thread
            if th is None or not th.is_alive():
                if self.supervise:
                    self._supervise_workers()
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
            if self.supervise:
                self._supervise_workers()
            self._wait_inflight()
            bundle = None
            with self._lock:
                self._reaped.extend(self._fold_lane_health())
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
                    bundle = _Bundle(None, None, None, None, entries)
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
        never leaves the flush waiting), the bundle it died in first."""
        while self._drainq.unfinished_tasks:
            th = self._drain_thread
            if th is not None and th.is_alive():
                time.sleep(0.002)
                continue
            item, self._resume_bundle = self._resume_bundle, None
            if item is None:
                try:
                    item = self._drainq.get_nowait()
                except _queue.Empty:
                    break
                if item is None:
                    self._drainq.task_done()
                    continue
            try:
                self._drain_one(item)
            except _faults.WorkerDeath:
                pass        # the bundle is kept; the loop resumes it

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
        if self._watchdog is not None:
            self._watchdog.start()
        self._driving = True
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
            self._driving = False
            self._driver = None
            if self._watchdog is not None:
                # every quantum of this run has been noted: one last
                # evaluation, then no ticker while nobody drives
                self._watchdog.check()
                self._watchdog.stop()

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
        if self._timers_hold is not None:
            self._timers_hold()      # gives the flag back once
        self._fail_all_outstanding("server closed")
        if self._manifest is not None:
            # every tenant is resolved: the compacted log is the geometry
            # and nothing outstanding. A failure leaves the full journal,
            # which stays valid
            try:
                self._manifest.compact()
            except Exception as e:  # noqa: BLE001 - bookkeeping only
                warnings.warn(f"manifest compaction at close failed "
                              f"({type(e).__name__}: {e}); the full "
                              "journal remains valid", RuntimeWarning)
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._atexit_registered:
            # a cleanly closed server leaves no postmortem behind
            with contextlib.suppress(Exception):
                atexit.unregister(self._atexit_dump)
            self._atexit_registered = False
        if self._sigterm_prev is not None:
            with contextlib.suppress(Exception):
                if signal.getsignal(signal.SIGTERM) == self._on_sigterm:
                    signal.signal(signal.SIGTERM, self._sigterm_prev)
            self._sigterm_prev = None
        self._refresh_obs()          # the pull surface's final state
        if self.http is not None:
            self.http.close()        # last: readable through the close
            self.http = None
        if self.spans is not None:
            self.spans.close()       # the JSONL sink only

    def _fail_all_outstanding(self, reason: str,
                              where: str = "close") -> None:
        """Resolve every handle the server still owns: queued and staged
        jobs as rejected, running (and released, unfinished) tenants with
        a :class:`TenantError` carrying their drained prefix."""
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
            self._note_fault(t, where, RuntimeError(reason))
            self._finalize_failed(t)

    # ------------------------------------------------------------------
    # crash recovery
    # ------------------------------------------------------------------

    @classmethod
    def recover(cls, manifest_dir: str, **overrides):
        """Rebuild a server from its crash-recovery manifest and resubmit
        every outstanding spooled tenant from its last spool checkpoint.
        Returns ``(server, handles)``, ``handles`` keyed by each recovered
        tenant's name (or spool directory); drive the server as usual.
        A resumed tenant's chains are bitwise its uninterrupted run (the
        spool resume contract); one that died before its first checkpoint
        restarts from its request, and a warm-started one then draws the
        same init from its journaled fit, with no pilot. A monitored
        tenant's monitor is re-armed from its journaled spec and backfilled
        from its spool, so it evaluates (and, under
        ``on_converged="evict"``, evicts) at the sweeps of the
        uninterrupted run. Its priority is kept as
        journaled, 0 included. Tenants admitted without a spool died
        with the process: they are listed on ``server.lost_tenants``.
        ``overrides`` are constructor arguments (``device``, ``pipeline``,
        ``http_port``, ...); the pool's geometry comes from the manifest.
        A tenant's ``trace_id`` is restored from its admission record.
        The log is compacted to the outstanding set afterwards."""
        template_ma, config, kw = load_server_state(manifest_dir)
        kw.update(overrides)
        recoverable, lost = outstanding_tenants(manifest_dir)
        srv = cls(template_ma, config, manifest_dir=manifest_dir, **kw)
        srv.lost_tenants = lost
        handles: Dict[object, TenantHandle] = {}
        for rec in recoverable:
            key = rec.get("name") or rec["spool_dir"]
            ma = load_tenant_model(manifest_dir, rec)
            try:
                state, next_sweep, _ = load_spool_state(rec["spool_dir"],
                                                        device="cpu")
            except (OSError, KeyError):
                # killed before its first checkpoint: start it afresh
                state, next_sweep = None, rec["start_sweep"]
            remaining = rec["niter"] - (next_sweep - rec["start_sweep"])
            if remaining <= 0:
                # served and checkpointed; only its delivery was lost
                h = TenantHandle(next(srv._ids), TenantRequest(
                    ma=ma, niter=rec["niter"], nchains=rec["nchains"],
                    seed=rec["seed"], spool_dir=rec["spool_dir"],
                    name=rec.get("name")))
                h._finish(load_spool(rec["spool_dir"]))
                srv._handles[h.tenant_id] = h
                handles[key] = h
                continue
            # the deadline was journaled relative to the admission's
            # start_sweep: re-anchor it, and drop one already passed
            dls = rec.get("deadline_sweeps")
            if dls is not None:
                dls = rec["start_sweep"] + int(dls) - next_sweep
                if dls <= 0:
                    dls = None
            mon = rec.get("monitor")
            if mon is not None:
                mon = MonitorSpec(**{k: v for k, v in mon.items()
                                     if v is not None})
            handles[key] = srv.submit(TenantRequest(
                ma=ma, niter=remaining, nchains=rec["nchains"],
                seed=rec["seed"], state=state, start_sweep=next_sweep,
                spool_dir=rec["spool_dir"], name=rec.get("name"),
                on_divergence=rec.get("on_divergence") or "none",
                on_converged=rec.get("on_converged") or "none",
                monitor=mon, warm_start=rec.get("warm"),
                trace_id=rec.get("trace_id"),
                priority=(1 if rec.get("priority") is None
                          else int(rec["priority"])),
                deadline_sweeps=dls))
        # the resubmissions are journaled in the new epoch: what came
        # before is history a later recovery need not read
        if srv._manifest is not None:
            srv._manifest.compact(keep_lost=False)
        return srv, handles

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
        """Latency percentiles, ms: submit -> admit (queue wait
        included), admit -> first drained records, and submit ->
        converged (monitored tenants whose targets held; ``n_converged``
        counts them), and the same per priority tier."""
        blk = {"admission_ms": _percentiles(self._admission_ms),
               "first_result_ms": _percentiles(self._first_result_ms),
               "converged_ms": _percentiles(self._converged_ms),
               "n_converged": len(self._converged_ms)}
        if self._tier_slo:
            blk["tiers"] = {
                str(tier): {leg: _percentiles(vals)
                            for leg, vals in legs.items()}
                for tier, legs in sorted(self._tier_slo.items())}
        return blk

    def _slo_raw(self) -> dict:
        """The raw series behind :meth:`_slo_block` (percentiles of
        several servers do not combine; their series do)."""
        return {
            "admission_ms": [round(v, 3) for v in self._admission_ms],
            "first_result_ms": [round(v, 3) for v in self._first_result_ms],
            "converged_ms": [round(v, 3) for v in self._converged_ms],
            "tiers": {str(tier): {leg: [round(v, 3) for v in vals]
                                  for leg, vals in legs.items()}
                      for tier, legs in sorted(self._tier_slo.items())}}

    def _status_locked(self) -> dict:
        """The :meth:`status` snapshot; the caller holds ``_lock``."""
        running = list(self._running.values())
        with self._prep_lock:
            staged = len(self._prepared) + self._staging_n
        busy = sum(t.slot.nchains for t in running)
        tenants = []
        for t in running:
            p = t.handle.progress()
            p.update({"lane0": int(t.slot.lanes[0]),
                      "lane_groups": len(t.slot.lanes) // self.pool.group,
                      "cancelled": bool(t.slot.cancelled),
                      "failed": bool(t.slot.failed),
                      "quarantined": len(t.slot.quarantined),
                      "reinits": t.slot.n_reinits})
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
            "supervise": self.supervise,
            "faults": dict(self._fault_counts),
            "stages": self._stages_block(),
            "watchdog": self._watchdog_block(),
            "sched": self._sched_block(),
            "slo": self._slo_block(),
            "slo_raw": self._slo_raw(),
            "tenants": tenants,
        }

    def status(self) -> dict:
        """A live snapshot: pool geometry and occupancy, queue and staging
        depth, the fault and scheduling counters, the watchdog, latency
        percentiles and their raw series, and one entry per running
        tenant (its :meth:`TenantHandle.progress`, with the convergence
        view of a monitored one, and its lanes). ``obs_dir/status.json``
        is this, refreshed every quantum. ``stages`` is the stage timers'
        per-stage view (schema ``stage_timings``; None with the timers off
        or before the first drain)."""
        with self._lock:
            return self._status_locked()

    def healthz(self) -> dict:
        """The liveness verdict: ``ok`` is False exactly when the POOL is
        unhealthy (a pool failure counted, a worker error latched, or the
        watchdog tripped); a contained tenant fault does not flip it.
        Lock-free (GIL-atomic reads only), so it answers during a stall of
        the dispatch thread, with the watchdog's cause."""
        err = self._worker_error
        wd = self._watchdog_block()
        tripped = wd.get("state") == "tripped"
        ok = (self._fault_counts["pool_failures"] == 0
              and err is None and not tripped)
        return {
            "ok": bool(ok),
            "t": round(time.time(), 3),
            "uptime_s": round(time.monotonic() - self._t_started, 3),
            "quanta": self.quanta,
            "running_tenants": len(self._running),
            "pipeline": bool(self.pipeline),
            "supervise": bool(self.supervise),
            "workers": {
                "driver": bool(self._thread is not None
                               and self._thread.is_alive()),
                "stage": bool(self._stage_thread is not None
                              and self._stage_thread.is_alive()),
                "drain": bool(self._drain_thread is not None
                              and self._drain_thread.is_alive()),
            },
            "worker_restarts": self._fault_counts["worker_restarts"],
            "pool_failures": self._fault_counts["pool_failures"],
            "watchdog": wd,
            "error": (f"{type(err).__name__}: {err}"
                      if err is not None
                      else (f"watchdog trip: {wd['trip']['cause']}"
                            if tripped and wd.get("trip") else None)),
        }

    def summary(self) -> dict:
        """Run-level serving numbers: ``occupancy`` is the chain-lane
        sweeps served over the lane sweeps advanced; ``busy_chain_sweeps``
        the sum over served tenants of chains x sweeps; ``host_ms`` the
        per-quantum host ms of admission, the dispatch (serial: until the
        records are on the host), the drain (after the records are on the
        host), the gap from one dispatch's end to the next one's start,
        the monitor feed (a drained quantum's tenants) and the
        ``obs_dir`` refresh; ``sched`` the scheduling counters; ``faults``
        the containment counters (tenants failed, lanes quarantined,
        chains re-drawn, workers restarted, pool failures);
        ``converged_evictions`` the tenants ``on_converged="evict"``
        ended early; ``recycle`` the recycled chain-rows delivered;
        ``warm`` the warm starts, degradations, pilot wall, pilot waves,
        fits served from a wave and flow fits; ``adapt`` the adaptive
        scan's gate updates and tenants thinned;
        ``cost["dispatch_wall_ms"]`` the sum of the quanta's dispatch
        walls, which the tenants' ``cost()["device_ms"]`` add up to;
        ``stages`` the stage timers' view (see :meth:`status`), which the
        tenants' ``cost()["stage_device_ms"]`` add up to."""
        occ = (self.busy_chain_sweeps / self.total_lane_sweeps
               if self.total_lane_sweeps else 0.0)
        return {"nlanes": self.pool.nlanes, "quantum": self.pool.quantum,
                "quanta": self.quanta, "occupancy": occ,
                "busy_chain_sweeps": self.busy_chain_sweeps,
                "pipeline": self.pipeline, "supervise": self.supervise,
                "admission_ms": (float(np.mean(self._admission_ms))
                                 if self._admission_ms else None),
                "admission_ms_max": (float(np.max(self._admission_ms))
                                     if self._admission_ms else None),
                "host_ms": {"admission": _percentiles(self._admit_apply_ms),
                            "dispatch": _percentiles(self._dispatch_ms),
                            "drain": _percentiles(self._drain_ms),
                            "dispatch_gap": _percentiles(self._gap_ms),
                            "monitor": _percentiles(self._monitor_ms),
                            "obs_refresh": _percentiles(self._refresh_ms)},
                "faults": dict(self._fault_counts),
                "converged_evictions": self._converged_evictions,
                "recycle": {"enabled": bool(self.recycle),
                            "recycled_lane_rows": self._recycled_lane_rows},
                "warm": {"warm_starts": self._warm_starts,
                         "degraded": self._warm_degraded,
                         "pilot_ms_total": round(self._warm_pilot_ms, 1),
                         "pilot_batches": self._warm_pilot_batches,
                         "pilot_batched_fits": self._warm_pilot_batched,
                         "flow_fits": self._warm_flow_fits,
                         "flow_degraded": self._warm_flow_degraded},
                "adapt": {"enabled": bool(self.pool.adaptive),
                          "updates": self._adapt_updates,
                          "tenants_thinned": len(self._adapt_tenants)},
                "sched": self._sched_block(),
                "slo": self._slo_block(),
                "stages": self._stages_block(),
                "watchdog": self._watchdog_block(),
                "cost": {"dispatch_wall_ms": self._dispatch_wall_ms}}

    # ------------------------------------------------------------------
    # cost accounting
    # ------------------------------------------------------------------

    @staticmethod
    def _cost_shares(running) -> List:
        """``[(handle, active lanes), ...]`` of one quantum's tenants
        (quarantined lanes are frozen: they do no work and buy no
        share)."""
        return [(t.handle, max(t.slot.nchains - len(t.slot.quarantined), 0))
                for t in running]

    @staticmethod
    def _attribute_cost(dispatch_ms: float, shares: List,
                        stage_ms: Optional[Dict[str, float]] = None) -> None:
        """Split one quantum's dispatch wall across its tenants by
        active-lane share; the shares sum to ``dispatch_ms``. ``stage_ms``,
        the quantum's stage-timer delta, splits by the same share into each
        tenant's ``cost()["stage_device_ms"]``. Runs on the drain thread
        (pipelined) or the serial loop's thread."""
        total = sum(a for _, a in shares)
        if total <= 0:
            return
        for handle, act in shares:
            if act:
                handle._add_cost(dispatch_ms * act / total, act)
                if stage_ms:
                    frac = act / total
                    handle._add_stage_cost(
                        {k: v * frac for k, v in stage_ms.items()})

    # ------------------------------------------------------------------
    # the profiling plane
    # ------------------------------------------------------------------

    def _stage_delta(self) -> Dict[str, float]:
        """The stage timers' ms since the last drain (``{stage: ms}``, {}
        with the timers off), folded into the run's totals. Called where
        the drained quantum's records are on the host, so its brackets are
        done; one writer, as the cost accumulators."""
        if not self.kernel_timers:
            return {}
        cur = _timers.timers_snapshot()
        delta = _timers.timers_delta_ms(self._stage_prev, cur)
        self._stage_prev = cur
        ms = {k: v["ms"] for k, v in delta.items()}
        if ms:
            for k, v in ms.items():
                self._stage_ms_total[k] = self._stage_ms_total.get(k, 0.0) + v
            self._stage_quanta += 1
            self._last_stage_ms = ms
        return ms

    def _stages_block(self) -> Optional[dict]:
        """``summary()``/``status()``'s per-stage view: total ms, ms a
        counted quantum and share of the dispatch wall; None while no
        stage time has been drained (timers off, or nothing drained
        yet)."""
        if not self._stage_ms_total:
            return None
        wall = self._dispatch_wall_ms
        nq = max(self._stage_quanta, 1)
        return {
            k: {"device_ms": round(v, 3),
                "ms_per_quantum": round(v / nq, 4),
                "share_of_dispatch": round(v / wall, 4) if wall else None}
            for k, v in sorted(self._stage_ms_total.items())}

    # ------------------------------------------------------------------
    # the flight recorder and the watchdog
    # ------------------------------------------------------------------

    def _watchdog_block(self) -> dict:
        """The watchdog's view for ``healthz()`` and ``status()``
        (lock-free: it answers during the stall it reports)."""
        if self._watchdog is None:
            return {"enabled": False, "policy": None, "state": "off",
                    "trip": None}
        return self._watchdog.snapshot()

    def _watchdog_trip(self, trip: dict) -> None:
        """The watchdog's one trip (on the ticker thread): a warning and
        an alert event; under ``dump`` and ``fail`` the postmortem; under
        ``fail`` a latched pool error, raised by the driver at its next
        boundary (a device call in flight cannot be killed safely)."""
        policy = self._watchdog.policy
        warnings.warn(
            f"serving watchdog tripped [{trip['cause']}]: "
            f"{trip['detail']} (policy {policy}); healthz now degraded",
            RuntimeWarning)
        if self.metrics is not None:
            try:
                self.metrics.counter("serve_watchdog_trips").inc()
                self.metrics.emit("watchdog_trip", cause=trip["cause"],
                                  detail=trip["detail"])
            except Exception:  # noqa: BLE001 - alerting only
                pass
        if self._manifest is not None:
            self._manifest.record("fault", tenant=None, where="watchdog",
                                  error=f"{trip['cause']}: "
                                        f"{trip['detail']}")
        if self.flight is not None:
            self.flight.note_event("watchdog_trip", **trip)
            if policy in ("dump", "fail"):
                self.dump_postmortem(reason=f"watchdog:{trip['cause']}")
        if policy == "fail" and self._worker_error is None:
            self._worker_error = RuntimeError(
                f"watchdog trip: {trip['cause']} ({trip['detail']})")
            self._worker_error_label = "watchdog"

    def _flight_context(self) -> dict:
        """The server's context in every flight bundle. Lock-free: it is
        composed while the dispatch thread may be stalled."""
        return {
            "quantum_idx": self.quanta,
            "nlanes": self.pool.nlanes,
            "quantum_sweeps": self.pool.quantum,
            "running_tenants": len(self._running),
            "queue_depth": len(self.queue),
            "pipeline": bool(self.pipeline),
            "faults": dict(self._fault_counts),
            "watchdog": self._watchdog_block(),
            "stage_totals_ms": {
                k: round(v, 3)
                for k, v in sorted(self._stage_ms_total.items())} or None,
            "kernel_timers": bool(self.kernel_timers),
        }

    def _flight_quantum(self, qidx: int, dispatch_ms: float, busy: int,
                        drain_ms: Optional[float],
                        stage_ms: Dict[str, float]) -> None:
        """One quantum's entry in the flight ring (at its drain, when its
        stage delta is known)."""
        if self.flight is None:
            return
        self.flight.note_quantum({
            "q": qidx,
            "t": round(time.time(), 3),
            "dispatch_ms": round(dispatch_ms, 3),
            "drain_ms": (round(drain_ms, 3)
                         if drain_ms is not None else None),
            "busy_lanes": busy,
            "occupancy_now": round(busy / self.pool.nlanes, 4),
            "queue_depth": len(self.queue),
            "faults": dict(self._fault_counts),
            "stage_device_ms": ({k: round(v, 3)
                                 for k, v in sorted(stage_ms.items())}
                                or None),
        })

    def dump_postmortem(self, path: Optional[str] = None,
                        reason: str = "manual") -> Optional[str]:
        """Write the flight recorder's postmortem bundle (the span tail
        included) atomically and return its path; ``path`` defaults to
        ``<flight_dir>/postmortem.json`` (the system's temporary directory
        without one). Raises only when the recorder is off; an IO failure
        warns and returns None."""
        if self.flight is None:
            raise ValueError(
                "flight recorder is disabled (ChainServer(flight=False))")
        if path is None:
            d = self._flight_dir or tempfile.gettempdir()
            path = os.path.join(d, "postmortem.json")
        return self.flight.dump(path, reason=reason, include_spans=True)

    def _dump_flight(self, reason: str) -> None:
        """The postmortem bundle to ``<flight_dir>/postmortem.json``, when
        the server has a flight directory (the recorder never raises)."""
        if self.flight is not None and self._flight_dir is not None:
            self.flight.dump(os.path.join(self._flight_dir,
                                          "postmortem.json"),
                             reason=reason, include_spans=True)

    def _postmortem_doc(self) -> Optional[dict]:
        """``GET /postmortem``: the bundle :meth:`dump_postmortem` writes,
        rendered in memory (None, a 404, with the recorder off)."""
        if self.flight is None:
            return None
        return self.flight.bundle("endpoint", include_spans=True)

    def _atexit_dump(self) -> None:
        """At interpreter exit, leave a bundle behind for a server still
        open (close() unregisters this)."""
        self._dump_flight("atexit")

    def _on_sigterm(self, signum, frame) -> None:
        """SIGTERM: dump the bundle, then deliver the default action, so
        the process still dies of the signal."""
        self._dump_flight("sigterm")
        try:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
        except Exception:  # noqa: BLE001
            raise SystemExit(143)

    # ------------------------------------------------------------------
    # the pull surface and the trace
    # ------------------------------------------------------------------

    def _refresh_obs(self, locked: bool = False) -> None:
        """Refresh the ``obs_dir`` pull surface (``status.json`` and
        ``metrics.prom``) at a quantum boundary: on the serial loop's
        thread, or the pipelined executor's drain thread. Atomic writes;
        a failure warns once and serving continues."""
        if self.obs_dir is None:
            return
        t0 = time.monotonic()
        try:
            st = self._status_locked() if locked else self.status()
            path = os.path.join(self.obs_dir, "status.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(_jsonable(st), fh)
            os.replace(tmp, path)
            if self.metrics is not None:
                write_prometheus(self.metrics,
                                 os.path.join(self.obs_dir, "metrics.prom"))
        except Exception as e:  # noqa: BLE001 - observability contract
            if not self._obs_warned:
                self._obs_warned = True
                warnings.warn(
                    f"obs_dir refresh failed ({type(e).__name__}: {e}); "
                    "serving continues without the pull surface",
                    RuntimeWarning)
        finally:
            self._refresh_ms.append((time.monotonic() - t0) * 1e3)

    def _metrics_text(self) -> Optional[str]:
        """``GET /metrics``: the exposition text ``metrics.prom`` holds
        (None, a 404, without a registry)."""
        if self.metrics is None:
            return None
        return prometheus_text(self.metrics.snapshot(),
                               ts_ms=int(time.time() * 1e3))

    def _trace_doc(self) -> Optional[dict]:
        """``GET /trace``: the document :meth:`export_trace` writes (None,
        a 404, with spans off)."""
        if self.spans is None:
            return None
        return self.spans.chrome_trace_doc(tenant_names=self._tenant_names)

    def _tenant_progress(self, key: str) -> Optional[dict]:
        """``GET /tenants/<key>/progress``: a handle's ``progress()``, by
        tenant id or request name (the latest submission wins a name).
        None, a 404, when no handle matches."""
        with self._lock:
            h = None
            try:
                h = self._handles.get(int(key))
            except (TypeError, ValueError):
                pass
            if h is None:
                for hh in self._handles.values():
                    if hh.request.name == key:
                        h = hh
        return None if h is None else h.progress()

    def export_trace(self, path: str) -> str:
        """Write the recorded executor spans as Chrome trace-event JSON
        (``chrome://tracing``, Perfetto): one swimlane per tenant, one
        track per thread role (staging, dispatch, drain). Returns
        ``path``."""
        if self.spans is None:
            raise ValueError(
                "span tracing is disabled (ChainServer(spans=False))")
        return self.spans.export_chrome_trace(
            path, tenant_names=self._tenant_names)
