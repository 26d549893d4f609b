"""FleetRouter: shard tenants across chain-server pools.

Counterpart of ``gibbs_student_t_tpu/serve/router.py``, class for class:
:class:`PoolSpec`, :class:`ProcPool` (a ``python -m
gibbs_student_t_tpu_torch.serve.pool_main`` worker and its wire clients),
:class:`LocalPool` (an in-process :class:`ChainServer` on a thread),
:class:`RoutedHandle`, :class:`FleetRouter`, :func:`spawn_fleet` and
:func:`teardown_fleet`. One pool is one server's lanes; the router turns
pool count into capacity, on one card (worker processes, each a CUDA
context of its own) or across hosts (:class:`~gibbs_student_t_tpu_torch.
serve.rpc.RemoteChainServer` is the same client either way).

**Placement** is by live pool status: at every ``submit`` the router
polls each pool (HTTP ``/status`` for a worker, ``status()`` for an
in-process pool) and places on the healthy pool with the lightest load,
``(queue_depth + staged, -free lanes, occupancy_now, estimated backlog,
-ess_per_core_s, admission p99)`` lexicographic, the pool index breaking
ties. A poll that fails reuses the pool's last snapshot while it is
fresher than ``status_stale_s``; a migration or a failover invalidates
the snapshot and fences polls in flight. ``placement="round_robin"``
forces a deterministic spread. A tenant's chains depend only on its
request, never on the lanes or the process that served it, so results are
bitwise the same under any placement. ``max_queue_depth`` sheds a submit
with :class:`~gibbs_student_t_tpu_torch.serve.scheduler.RetryAfter`
(``where="router"``) when even the least-loaded pool queues that deep.

**Failover** rides the crash manifest and ``ChainServer.recover``: a watch
thread polls each worker; a dead one (its process exited, or its wire
unreachable for :data:`DEAD_AFTER_POLLS` polls) is replaced by a
``pool_main --recover`` worker that resumes every spooled tenant from its
last checkpoint, and the router re-points the victims'
:class:`RoutedHandle` s at it, so a caller blocked in ``result()`` gets
its (bitwise the same) answer late. Unspooled victims are resubmitted
from scratch to a healthy pool; the replay is bitwise the lost run.
Tenants of the other pools are untouched.

**Live migration** (:meth:`FleetRouter.migrate`) cancels a tenant at its
next boundary, waits until the source has finalized it (the spool's
checkpoint is then fenced), and resubmits it to the target with
``resume_spool=True``, ``start_sweep`` at the checkpoint and
``state=None``: the target loads the state from the spool, and the
migrated tenant's result is bitwise the unmigrated run's. A queued tenant
is replayed on the target instead. ``rebalance=True`` runs a policy
thread that moves queued (and, with ``rebalance_running``, running
spooled) tenants from the most loaded pool to a drained one.

**The fleet wire**: ``http_port=`` mounts the read-only endpoints of
obs/http.py: ``GET /status`` answers the
:func:`~gibbs_student_t_tpu_torch.obs.aggregate.fleet_merge` snapshot with
a ``router`` block (placements, failovers, resubmissions, migrations,
sheds, dead pools), ``GET /healthz`` the fleet's liveness,
``GET /metrics`` the fleet's Prometheus text
(:func:`~gibbs_student_t_tpu_torch.obs.export.prometheus_labeled`),
``GET /trace`` the stitched trace of the router and its pools (each
pool's clock offset estimated over the RPC ``time`` op) and
``GET /postmortem`` the fleet's evidence bundle. The snapshot is the JAX
router's, key for key, so ``tools/fleet_status.py`` and
``tools/serve_top.py --url`` read a port router as they read a JAX one.

Every placement decision is journaled (``obs_dir/placements.jsonl`` and a
bounded tail, :meth:`FleetRouter.explain`); ``capacity_sample_s`` samples
the fleet's capacity into a ring (``obs_dir/capacity.jsonl``).

A worker's device comes from its spec's ``device`` keyword: the card
unless the spec says ``device="cpu"``; the router never touches CUDA.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import uuid
import warnings
from typing import Dict, List, Optional

from gibbs_student_t_tpu_torch.serve.rpc import RemoteChainServer

#: thread role tag on router-side spans (the pool-side roles are
#: staging/dispatch/drain; the router's single logical role keeps the
#: fleet trace's swimlane legend flat)
ROLE_ROUTER = "router"

#: default seconds between liveness sweeps of the failover watch
WATCH_POLL_S = 0.5

#: consecutive unreachable healthz polls before a live process's pool
#: counts as dead (a process that EXITED is dead immediately)
DEAD_AFTER_POLLS = 4


class PoolSpec:
    """What it takes to (re)spawn one subprocess pool: the directory
    the worker owns and the pickled server spec inside it. ``kwargs``
    are the worker's ChainServer arguments, the pool's record tier
    (``record``, ``"compact8"`` when absent) and ``heterogeneous`` flag
    among them."""

    def __init__(self, pool_dir: str, template_ma, config,
                 kwargs: Optional[dict] = None):
        self.pool_dir = os.path.abspath(pool_dir)
        self.template_ma = template_ma
        self.config = config
        self.kwargs = dict(kwargs or {})


class ProcPool:
    """One subprocess pool (serve/pool_main.py) and its wire clients.

    ``spawn`` writes the spec, launches the worker, and blocks until
    its ``ready.json`` handshake (the pool compile happens in the
    child; ``ready_timeout`` must cover it). ``recover_spawn`` boots a
    replacement through the manifest instead — ``recovered`` maps each
    logical job key (request name, else spool_dir) to its new tenant
    id, the rebinding input for the router's failover."""

    def __init__(self, spec: PoolSpec, proc, ready: dict):
        self.spec = spec
        self.proc = proc
        self.ready = ready
        self.rpc = RemoteChainServer(
            ("127.0.0.1", int(ready["rpc_port"])))
        self.status_url = (
            f"http://127.0.0.1:{ready['http_port']}"
            if ready.get("http_port") else None)
        self.label = os.path.basename(self.spec.pool_dir)

    # -- spawning -------------------------------------------------------

    @classmethod
    def spawn(cls, spec: PoolSpec, faults=None, env=None,
              ready_timeout: float = 600.0) -> "ProcPool":
        from gibbs_student_t_tpu_torch.serve import pool_main

        pool_main.write_spec(spec.pool_dir, spec.template_ma,
                             spec.config, spec.kwargs)
        return cls._launch(spec, ["--dir", spec.pool_dir], faults, env,
                           ready_timeout)

    @classmethod
    def recover_spawn(cls, spec: PoolSpec, faults=None, env=None,
                      ready_timeout: float = 600.0) -> "ProcPool":
        return cls._launch(spec,
                           ["--dir", spec.pool_dir, "--recover"],
                           faults, env, ready_timeout)

    @classmethod
    def _launch(cls, spec: PoolSpec, args: List[str], faults, env,
                ready_timeout: float) -> "ProcPool":
        import json as _json

        ready_path = os.path.join(spec.pool_dir, "ready.json")
        if os.path.exists(ready_path):
            os.unlink(ready_path)   # a stale handshake must not race
        cmd = [sys.executable, "-m",
               "gibbs_student_t_tpu_torch.serve.pool_main"] + args
        if faults:
            cmd += ["--faults", _json.dumps(list(faults))]
        child_env = dict(os.environ if env is None else env)
        # the worker must resolve the package no matter the caller's
        # cwd (pytest tmp dirs, service managers); its device is the
        # spec's
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        child_env["PYTHONPATH"] = pkg_root + (
            os.pathsep + child_env["PYTHONPATH"]
            if child_env.get("PYTHONPATH") else "")
        log = open(os.path.join(spec.pool_dir, "worker.log"), "ab")
        t_spawn = time.monotonic()
        try:
            proc = subprocess.Popen(cmd, env=child_env, stdout=log,
                                    stderr=subprocess.STDOUT)
        finally:
            log.close()
        deadline = time.monotonic() + ready_timeout
        while not os.path.exists(ready_path):
            if proc.poll() is not None:
                raise RuntimeError(
                    f"pool worker at {spec.pool_dir!r} died before "
                    f"ready (rc {proc.returncode}); see worker.log")
            if time.monotonic() > deadline:
                proc.kill()
                raise TimeoutError(
                    f"pool worker at {spec.pool_dir!r} not ready "
                    f"after {ready_timeout}s")
            time.sleep(0.05)
        with open(ready_path) as fh:
            ready = _json.load(fh)
        pool = cls(spec, proc, ready)
        # spawn→ready wall (the cold-start metric's first leg; the
        # worker's own boot/build breakdown rides ready["coldstart"])
        pool.spawn_s = round(time.monotonic() - t_spawn, 3)
        return pool

    # -- the pool surface the router drives -----------------------------

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def submit(self, request, timeout=None):
        return self.rpc.submit(request, timeout=timeout)

    def cancel(self, handle) -> bool:
        return self.rpc.cancel(handle)

    def status(self) -> dict:
        """Prefer the HTTP read wire (it answers during RPC load);
        fall back to the RPC status op."""
        if self.status_url is not None:
            from gibbs_student_t_tpu_torch.obs.aggregate import read_status

            return read_status(self.status_url, timeout=2.0)
        return self.rpc.status()

    def healthz(self) -> dict:
        return self.rpc.healthz()

    def reset_counters(self) -> None:
        self.rpc.reset_counters()

    def recover(self) -> "ProcPool":
        """The failover respawn: a fresh worker booted through this
        pool's manifest (``pool_main --recover``). The router calls
        this on whatever pool object died — the method IS the
        failover contract surface."""
        return ProcPool.recover_spawn(self.spec)

    def handle_for(self, tenant_id: int, request):
        """A caller-facing handle for an ALREADY-resident tenant (the
        failover rebinding path: the recovered worker advertised this
        id in ready.json)."""
        from gibbs_student_t_tpu_torch.serve.rpc import RemoteTenantHandle

        return RemoteTenantHandle(self.rpc, tenant_id, request)

    def close(self, grace: float = 30.0) -> None:
        """Retire the worker: polite shutdown RPC, then SIGKILL."""
        if self.alive:
            try:
                self.rpc.shutdown()
            except Exception:  # noqa: BLE001 - already dying is fine
                pass
            try:
                self.proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10.0)
        self.rpc.close()

    def kill(self) -> None:
        """The impolite path (tests tearing down a chaos arm)."""
        if self.alive:
            self.proc.kill()
            self.proc.wait(timeout=10.0)


class LocalPool:
    """An in-process pool: a ChainServer driven on a background
    thread, presented through the same surface as :class:`ProcPool`
    (the tier-1 fleet tests ride these — no subprocess spawn, no
    wire, same router code paths)."""

    def __init__(self, server, label: str = "local"):
        self.server = server
        self.label = label
        self.proc = None
        self.status_url = None
        server.start()

    @property
    def alive(self) -> bool:
        return self.server._thread is not None \
            and self.server._thread.is_alive()

    def submit(self, request, timeout=None):
        return self.server.submit(request, timeout=timeout)

    def cancel(self, handle) -> bool:
        return self.server.cancel(handle)

    def status(self) -> dict:
        return self.server.status()

    def healthz(self) -> dict:
        return self.server.healthz()

    def reset_counters(self) -> None:
        self.server.reset_counters()

    def close(self, grace: float = 30.0) -> None:
        self.server.close()

    def kill(self) -> None:
        self.server.close()


class RoutedHandle:
    """The router's caller-facing handle: delegates to the placed
    pool's handle and survives a failover rebinding — ``result()``
    blocked on a dying pool's wire retries on the replacement handle
    once the watch thread re-points it (``_rebind``), so fleet callers
    never observe the recovery, only latency."""

    def __init__(self, router: "FleetRouter", request, pool_idx: int,
                 inner):
        self.router = router
        self.request = request
        self.pool_idx = pool_idx
        self._inner = inner
        self._gen = 0               # bumps at every rebind
        self._rebound = threading.Event()
        # raised for the duration of a live migration: the source
        # pool's cancel-freeze makes the old inner LOOK finished (its
        # result is the served prefix), so while this latch is up a
        # terminal outcome from the pre-migration generation is
        # discarded and the caller's wait rides through to the
        # resumed tenant — the same ride-through contract failover
        # gives callers blocked in result()
        self._migrating = threading.Event()
        # a migration that cancelled the tenant and then could not
        # resume it ANYWHERE poisons the handle: result() raises this
        # instead of passing the served prefix off as the result
        self._migration_error: Optional[BaseException] = None
        # the router trace's terminal span latches once
        self._result_span = False

    @property
    def tenant_id(self):
        return self._inner.tenant_id

    def _rebind(self, pool_idx: int, inner) -> None:
        self.pool_idx = pool_idx
        self._inner = inner
        self._gen += 1
        self._rebound.set()

    def _retryable(self, fn, *a, **kw):
        """Run one delegated call; on a severed wire wait (bounded) for
        a failover rebind and retry once per generation."""
        while True:
            gen, inner = self._gen, self._inner
            try:
                return fn(inner, *a, **kw)
            except (ConnectionError, OSError) as e:
                if self._gen != gen:
                    continue   # already rebound: retry immediately
                self._rebound.clear()
                if not self._rebound.wait(
                        timeout=self.router.failover_timeout):
                    if self._gen != gen:
                        # a rebind landed between the gen check and
                        # clear() (its set() was discarded): the
                        # failover DID happen — retry, don't raise
                        continue
                    raise ConnectionError(
                        f"pool {self.pool_idx} unreachable and no "
                        f"failover within "
                        f"{self.router.failover_timeout}s") from e

    def progress(self):
        return self._retryable(lambda h: h.progress())

    def cost(self):
        return self._retryable(lambda h: h.cost())

    def done(self) -> bool:
        if self._migrating.is_set():
            # the source's cancel-freeze resolves the OLD inner; the
            # tenant itself is mid-flight to another pool
            return False
        return self._retryable(lambda h: h.done())

    @property
    def status(self):
        inner = self._inner
        st = getattr(inner, "status", None)
        return st if isinstance(st, str) else self.progress().get("status")

    def cancel(self) -> bool:
        return self.router.cancel(self)

    def _ride_migration(self, gen: int) -> bool:
        """True when an outcome observed at generation ``gen`` belongs
        to a migration in flight (or one that just landed) and must be
        discarded: wait briefly for the rebind, then re-poll the new
        inner."""
        if self._gen != gen:
            return True
        if not self._migrating.is_set():
            return False
        self._rebound.wait(timeout=1.0)
        return True

    def result(self, timeout: Optional[float] = None):
        t_entry = time.monotonic()
        deadline = (None if timeout is None
                    else t_entry + timeout)
        while True:
            remaining = (None if deadline is None
                         else max(deadline - time.monotonic(), 0.0))
            gen = self._gen
            try:
                res = self._retryable(
                    lambda h, r=remaining: h.result(timeout=r))
            except TimeoutError:
                if deadline is not None \
                        and time.monotonic() >= deadline:
                    raise
                continue
                # a server-side wait expiring under an open deadline
                # (failover window): poll again
            except Exception:
                # a migration's cancel resolves the old inner with
                # the served-prefix/cancelled outcome — discard it
                # and wait out the rebind; anything outside a
                # migration is a real failure
                if self._ride_migration(gen):
                    continue
                raise
            if self._ride_migration(gen):
                continue   # pre-migration prefix, not the result
            if self._migration_error is not None:
                raise self._migration_error
            self._record_result_span(t_entry)
            return res

    def _record_result_span(self, t0: float) -> None:
        """One terminal router span per job (latched): the caller's
        result() wait, tagged with the job's trace id — the span that
        closes the placement → submit → pool-execution story in the
        stitched fleet trace. Never raises."""
        if self._result_span:
            return
        self._result_span = True
        spans = getattr(self.router, "spans", None)
        if spans is None:
            return
        spans.record(
            "result", ROLE_ROUTER, t0, time.monotonic() - t0,
            trace_id=getattr(self.request, "trace_id", None),
            job=getattr(self.request, "name", None),
            pool=getattr(self.router.pools[self.pool_idx], "label",
                         str(self.pool_idx)))


class FleetRouter:
    """Shard tenants across pools; fail over through the manifest.

    ``pools`` is a list of :class:`ProcPool` / :class:`LocalPool` (or
    anything with their surface). ``placement`` is ``"load"`` (the
    status-driven default) or ``"round_robin"`` (deterministic spread).
    ``failover=True`` starts the liveness watch (subprocess pools
    only: an in-process pool shares our fate). ``http_port`` mounts
    the fleet-level read-only wire."""

    def __init__(self, pools: List, placement: str = "load",
                 failover: bool = True,
                 failover_timeout: float = 900.0,
                 watch_poll_s: float = WATCH_POLL_S,
                 status_stale_s: float = 30.0,
                 http_port: Optional[int] = None,
                 http_host: str = "127.0.0.1",
                 rebalance: bool = False,
                 rebalance_poll_s: float = 2.0,
                 rebalance_min_sweeps: float = 0.0,
                 rebalance_running: bool = False,
                 trace: bool = True,
                 span_capacity: int = 65536,
                 obs_dir: Optional[str] = None,
                 capacity_sample_s: float = 0.0,
                 capacity_ring: int = 512,
                 max_queue_depth: Optional[int] = None):
        if placement not in ("load", "round_robin"):
            raise ValueError(
                f"placement must be 'load' or 'round_robin', got "
                f"{placement!r}")
        if not pools:
            raise ValueError("a fleet needs at least one pool")
        self.pools: List = list(pools)
        self.placement = placement
        self.failover_timeout = failover_timeout
        self._lock = threading.Lock()
        self._routed: List[RoutedHandle] = []
        self._rr_next = 0
        self._dead: set = set()
        self._unreachable: Dict[int, int] = {}
        # last good status per pool + its timestamp: a pool busy
        # inside a quantum holds its server lock, so its status
        # endpoint can time out under load — placement then reuses
        # the last snapshot (bounded by ``status_stale_s``) instead of
        # EXCLUDING the pool, which would bias every submit toward
        # whichever pool happens to be idle enough to answer
        self.status_stale_s = status_stale_s
        self._status_cache: Dict[int, tuple] = {}
        # per-pool cache generation: bumped whenever a pool's identity
        # or load changes OUT OF BAND (failover respawn, migration) so
        # an in-flight poll of the OLD pool can never write a stale
        # snapshot back after the invalidation — without this, a
        # recovered pool could sit behind a stale "loaded" snapshot
        # for a full status_stale_s TTL and receive no placements
        self._status_gen: Dict[int, int] = {}
        self.placements: Dict[str, int] = {}
        self.failovers = 0
        self.resubmitted = 0
        # fleet-wide admission control: with
        # ``max_queue_depth`` set, a submit that would land on a fleet
        # whose LEAST-loaded live pool already queues that deep is
        # shed with a structured RetryAfter (where="router") instead
        # of growing an unbounded queue. Priority-0 (interactive)
        # requests get double the depth allowance — under sustained
        # overload the low tier sheds first, which is exactly the
        # degradation order the overload bench grades.
        self.max_queue_depth = (None if max_queue_depth is None
                                else int(max_queue_depth))
        self.sheds = 0
        self.sheds_by_tier: Dict[int, int] = {}
        # live migration (re-balancing long tenants onto drained
        # pools): counters + the optional policy thread
        self.rebalance = bool(rebalance)
        self.rebalance_min_sweeps = float(rebalance_min_sweeps)
        # queued steals are near-free replays; stealing a RUNNING
        # tenant pays a checkpoint round-trip measured in quanta —
        # on shared-core hosts it only wins for deep queues and long
        # residents, so the policy takes it opt-in (explicit
        # ``migrate()`` is always available either way)
        self.rebalance_running = bool(rebalance_running)
        self.migrations = 0
        self.migration_failures = 0
        #: queued-steal rebalance migrations (the subset of
        #: ``migrations`` initiated by the policy thread)
        self.steals = 0
        # ------------------------------------------------------------
        # the router-side observability plane. All knobs are
        # constructor params, not env gates: the router is always
        # constructed explicitly.
        # ------------------------------------------------------------
        self.spans = None
        if trace:
            from gibbs_student_t_tpu_torch.obs.spans import SpanRecorder

            # pure host bookkeeping: chains are bitwise identical with
            # the fleet plane on or off
            self.spans = SpanRecorder(capacity=span_capacity)
        self.obs_dir = obs_dir
        self._journal_path = None
        self._capacity_path = None
        self._postmortem_path = None
        if obs_dir:
            try:
                os.makedirs(obs_dir, exist_ok=True)
                self._journal_path = os.path.join(
                    obs_dir, "placements.jsonl")
                self._capacity_path = os.path.join(
                    obs_dir, "capacity.jsonl")
                self._postmortem_path = os.path.join(
                    obs_dir, "fleet_postmortem.json")
            except OSError as e:
                warnings.warn(
                    f"fleet obs_dir {obs_dir!r} could not be created "
                    f"({e}); journals disabled, routing continues",
                    RuntimeWarning)
        # explainable placement: every placement decision (submit,
        # failover resubmit, migration resume) appends one event to
        # the journal (obs/ledger record discipline: atomic line
        # appends, warn-and-continue) and to a bounded in-memory tail
        # (the ``explain()`` query + postmortem evidence)
        self.placement_events = 0
        self._placement_tail = collections.deque(maxlen=256)
        self._journal_warned = False
        # capacity timeline: bounded ring + optional JSONL series
        self.capacity_sample_s = float(capacity_sample_s or 0.0)
        self._capacity_ring = collections.deque(
            maxlen=max(int(capacity_ring), 1))
        self.capacity_samples = 0
        self._capacity_warned = False
        self._stop = threading.Event()
        self._watch: Optional[threading.Thread] = None
        if failover:
            self._watch = threading.Thread(
                target=self._watch_loop, args=(watch_poll_s,),
                name="gst-fleet-watch", daemon=True)
            self._watch.start()
        self._rebal: Optional[threading.Thread] = None
        if rebalance:
            self._rebal = threading.Thread(
                target=self._rebalance_loop, args=(rebalance_poll_s,),
                name="gst-fleet-rebalance", daemon=True)
            self._rebal.start()
        self._sampler: Optional[threading.Thread] = None
        if self.capacity_sample_s > 0:
            self._sampler = threading.Thread(
                target=self._capacity_loop,
                args=(self.capacity_sample_s,),
                name="gst-fleet-capacity", daemon=True)
            self._sampler.start()
        self.http = None
        if http_port is not None:
            try:
                from gibbs_student_t_tpu_torch.obs.http import ObsHttpServer

                self.http = ObsHttpServer(
                    host=http_host, port=http_port,
                    status_fn=self.fleet_status,
                    healthz_fn=self.healthz,
                    metrics_fn=self.metrics_text,
                    trace_fn=self.export_trace,
                    postmortem_fn=self.fleet_postmortem)
            except Exception as e:  # noqa: BLE001 - obs contract
                warnings.warn(
                    f"fleet observability endpoint failed to start "
                    f"({type(e).__name__}: {e}); routing continues "
                    "without the wire", RuntimeWarning)

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def _statuses(self, meta: Optional[dict] = None) -> List:
        """[(pool_idx, status-or-Exception)] for every live pool; a
        failed poll degrades to the pool's last snapshot while it is
        fresher than ``status_stale_s`` (see the cache comment in
        ``__init__``). ``meta``, when given, is filled with
        ``{pool_idx: cache_age_s}`` — 0.0 for a fresh poll, the
        snapshot's age when the cache served it (the explainable-
        placement evidence: a decision made on stale data says so)."""
        out = []
        t_poll0 = time.monotonic()
        now = t_poll0
        for i, p in enumerate(self.pools):
            if i in self._dead:
                out.append((i, ConnectionError("pool marked dead")))
                continue
            gen = self._status_gen.get(i, 0)
            try:
                st = p.status()
                if self._status_gen.get(i, 0) == gen:
                    # only cache when the pool was not invalidated
                    # (failover/migration) while this poll was in
                    # flight — a snapshot of the OLD pool must not
                    # outlive its replacement
                    self._status_cache[i] = (now, st)
                if meta is not None:
                    meta[i] = 0.0
                out.append((i, st))
            except Exception as e:  # noqa: BLE001 - a dead pool is data
                cached = self._status_cache.get(i)
                if cached is not None \
                        and now - cached[0] <= self.status_stale_s:
                    if meta is not None:
                        meta[i] = round(now - cached[0], 3)
                    out.append((i, cached[1]))
                else:
                    out.append((i, e))
        if self.spans is not None:
            self.spans.record(
                "status_poll", ROLE_ROUTER, t_poll0,
                time.monotonic() - t_poll0,
                n_pools=len(self.pools),
                n_reachable=sum(1 for _, st in out
                                if isinstance(st, dict)))
        return out

    def _invalidate_status(self, idx: int) -> None:
        """Drop pool ``idx``'s cached snapshot NOW and fence any poll
        already in flight against re-caching it (the bounded-staleness
        cache serves placement when a busy pool's poll times out — a
        respawned or migration-rebalanced pool must never hide behind
        its predecessor's load for a TTL)."""
        self._status_gen[idx] = self._status_gen.get(idx, 0) + 1
        self._status_cache.pop(idx, None)

    @staticmethod
    def _est_backlog(st: dict) -> float:
        """Estimated chain-sweeps still owed to the pool's RESIDENT
        tenants (cost-aware placement): per tenant, the
        monitor's ``est_sweeps_to_target`` when the snapshot carries
        one (capped by the remaining budget — an ``on_converged=
        'evict'`` tenant never serves past either), else the remaining
        budget, × its chain lanes. Two pools at equal occupancy can
        hide very different drain horizons: one full of nearly-
        converged tenants frees lanes quanta sooner than one that
        just admitted its residents — this is the number that sees
        the difference. 0.0 for snapshots without tenant entries
        (stale-cache degradation unchanged: the score falls back to
        the occupancy legs)."""
        total = 0.0
        for t in st.get("tenants") or []:
            if not isinstance(t, dict):
                continue
            rem = max((t.get("niter") or 0)
                      - (t.get("sweeps_done") or 0), 0)
            est = t.get("est_sweeps_to_target")
            if isinstance(est, (int, float)) and not isinstance(
                    est, bool):
                rem = min(rem, max(float(est), 0.0))
            total += rem * (t.get("nchains") or 0)
        return total

    @staticmethod
    def _pool_efficiency(st: dict) -> float:
        """Mean monitored ``cost.ess_per_core_s`` over the pool's
        resident tenants (0.0 when no tenant carries one — the
        monitor-absent degradation): the delivered-statistics-per-
        compute signal placement reads. Used NEGATED in the
        score (higher efficiency is better), as the tie-break after
        the backlog/occupancy legs."""
        vals = [t["cost"]["ess_per_core_s"]
                for t in st.get("tenants") or []
                if isinstance(t, dict)
                and isinstance(t.get("cost"), dict)
                and isinstance(t["cost"].get("ess_per_core_s"),
                               (int, float))]
        return float(sum(vals) / len(vals)) if vals else 0.0

    @staticmethod
    def _load_score(st: dict):
        """Lower is better: queue pressure first, then free lanes,
        then occupancy, then the cost legs (estimated resident
        backlog in chain-sweeps, negated pool ess/core-s efficiency —
        both 0 when the snapshot carries no tenant evidence, leaving
        the historical ordering untouched), then the admission-p99
        SLO. Ties break on pool index (the caller pairs the score
        with it) — deterministic."""
        free = (st.get("free_groups") or 0) * (st.get("group") or 1)
        p99 = (((st.get("slo") or {}).get("admission_ms") or {})
               .get("p99")) or 0.0
        return ((st.get("queue_depth") or 0) + (st.get("staged") or 0),
                -free, st.get("occupancy_now") or 0.0,
                FleetRouter._est_backlog(st),
                -FleetRouter._pool_efficiency(st), p99)

    def _place(self, request,
               explain: Optional[dict] = None) -> int:
        """Choose the pool for one request (caller holds ``_lock``).
        ``explain``, when given, is filled with the decision's full
        evidence — per-candidate score breakdown, status-cache ages
        and which leg won — the ``placement_event`` journal payload
        ("why did job J land on pool K" is recorded, not
        reconstructed)."""
        live = [i for i in range(len(self.pools))
                if i not in self._dead]
        if not live:
            raise RuntimeError("no live pools in the fleet")
        if self.placement == "round_robin":
            for _ in range(len(self.pools)):
                i = self._rr_next % len(self.pools)
                self._rr_next += 1
                if i in live:
                    if explain is not None:
                        explain["won"] = "round_robin"
                    return i
            if explain is not None:
                explain["won"] = "fallback"
            return live[0]
        scored = []
        cands = []
        ages: dict = {}
        free_lanes: Dict[int, int] = {}
        for i, st in self._statuses(meta=ages):
            row = {"pool": getattr(self.pools[i], "label", str(i)),
                   "pool_idx": i,
                   "reachable": isinstance(st, dict),
                   "cache_age_s": ages.get(i)}
            if isinstance(st, dict):
                faults = st.get("faults") or {}
                healthy = not faults.get("pool_failures")
                row["healthy"] = bool(healthy)
                score = self._load_score(st)
                free_lanes[i] = ((st.get("free_groups") or 0)
                                 * (st.get("group") or 1))
                row["score"] = {
                    "queue_staged": score[0],
                    "free_lanes": -score[1],
                    "occupancy_now": score[2],
                    "est_backlog": score[3],
                    "ess_per_core_s": -score[4],
                    "admission_p99_ms": score[5],
                }
                if healthy:
                    scored.append((score, i))
            else:
                row["healthy"] = False
                row["error"] = f"{type(st).__name__}: {st}"
            cands.append(row)
        if explain is not None:
            explain["candidates"] = cands
        if not scored:
            # every pool unreachable/sick right now: fall back to a
            # deterministic spread rather than refusing service
            if explain is not None:
                explain["won"] = "fallback"
            return live[0]
        # urgent placement: an interactive (priority-0) or
        # deadline-armed request prefers a pool that can admit it
        # WITHOUT queueing — when any live pool has the free lanes,
        # the candidate set narrows to those pools (the slack score
        # then orders within them); otherwise the full set competes
        # and the pool-side preemption machinery takes over
        urgent = (int(getattr(request, "priority", 1)) == 0
                  or getattr(request, "deadline_sweeps", None)
                  is not None)
        if urgent:
            fits = [(s, i) for s, i in scored
                    if free_lanes.get(i, 0) >= request.nchains]
            if fits:
                if explain is not None:
                    explain["won"] = "urgent_fit"
                return min(fits)[1]
        if explain is not None:
            explain["won"] = "score"
        return min(scored)[1]

    def _shed_check(self, request) -> None:
        """Fleet-wide admission control (caller holds ``_lock``): with
        ``max_queue_depth`` armed, raise a structured
        :class:`RetryAfter` (``where="router"``) when even the
        least-loaded live pool already queues at or past the bound —
        the queue must shed, not grow. ``queue_depth`` reports that
        minimum (the best door that still refused); ``retry_after_s``
        comes from the fleet's admission-p99 evidence when it has any.
        Priority-0 requests shed at twice the depth."""
        if self.max_queue_depth is None:
            return
        tier = int(getattr(request, "priority", 1))
        bound = self.max_queue_depth * (2 if tier == 0 else 1)
        depths = []
        p99s = []
        for i, st in self._statuses():
            if not isinstance(st, dict) or i in self._dead:
                continue
            depths.append((st.get("queue_depth") or 0)
                          + (st.get("staged") or 0))
            p99 = (((st.get("slo") or {}).get("admission_ms") or {})
                   .get("p99"))
            if isinstance(p99, (int, float)):
                p99s.append(float(p99))
        if not depths or min(depths) < bound:
            return
        retry_s = (max(0.5, sorted(p99s)[len(p99s) // 2] / 1e3)
                   if p99s else 1.0)
        self.sheds += 1
        self.sheds_by_tier[tier] = self.sheds_by_tier.get(tier, 0) + 1
        if self.spans is not None:
            self.spans.record(
                "shed", ROLE_ROUTER, time.monotonic(), 0.0,
                trace_id=getattr(request, "trace_id", None),
                job=getattr(request, "name", None), tier=tier,
                queue_depth=min(depths))
        from gibbs_student_t_tpu_torch.serve.scheduler import RetryAfter

        raise RetryAfter(
            f"fleet overloaded: least-loaded pool queues "
            f"{min(depths)} deep (bound {bound}); retry in "
            f"~{retry_s:.1f}s",
            retry_after_s=round(retry_s, 3), queue_depth=min(depths),
            tier=tier, where="router")

    # ------------------------------------------------------------------
    # the ChainServer-shaped fleet surface
    # ------------------------------------------------------------------

    def submit(self, request, timeout=None,
               pool: Optional[int] = None) -> RoutedHandle:
        """Place one tenant and return its routed handle. Placement is
        status-driven (one poll sweep per submit — submits are rare
        next to quanta); the chosen pool's own admission queue applies
        its backpressure policy. ``pool`` pins the placement to one
        pool index — the operational escape hatch (and a way to make
        an imbalance on purpose); a pinned dead pool raises."""
        # trace-context propagation: mint the job's
        # correlation id here — it rides the RPC submit frame, the
        # pool tags the tenant's spans with it, and every router span
        # below carries it, so the stitched fleet trace shows this
        # job's placement → submit → pool execution → result as one
        # correlated story. Pure metadata: chain math never sees it.
        if getattr(request, "trace_id", None) is None:
            from dataclasses import replace as _replace

            request = _replace(request,
                               trace_id=uuid.uuid4().hex[:16])
        t_sub0 = time.monotonic()
        with self._lock:
            explain: dict = {}
            t_place0 = time.monotonic()
            if pool is not None:
                if pool in self._dead:
                    raise RuntimeError(
                        f"pinned pool {pool} is dead")
                idx = pool
                explain["won"] = "pinned"
            else:
                self._shed_check(request)
                idx = self._place(request, explain=explain)
            if self.spans is not None:
                self.spans.record(
                    "place", ROLE_ROUTER, t_place0,
                    time.monotonic() - t_place0,
                    trace_id=request.trace_id,
                    pool=getattr(self.pools[idx], "label", str(idx)),
                    won=explain.get("won"))
            inner = self.pools[idx].submit(request, timeout=timeout)
            rh = RoutedHandle(self, request, idx, inner)
            self._routed.append(rh)
            label = self.pools[idx].label
            self.placements[label] = self.placements.get(label, 0) + 1
            self._record_placement("submit", request, idx, explain)
            # account the submit in the cached snapshot so a burst of
            # placements between polls (or against a stale snapshot)
            # still joins the shortest queue
            cached = self._status_cache.get(idx)
            if cached is not None:
                cached[1]["queue_depth"] = \
                    (cached[1].get("queue_depth") or 0) + 1
        if self.spans is not None:
            self.spans.record(
                "submit", ROLE_ROUTER, t_sub0,
                time.monotonic() - t_sub0,
                trace_id=request.trace_id, job=request.name,
                pool=getattr(self.pools[idx], "label", str(idx)))
        return rh

    def cancel(self, handle: RoutedHandle) -> bool:
        try:
            return self.pools[handle.pool_idx].cancel(handle._inner)
        except Exception:  # noqa: BLE001 - a dead pool can't cancel
            return False

    def healthz(self) -> dict:
        """Fleet liveness: ok while at least one pool serves and no
        dead pool is stuck unrecovered."""
        per_pool = []
        n_ok = 0
        for i, p in enumerate(self.pools):
            if i in self._dead:
                per_pool.append({"pool": p.label, "ok": False,
                                 "error": "dead, recovery pending"})
                continue
            try:
                h = p.healthz()
                ok = bool(h.get("ok"))
            except Exception as e:  # noqa: BLE001
                h, ok = {"error": f"{type(e).__name__}: {e}"}, False
            n_ok += ok
            per_pool.append({"pool": p.label, "ok": ok,
                             "error": h.get("error")})
        return {
            "ok": n_ok > 0 and not self._dead,
            "t": round(time.time(), 3),
            "n_pools": len(self.pools),
            "n_ok": n_ok,
            "failovers": self.failovers,
            "pools": per_pool,
        }

    def fleet_status(self) -> dict:
        """The aggregated fleet snapshot (obs/aggregate.fleet_merge —
        the same semantics as ``tools/fleet_status.py``) plus the
        ``router`` block: placement counts per pool, failovers,
        replay resubmissions, currently-dead pools."""
        from gibbs_student_t_tpu_torch.obs.aggregate import fleet_merge

        results = []
        for i, st in self._statuses():
            results.append((self.pools[i].label, st))
        snap = fleet_merge(results)
        snap["router"] = {
            "placement": self.placement,
            "placements": dict(self.placements),
            "failovers": self.failovers,
            "resubmitted": self.resubmitted,
            "dead_pools": len(self._dead),
            "rebalance": bool(self.rebalance),
            "migrations": self.migrations,
            "migration_failures": self.migration_failures,
            "steals": self.steals,
            "placement_events": self.placement_events,
            "capacity_samples": self.capacity_samples,
            # fleet admission control: the shed bound and
            # the structured-retry-after rejections it issued
            "max_queue_depth": self.max_queue_depth,
            "sheds": self.sheds,
            "sheds_by_tier": {str(k): v for k, v in
                              sorted(self.sheds_by_tier.items())},
        }
        return snap

    def reset_counters(self) -> None:
        """Zero every pool's run-level aggregates plus the router's
        own placement counters (a warmup boundary)."""
        for p in self.pools:
            try:
                p.reset_counters()
            except Exception:  # noqa: BLE001 - a dead pool resets later
                pass
        with self._lock:
            self.placements.clear()
            self.resubmitted = 0
            self.migrations = 0
            self.migration_failures = 0
            self.steals = 0
            # the placement-event counter resets WITH the placement
            # counts (they reconcile 1:1); the
            # journal file keeps its warmup lines, each stamped, so
            # the full history stays queryable
            self.placement_events = 0
            self._placement_tail.clear()
            self.sheds = 0
            self.sheds_by_tier = {}

    def close(self, grace: float = 30.0) -> None:
        """Retire the fleet: stop the watch, close the wire, shut
        every pool down politely."""
        self._stop.set()
        if self._watch is not None:
            self._watch.join(timeout=5.0)
            self._watch = None
        if self._rebal is not None:
            self._rebal.join(timeout=5.0)
            self._rebal = None
        if self._sampler is not None:
            self._sampler.join(timeout=5.0)
            self._sampler = None
        if self.http is not None:
            self.http.close()
            self.http = None
        for p in self.pools:
            try:
                p.close(grace=grace)
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass

    # ------------------------------------------------------------------
    # explainable placement: the append-only decision journal
    # ------------------------------------------------------------------

    def _append_jsonl(self, path: Optional[str], rec: dict) -> None:
        """One atomic journal line (obs/ledger discipline: O_APPEND
        single write — concurrent writers interleave whole lines, a
        crash tears at most the tail the readers already skip).
        Warn-and-continue: a failing journal never fails routing."""
        if path is None:
            return
        try:
            line = (json.dumps(rec) + "\n").encode()
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o644)
            try:
                os.write(fd, line)
            finally:
                os.close(fd)
        except Exception as e:  # noqa: BLE001 - obs must not raise
            if not self._journal_warned:
                self._journal_warned = True
                warnings.warn(
                    f"fleet journal append to {path!r} failed "
                    f"({type(e).__name__}: {e}); journaling degraded, "
                    "routing continues", RuntimeWarning)

    def _record_placement(self, reason: str, request, idx: int,
                          explain: Optional[dict] = None) -> None:
        """Record one placement decision (caller holds ``_lock``):
        the ``placement_event`` schema — who, where, why, with the
        full per-candidate score breakdown when the load leg decided.
        Exactly one event per ``placements`` counter bump, so the
        journal reconciles 1:1 with the router block."""
        try:
            explain = explain or {}
            event = {
                "schema": 1,
                "kind": "placement",
                "t": round(time.time(), 6),
                "reason": reason,
                "trace_id": getattr(request, "trace_id", None),
                "job": getattr(request, "name", None),
                "pool": getattr(self.pools[idx], "label", str(idx)),
                "pool_idx": idx,
                "placement": self.placement,
                "won": explain.get("won"),
                "candidates": explain.get("candidates") or [],
            }
            self.placement_events += 1
            self._placement_tail.append(event)
            self._append_jsonl(self._journal_path, event)
        except Exception:  # noqa: BLE001 - obs must not raise
            pass

    def explain(self, job) -> List[dict]:
        """Placement events for one job — "why did job J land on pool
        K" as recorded evidence. ``job`` is a :class:`RoutedHandle`, a
        trace id, or a request name. Reads the journal file when one
        is armed (complete, survives counter resets), else the bounded
        in-memory tail. Malformed/torn journal lines are skipped."""
        if isinstance(job, RoutedHandle):
            keys = {getattr(job.request, "trace_id", None),
                    getattr(job.request, "name", None)} - {None}
        else:
            keys = {job}
        events = []
        if self._journal_path is not None \
                and os.path.exists(self._journal_path):
            try:
                with open(self._journal_path) as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except json.JSONDecodeError:
                            continue   # torn tail
                        events.append(rec)
            except OSError:
                events = list(self._placement_tail)
        else:
            events = list(self._placement_tail)
        return [e for e in events
                if e.get("trace_id") in keys or e.get("job") in keys]

    # ------------------------------------------------------------------
    # the capacity timeline (bounded ring + JSONL series)
    # ------------------------------------------------------------------

    def _capacity_loop(self, poll_s: float) -> None:
        while not self._stop.wait(poll_s):
            try:
                self.capacity_sample()
            except Exception as e:  # noqa: BLE001 - obs must not raise
                if not self._capacity_warned:
                    self._capacity_warned = True
                    warnings.warn(
                        f"fleet capacity sampler failed "
                        f"({type(e).__name__}: {e}); sampling "
                        "continues best-effort", RuntimeWarning)

    def capacity_sample(self, record: bool = True) -> dict:
        """One fleet capacity sample (the ``capacity_sample`` schema):
        per-pool queue/occupancy/watchdog health plus per-tenant slack
        — ``remaining_sweeps - est_sweeps_to_target``, the "will it
        finish inside its budget" signal a deadline scheduler or
        autoscaler consumes. ``record=True``
        appends to the bounded ring (+ JSONL series when ``obs_dir``
        is armed); ``record=False`` builds a throwaway sample (the
        ``/metrics`` scrape path)."""
        pools = []
        tenants = []
        for i, st in self._statuses():
            label = getattr(self.pools[i], "label", str(i))
            if not isinstance(st, dict):
                pools.append({"pool": label, "reachable": False,
                              "error": f"{type(st).__name__}: {st}"})
                continue
            wd = st.get("watchdog")
            wd = wd if isinstance(wd, dict) else {}
            beats = wd.get("heartbeat_age_s")
            beats = beats if isinstance(beats, dict) else {}
            ages = [v for v in beats.values()
                    if isinstance(v, (int, float))]
            faults = st.get("faults") or {}
            tripped = wd.get("state") == "tripped"
            pools.append({
                "pool": label,
                "reachable": True,
                "queue_depth": st.get("queue_depth") or 0,
                "staged": st.get("staged") or 0,
                "occupancy_now": st.get("occupancy_now") or 0.0,
                "busy_lanes": st.get("busy_lanes"),
                "nlanes": st.get("nlanes"),
                "free_groups": st.get("free_groups"),
                "watchdog_state": wd.get("state"),
                "heartbeat_age_max_s": (round(max(ages), 3)
                                        if ages else None),
                "healthy": (not faults.get("pool_failures")
                            and not tripped),
            })
            for t in st.get("tenants") or []:
                if not isinstance(t, dict):
                    continue
                rem = max((t.get("niter") or 0)
                          - (t.get("sweeps_done") or 0), 0)
                est = t.get("est_sweeps_to_target")
                est = (float(est)
                       if isinstance(est, (int, float))
                       and not isinstance(est, bool) else None)
                row = {"pool": label,
                       "tenant": t.get("tenant_id"),
                       "name": t.get("name"),
                       "trace_id": t.get("trace_id"),
                       "remaining_sweeps": rem,
                       "est_sweeps_to_target": est}
                if est is not None:
                    # positive slack: expected to converge inside the
                    # remaining budget (with margin); negative: the
                    # budget will run out first
                    row["slack_sweeps"] = round(rem - est, 3)
                tenants.append(row)
        sample = {
            "schema": 1,
            "kind": "capacity",
            "t": round(time.time(), 3),
            "pools": pools,
            "tenants": tenants,
            "router": {
                "placements": sum(self.placements.values()),
                "placement_events": self.placement_events,
                "failovers": self.failovers,
                "resubmitted": self.resubmitted,
                "migrations": self.migrations,
                "steals": self.steals,
                "dead_pools": len(self._dead),
            },
        }
        if record:
            self._capacity_ring.append(sample)
            self.capacity_samples += 1
            self._append_jsonl(self._capacity_path, sample)
        return sample

    def capacity_timeline(self) -> List[dict]:
        """Snapshot of the bounded sample ring, oldest first."""
        return list(self._capacity_ring)

    # ------------------------------------------------------------------
    # fleet postmortem + metrics + the stitched trace
    # ------------------------------------------------------------------

    def fleet_postmortem(self, reason: str = "endpoint") -> dict:
        """The fleet-level evidence bundle (the ``fleet_postmortem``
        schema): router counters, the capacity timeline ring, the
        placement-event tail, per-pool liveness. Dumped to
        ``obs_dir/fleet_postmortem.json`` on every pool failure and
        served live at ``GET /postmortem``."""
        pools = []
        for i, p in enumerate(self.pools):
            try:
                alive = bool(p.alive)
            except Exception:  # noqa: BLE001
                alive = False
            pools.append({"pool": getattr(p, "label", str(i)),
                          "alive": alive,
                          "dead": i in self._dead})
        return {
            "schema": 1,
            "kind": "fleet_postmortem",
            "t": round(time.time(), 3),
            "reason": reason,
            "router": {
                "placement": self.placement,
                "placements": dict(self.placements),
                "placement_events": self.placement_events,
                "failovers": self.failovers,
                "resubmitted": self.resubmitted,
                "migrations": self.migrations,
                "migration_failures": self.migration_failures,
                "steals": self.steals,
                "dead_pools": len(self._dead),
            },
            "pools": pools,
            "capacity_samples": list(self._capacity_ring),
            "placements_tail": list(self._placement_tail),
        }

    def _dump_fleet_postmortem(self, reason: str) -> None:
        """Atomic postmortem write (warn-and-continue)."""
        if self._postmortem_path is None:
            return
        try:
            doc = self.fleet_postmortem(reason=reason)
            tmp = self._postmortem_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(doc, fh)
            os.replace(tmp, self._postmortem_path)
        except Exception as e:  # noqa: BLE001 - obs must not raise
            warnings.warn(
                f"fleet postmortem dump failed "
                f"({type(e).__name__}: {e}); recovery continues",
                RuntimeWarning)

    def metrics_text(self) -> str:
        """``GET /metrics``: the fleet in the Prometheus exposition
        format (obs/export.py) — router counters plus per-pool
        capacity gauges with ``pool=`` instance labels, from the
        latest capacity sample (or a fresh unrecorded one when the
        sampler is off)."""
        from gibbs_student_t_tpu_torch.obs.export import prometheus_labeled

        sample = (self._capacity_ring[-1] if self._capacity_ring
                  else self.capacity_sample(record=False))
        with self._lock:
            placements = dict(self.placements)
            counters = {
                "fleet_failovers": self.failovers,
                "fleet_resubmitted": self.resubmitted,
                "fleet_migrations": self.migrations,
                "fleet_migration_failures": self.migration_failures,
                "fleet_steals": self.steals,
                "fleet_placement_events": self.placement_events,
                "fleet_capacity_samples": self.capacity_samples,
            }
            dead = len(self._dead)
        fam = {
            "fleet_placements": {
                "kind": "counter",
                "help": "Tenants placed, per pool",
                "samples": [({"pool": k}, v)
                            for k, v in sorted(placements.items())],
            },
            "fleet_dead_pools": {
                "kind": "gauge",
                "help": "Pools currently dead awaiting recovery",
                "samples": [({}, dead)],
            },
        }
        helps = {
            "fleet_failovers": "Dead-pool recoveries absorbed",
            "fleet_resubmitted": "Unspooled victims replayed",
            "fleet_migrations": "Live migrations landed",
            "fleet_migration_failures": "Migrations that fell back",
            "fleet_steals": "Rebalance queued-steals",
            "fleet_placement_events": "Placement decisions journaled",
            "fleet_capacity_samples": "Capacity timeline samples",
        }
        for name, v in counters.items():
            fam[name] = {"kind": "counter", "help": helps.get(name),
                         "samples": [({}, v)]}
        gauges = {
            "fleet_pool_queue_depth": ("queue_depth",
                                       "Admission queue depth"),
            "fleet_pool_staged": ("staged", "Staged tenants"),
            "fleet_pool_occupancy_now": ("occupancy_now",
                                         "Busy/pool lanes, now"),
            "fleet_pool_busy_lanes": ("busy_lanes", "Busy lanes"),
            "fleet_pool_healthy": ("healthy",
                                   "1 = reachable, no pool failure, "
                                   "watchdog untripped"),
            "fleet_pool_heartbeat_age_max_s": (
                "heartbeat_age_max_s",
                "Max executor heartbeat age"),
        }
        for name, (key, help_) in gauges.items():
            samples = []
            for p in sample.get("pools") or []:
                v = p.get(key)
                if key == "healthy":
                    v = 1 if (p.get("reachable") and v) else 0
                if v is None:
                    continue
                samples.append(({"pool": p.get("pool")}, v))
            if samples:
                fam[name] = {"kind": "gauge", "help": help_,
                             "samples": samples}
        return prometheus_labeled(
            fam, ts_ms=int(time.time() * 1e3))

    def _pool_clock(self, pool, samples: int = 5) -> dict:
        """The pool's clock offset estimate: NTP-style sampling over
        the RPC ``time`` op for wire pools; in-process pools share our
        clock (offset 0 by construction)."""
        from gibbs_student_t_tpu_torch.obs.aggregate import (
            estimate_clock_offset,
        )

        cli = getattr(pool, "rpc", None)
        if cli is None or not hasattr(cli, "server_time"):
            return {"offset_s": 0.0, "rtt_s": 0.0, "n": 0}
        obs = []
        for _ in range(max(int(samples), 1)):
            try:
                obs.append(cli.server_time())
            except Exception:  # noqa: BLE001 - degraded clock is data
                break
        return estimate_clock_offset(obs)

    def export_trace(self, path: Optional[str] = None) -> dict:
        """The stitched fleet trace (the ``fleet_trace`` schema):
        fetch each pool's Chrome trace (HTTP ``/trace`` for wire
        pools, the in-process doc for local ones), estimate each
        pool's clock offset NTP-style over the RPC ``time`` op, and
        merge pool swimlanes beside the router lane with offset-
        corrected timestamps (obs/aggregate.py
        ``stitch_fleet_trace``) — one correlated trace per job.
        Served at the fleet HTTP port as ``GET /trace``; ``path``
        additionally writes the doc atomically. Unreachable or
        trace-less pools degrade to a note in
        ``otherData.missing_pools``, never an error."""
        from gibbs_student_t_tpu_torch.obs.aggregate import (
            read_trace,
            stitch_fleet_trace,
        )

        if self.spans is not None:
            router_doc = self.spans.chrome_trace_doc()
        else:
            router_doc = {"traceEvents": [], "displayTimeUnit": "ms",
                          "otherData": {"dropped_spans": 0,
                                        "epoch_wall": time.time()}}
        pools = []
        missing = []
        for i, p in enumerate(self.pools):
            label = getattr(p, "label", str(i))
            doc = None
            err = None
            try:
                if getattr(p, "status_url", None):
                    doc = read_trace(p.status_url)
                elif hasattr(getattr(p, "rpc", None), "trace"):
                    # wire pool without an HTTP port: the RPC fallback
                    doc = p.rpc.trace()
                elif getattr(p, "server", None) is not None:
                    doc = p.server._trace_doc()
            except Exception as e:  # noqa: BLE001 - degraded, not fatal
                err = f"{type(e).__name__}: {e}"
            if not isinstance(doc, dict):
                missing.append({"pool": label,
                                "error": err or "no trace surface"})
                continue
            pools.append({"label": label, "doc": doc,
                          "clock": self._pool_clock(p)})
        doc = stitch_fleet_trace(router_doc, pools)
        if missing:
            doc["otherData"]["missing_pools"] = missing
        if path:
            try:
                tmp = path + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump(doc, fh)
                os.replace(tmp, path)
            except OSError as e:
                warnings.warn(
                    f"fleet trace export to {path!r} failed ({e}); "
                    "the doc is still returned", RuntimeWarning)
        return doc

    # ------------------------------------------------------------------
    # failover
    # ------------------------------------------------------------------

    def _watch_loop(self, poll_s: float) -> None:
        while not self._stop.wait(poll_s):
            for i, p in enumerate(list(self.pools)):
                if i in self._dead or p.proc is None:
                    continue   # local pools share our fate
                dead = not p.alive
                if not dead:
                    try:
                        p.healthz()
                        self._unreachable[i] = 0
                    except Exception:  # noqa: BLE001 - count strikes
                        n = self._unreachable.get(i, 0) + 1
                        self._unreachable[i] = n
                        dead = n >= DEAD_AFTER_POLLS
                if dead:
                    try:
                        self._failover(i)
                    except Exception as e:  # noqa: BLE001
                        warnings.warn(
                            f"fleet failover of pool "
                            f"{p.label!r} failed "
                            f"({type(e).__name__}: {e}); its tenants "
                            "stay pending until the next sweep",
                            RuntimeWarning)

    def _failover(self, idx: int) -> None:
        """Replace a dead subprocess pool: recovery respawn through
        its manifest (spooled tenants resume from their checkpoints,
        bitwise), rebind the victims' routed handles, and resubmit
        the unspooled victims from scratch to any healthy pool
        (request-replay determinism makes the re-run exact)."""
        t_fo0 = time.monotonic()
        with self._lock:
            if idx in self._dead:
                return
            self._dead.add(idx)
            routed = list(self._routed)
        old = self.pools[idx]
        # the capacity timeline's whole point: the evidence stream is
        # on disk BEFORE the recovery mutates fleet state
        self._dump_fleet_postmortem(
            reason=f"pool_failure:{old.label}")
        victims = [rh for rh in routed
                   if rh.pool_idx == idx and not self._finished(rh)]
        try:
            old.kill()   # make death unambiguous before recovering
        except Exception:  # noqa: BLE001
            pass
        new_pool = old.recover()
        rec = {str(k): v for k, v in
               (getattr(new_pool, "ready", {}).get("recovered")
                or {}).items()}
        with self._lock:
            self.pools[idx] = new_pool
            self._dead.discard(idx)
            self._unreachable[idx] = 0
            self._invalidate_status(idx)   # dead pool's snapshot
            self.failovers += 1
        for rh in victims:
            key = (rh.request.name if rh.request.name is not None
                   else rh.request.spool_dir)
            tid = rec.get(str(key))
            if tid is not None:
                rh._rebind(idx, new_pool.handle_for(tid, rh.request))
                continue
            # unspooled: replay the request on any healthy pool
            t_rs0 = time.monotonic()
            with self._lock:
                explain: dict = {}
                tgt = self._place(rh.request, explain=explain)
                inner = self.pools[tgt].submit(rh.request)
                label = self.pools[tgt].label
                self.placements[label] = \
                    self.placements.get(label, 0) + 1
                self.resubmitted += 1
                self._record_placement("resubmit", rh.request, tgt,
                                       explain)
            rh._rebind(tgt, inner)
            if self.spans is not None:
                self.spans.record(
                    "resubmit", ROLE_ROUTER, t_rs0,
                    time.monotonic() - t_rs0,
                    trace_id=getattr(rh.request, "trace_id", None),
                    job=rh.request.name, pool=label)
        if self.spans is not None:
            self.spans.record(
                "failover", ROLE_ROUTER, t_fo0,
                time.monotonic() - t_fo0, pool=old.label,
                victims=len(victims))

    # ------------------------------------------------------------------
    # live migration (spool checkpoint -> cancel -> resume elsewhere)
    # ------------------------------------------------------------------

    def migrate(self, rh: RoutedHandle, to_idx: int,
                timeout: float = 600.0) -> bool:
        """Move one tenant to pool ``to_idx`` live, through the
        primitive failover already proved bitwise: freeze at the next
        quantum boundary (``cancel``), read the spool checkpoint the
        finalize fenced, resume on the target from exactly that sweep
        (each chain draws from its own key at each sweep's counter,
        so the migrated tenant's full-run result is bitwise the
        unmigrated run's). A tenant still queued (nothing served)
        is replayed from scratch on the target instead —
        request-replay determinism makes that exact too. Callers
        blocked in ``result()`` ride through the rebind.

        Returns True when the tenant now lives on ``to_idx``; False
        when there was nothing to migrate (finished/unknown, same
        pool). On a resume-submit failure the tenant goes BACK to its
        source pool (it just vacated capacity there) — failure never
        strands a tenant (``migration_failures`` counts it)."""
        with self._lock:
            src = rh.pool_idx
            if (rh not in self._routed or src == to_idx
                    or src in self._dead or to_idx in self._dead
                    or rh._migrating.is_set() or self._finished(rh)):
                return False
            rh._migrating.set()
        t_mig0 = time.monotonic()
        ok = False
        try:
            ok = self._migrate_inner(rh, src, to_idx, timeout)
            return ok
        finally:
            rh._migrating.clear()
            if self.spans is not None:
                self.spans.record(
                    "migrate", ROLE_ROUTER, t_mig0,
                    time.monotonic() - t_mig0,
                    trace_id=getattr(rh.request, "trace_id", None),
                    job=rh.request.name, src=src, dst=to_idx,
                    landed=bool(ok))

    def _migrate_inner(self, rh: RoutedHandle, src: int, to_idx: int,
                       timeout: float) -> bool:
        from dataclasses import replace as _replace

        inner, req = rh._inner, rh.request
        if not self.pools[src].cancel(inner):
            return False   # already finished: nothing to move
        # checkpoint fencing: the source finalizes the frozen tenant
        # at the next boundary — spool closed, rolling checkpoint
        # consistent with the served prefix — and only THEN reports
        # done; the spool is not read before that
        deadline = time.monotonic() + timeout
        while not inner.done():
            if time.monotonic() > deadline:
                with self._lock:
                    self.migration_failures += 1
                raise TimeoutError(
                    f"migration source pool {src} did not release "
                    f"tenant within {timeout}s of cancel")
            time.sleep(0.02)
        resume_req = req
        if req.spool_dir is not None:
            try:
                from gibbs_student_t_tpu_torch.utils.spool import (
                    load_spool_state,
                )

                # only the checkpoint's sweep is needed here: the
                # target loads the state itself
                _state, next_sweep, _seed = load_spool_state(
                    req.spool_dir, device="cpu")
            except Exception:  # noqa: BLE001 - no checkpoint yet
                _state, next_sweep = None, req.start_sweep
            served = next_sweep - req.start_sweep
            if _state is not None and served > 0:
                if req.niter - served <= 0:
                    return False   # fully served: the prefix IS the run
                # wire-safe resume: the TARGET loads the checkpoint
                # from the spool at submit (a state pytree cannot
                # ride the RPC submit frame); start_sweep doubles as
                # the fencing cross-check against the checkpoint we
                # just sized the remaining budget from
                resume_req = _replace(
                    req, niter=req.niter - served, state=None,
                    start_sweep=next_sweep, resume_spool=True)
        # resume on the target; on failure fall back to the source
        # (its lanes just freed), then to a full from-scratch replay
        # (request-replay determinism makes it exact, just wasteful)
        # — a cancelled tenant must NEVER be left delivering its
        # served prefix as if it were the result
        attempts = [(to_idx, resume_req), (src, resume_req)]
        if resume_req is not req:
            attempts += [(to_idx, req), (src, req)]
        last_err = None
        inner2 = None
        for tgt, r in attempts:
            try:
                inner2 = self.pools[tgt].submit(r)
                break
            except Exception as e:  # noqa: BLE001
                last_err = e
                warnings.warn(
                    f"migration resume attempt on pool {tgt} failed "
                    f"({type(e).__name__}: {e}); trying the next "
                    "fallback", RuntimeWarning)
        if inner2 is None:
            with self._lock:
                self.migration_failures += 1
            err = RuntimeError(
                f"migration of tenant {getattr(inner, 'tenant_id', '?')} "
                f"failed on both target {to_idx} and source {src} — "
                "the tenant was cancelled and could not be resumed "
                "anywhere; its handle holds only the served prefix")
            err.__cause__ = last_err
            rh._migration_error = err   # callers must not get the
            raise err                   # prefix as if it completed
        with self._lock:
            label = self.pools[tgt].label
            self.placements[label] = self.placements.get(label, 0) + 1
            self._record_placement("migrate", rh.request, tgt,
                                   {"won": ("migrate" if tgt == to_idx
                                            else "migrate_fallback")})
            if tgt == to_idx:
                self.migrations += 1
            else:
                self.migration_failures += 1
            # both pools' load just changed out of band — a stale
            # "loaded"/"drained" snapshot must not steer placement or
            # the next rebalance pass (the respawn-staleness fix,
            # applied to migration too)
            self._invalidate_status(src)
            self._invalidate_status(tgt)
        rh._rebind(tgt, inner2)
        return tgt == to_idx

    def _rebalance_loop(self, poll_s: float) -> None:
        while not self._stop.wait(poll_s):
            try:
                self._rebalance_once()
            except Exception as e:  # noqa: BLE001 - policy is advisory
                warnings.warn(
                    f"fleet rebalance pass failed "
                    f"({type(e).__name__}: {e}); tenants stay put",
                    RuntimeWarning)

    def _rebalance_once(self) -> bool:
        """One policy pass: the most-drained pool (free lane groups,
        empty queue — it is dispatching its remaining residents either
        way, so stolen tenants ride lanes that were computing idle)
        steals the longest-backlog tenant from the most-loaded pool
        (queue pressure first, then the monitors' ``est_sweeps_to_target``
        backlog evidence). One migration per pass bounds churn; a
        queued victim is preferred (replay beats checkpoint
        round-trips), else the running spooled tenant with the most
        remaining sweeps."""
        with self._lock:
            sts = {i: st for i, st in self._statuses()
                   if isinstance(st, dict)
                   and not (st.get("faults") or {}).get("pool_failures")}
        if len(sts) < 2:
            return False
        # destination: free capacity, nothing waiting locally
        dests = [(-(st.get("free_groups") or 0), i)
                 for i, st in sts.items()
                 if (st.get("free_groups") or 0) > 0
                 and not (st.get("queue_depth") or 0)
                 and not (st.get("staged") or 0)]
        if not dests:
            return False
        dst = min(dests)[1]
        # source: heaviest load, excluding the destination
        srcs = [(((st.get("queue_depth") or 0) + (st.get("staged") or 0),
                  self._est_backlog(st)), i)
                for i, st in sts.items() if i != dst]
        srcs = [s for s in srcs if s[0] > (0, 0.0)]
        if not srcs:
            return False
        (src_load, src_backlog), src = max(srcs)
        if src_load == 0:
            # no queued/staged work on the source: a running steal
            # would just empty its slot (the lanes it vacates idle —
            # dispatch cost unchanged) while paying the checkpoint
            # round-trip; measured a straight loss, so the policy
            # only acts on real queue pressure
            return False
        victim = self._pick_victim(
            src, sts[src], sts[dst],
            allow_running=self.rebalance_running and src_load > 1)
        if victim is None:
            return False
        t_steal0 = time.monotonic()
        stole = self.migrate(victim, dst)
        if stole:
            with self._lock:
                self.steals += 1
        if self.spans is not None:
            self.spans.record(
                "steal", ROLE_ROUTER, t_steal0,
                time.monotonic() - t_steal0,
                trace_id=getattr(victim.request, "trace_id", None),
                job=victim.request.name, src=src, dst=dst,
                landed=bool(stole))
        return stole

    def _pick_victim(self, src: int, src_st: dict, dst_st: dict,
                     allow_running: bool = True
                     ) -> Optional[RoutedHandle]:
        """The tenant to steal from ``src``: a queued one first (its
        whole budget moves for the price of a replay), else the
        running spooled tenant with the largest remaining backlog
        (capped by the monitor's ``est_sweeps_to_target``) that
        fits the destination's free groups. Streamed (``on_chunk``)
        tenants stay put — their dedicated result connection pins
        them to the pool that owns it."""
        group = dst_st.get("group") or 1
        free_lanes = (dst_st.get("free_groups") or 0) * group
        with self._lock:
            cands = [rh for rh in self._routed
                     if rh.pool_idx == src
                     and not rh._migrating.is_set()
                     and rh.request.on_chunk is None
                     and rh.request.nchains <= free_lanes
                     and not self._finished(rh)]
        by_tid = {t.get("tenant_id"): t
                  for t in src_st.get("tenants") or []
                  if isinstance(t, dict)}
        queued, running = [], []
        for rh in cands:
            t = by_tid.get(getattr(rh._inner, "tenant_id", None))
            if t is None:
                # not resident on the source: queued (or just staged)
                queued.append(rh)
                continue
            if rh.request.spool_dir is None or t.get("cancelled") \
                    or t.get("failed"):
                continue
            rem = max((t.get("niter") or 0)
                      - (t.get("sweeps_done") or 0), 0)
            est = t.get("est_sweeps_to_target")
            if isinstance(est, (int, float)) \
                    and not isinstance(est, bool):
                rem = min(rem, max(float(est), 0.0))
            if rem * (t.get("nchains") or 1) \
                    >= self.rebalance_min_sweeps:
                running.append((rem, rh))
        if queued:
            return queued[0]
        if running and allow_running:
            # a running steal frees a slot the source can immediately
            # backfill from its (deep) queue; with at most one queued
            # job left the replay of THAT job is always the better
            # move, so running steals need allow_running
            return max(running, key=lambda x: x[0])[1]
        return None

    @staticmethod
    def _finished(rh: RoutedHandle) -> bool:
        """Best-effort 'already resolved' check that must not touch
        the dead pool's wire. A streamed RemoteTenantHandle on a
        crashed pool has ``_done`` SET — its stream reader resolved it
        to a ConnectionError before the watch thread noticed the death
        — so a severed-stream resolution counts as UNFINISHED: that
        handle is a failover victim to rebind/resubmit, not a served
        tenant."""
        inner = rh._inner
        ev = getattr(inner, "_done", None)
        if ev is not None and hasattr(ev, "is_set"):
            if not ev.is_set():
                return False
            return not isinstance(getattr(inner, "_error", None),
                                  ConnectionError)
        return False


# ---------------------------------------------------------------------------
# convenience constructors
# ---------------------------------------------------------------------------

def spawn_fleet(base_dir: str, n_pools: int, template_ma, config,
                pool_kwargs: Optional[dict] = None,
                faults_for: Optional[Dict[int, list]] = None,
                ready_timeout: float = 600.0,
                **router_kwargs) -> FleetRouter:
    """Spawn ``n_pools`` subprocess pools under ``base_dir/poolK`` and
    wrap them in a router. ``faults_for`` arms serve/faults FaultSpec
    dicts in selected workers (the chaos tier: ``{1: [{"point":
    "pool_kill", "after": 3, "action": "kill"}]}``). Workers spawn
    CONCURRENTLY (each pays its own torch import, CUDA context and
    server construction; on a many-core host they overlap)."""
    specs = [PoolSpec(os.path.join(base_dir, f"pool{i}"), template_ma,
                      config, pool_kwargs)
             for i in range(n_pools)]
    pools: List[Optional[ProcPool]] = [None] * n_pools
    errors: List = []

    def boot(i):
        try:
            pools[i] = ProcPool.spawn(
                specs[i], faults=(faults_for or {}).get(i),
                ready_timeout=ready_timeout)
        except Exception as e:  # noqa: BLE001
            errors.append((i, e))

    threads = [threading.Thread(target=boot, args=(i,), daemon=True)
               for i in range(n_pools)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for p in pools:
            if p is not None:
                p.kill()
        i, e = errors[0]
        raise RuntimeError(f"pool {i} failed to spawn") from e
    return FleetRouter(pools, **router_kwargs)


def teardown_fleet(router: FleetRouter, remove_dirs: bool = False,
                   grace: float = 30.0) -> None:
    """Close the router and (optionally) delete the pool dirs."""
    router.close(grace=grace)
    if remove_dirs:
        for p in router.pools:
            spec = getattr(p, "spec", None)
            if spec is not None:
                shutil.rmtree(spec.pool_dir, ignore_errors=True)
