"""Deterministic fault injection for the serving stack.

Counterpart of ``gibbs_student_t_tpu/serve/faults.py`` (standard library
and numpy only), with its own process-local state: arming this module
arms the port's serving stack only, and a harness that drives both
packages arms each module.

The fault-containment contract of the port's :class:`ChainServer`
(serve/server.py) is only worth anything if it can be proven: every
containment path (a tenant's drain failure, a worker's death and the
supervisor's restart, a lane's divergence under each ``on_divergence``
policy, a crash on either side of a spool checkpoint) needs a fault that
fires at an exact, reproducible point. This module is that trigger: named
injection points in the serving code paths (``fire(point, tenant=...)``
calls that do nothing until a spec arms them), driven by declarative
:class:`FaultSpec` entries.

Determinism, not randomness: a spec fires on the ``after``-th traversal
of its (point, tenant) site, counted per scope, and every serving
traversal order is deterministic (staging follows submit order, drain
bundles follow quantum order with tenants in admission order, boundary
points run on the dispatch thread). A seeded plan (:func:`seeded_plan`)
derives the targets and offsets from one integer seed the same way every
run.

Injection points:

==========================  =============================================
point                       site (fires just before the real work)
==========================  =============================================
``staging``                 ``ChainServer._prepare``: the tenant's
                            validation and build
``callback``                ``TenantHandle._stream``: the ``on_chunk``
                            call
``spool_io``                ``ChainSpool.append``: the quantum's record
                            write
``drain_death``             the drain worker's per-tenant loop
                            (``action="die"`` kills the worker thread,
                            not just the tenant)
``lane_nan``                quantum boundary, dispatch thread: poisons
                            the tenant's first chain lane to NaN
``dispatch_stall``          quantum boundary, dispatch thread, just
                            before the dispatch (``action="sleep"``
                            stalls it)
``kill_before_checkpoint``  ``ChainSpool.append``, after the rows and
                            before the state checkpoint
                            (``action="kill"``: ``os._exit(9)``)
``kill_after_checkpoint``   the same, after the checkpoint
``rpc_sever``               serve/rpc.py: each request on a connection,
                            and each chunk a stream pushes (a firing
                            closes the connection, no error frame)
``pool_kill``               serve/pool_main.py: each completed quantum
                            of the worker (``action="kill"``: the dead
                            pool)
==========================  =============================================

Actions: ``raise`` (the named exception type, the default), ``die``
(:class:`WorkerDeath`, a BaseException the worker loops do not latch, so
the thread really dies), ``kill`` (``os._exit(9)``, a process kill no
``finally`` can soften: the crash-recovery arm), ``sleep`` (block the
firing thread for ``seconds``: a stall, not a failure; results are bitwise
those of the uninjected run).

Everything is process-local and off by default; ``install``/``clear`` (or
the ``inject`` context manager) arm and disarm. Counters of fired faults
survive ``clear`` until ``reset_counts``, so harnesses can assert exactly
which injections happened.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "FaultSpec",
    "WorkerDeath",
    "install",
    "clear",
    "inject",
    "fire",
    "fired_counts",
    "reset_counts",
    "seeded_plan",
    "POINTS",
]

#: Every point name the serving stack calls ``fire`` with; specs naming
#: anything else are rejected loudly (a typo'd point would otherwise
#: arm a fault that never fires and the chaos test would pass vacuously).
POINTS = (
    "staging",
    "callback",
    "spool_io",
    "drain_death",
    "lane_nan",
    "dispatch_stall",
    "kill_before_checkpoint",
    "kill_after_checkpoint",
    "rpc_sever",
    "pool_kill",
)

_ACTIONS = ("raise", "die", "kill", "sleep")

_EXCS = {
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "OSError": OSError,
    "IOError": OSError,
}


class WorkerDeath(BaseException):
    """Kills a serve worker thread outright. Deliberately NOT an
    ``Exception``: the worker loops latch/contain ``Exception`` but let
    BaseException propagate (the KeyboardInterrupt/SystemExit
    discipline), so this models a thread dying mid-bundle — the case
    the supervisor's restart path exists for."""


@dataclass
class FaultSpec:
    """One armed fault.

    ``point``   — a name from :data:`POINTS`.
    ``tenant``  — scope to one tenant (matched against the tenant name
                  when the request has one, else the tenant id); None
                  fires for any tenant.
    ``after``   — skip this many matching traversals first (0 = fire on
                  the first one). Counted per (point, tenant-scope).
    ``times``   — how many firings before the spec disarms itself.
    ``action``  — ``raise`` | ``die`` | ``kill`` | ``sleep``.
    ``exc``     — exception type name for ``action="raise"``.
    ``message`` — the raised exception's message (a recognizable token
                  chaos tests can assert on end to end).
    ``seconds`` — stall duration for ``action="sleep"``.
    """

    point: str
    tenant: Optional[object] = None
    after: int = 0
    times: int = 1
    action: str = "raise"
    exc: str = "RuntimeError"
    message: str = "injected fault"
    seconds: float = 1.0
    _seen: int = field(default=0, repr=False)
    _fired: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; known points: "
                f"{', '.join(POINTS)}")
        if self.action not in _ACTIONS:
            raise ValueError(
                f"fault action must be one of {_ACTIONS}, got "
                f"{self.action!r}")
        if self.action == "raise" and self.exc not in _EXCS:
            raise ValueError(
                f"fault exc must be one of {sorted(_EXCS)}, got "
                f"{self.exc!r}")
        if self.after < 0 or self.times < 1:
            raise ValueError("after must be >= 0 and times >= 1")
        if self.action == "sleep" and self.seconds <= 0:
            raise ValueError("sleep seconds must be positive")


_lock = threading.Lock()
_specs: List[FaultSpec] = []
_counts: Dict[Tuple[str, Optional[object]], int] = {}


def install(*specs: FaultSpec) -> None:
    """Arm fault specs (additive)."""
    with _lock:
        _specs.extend(specs)


def clear() -> None:
    """Disarm every spec (fired counters survive until
    :func:`reset_counts`)."""
    with _lock:
        _specs.clear()


def reset_counts() -> None:
    with _lock:
        _counts.clear()


def fired_counts() -> Dict[Tuple[str, Optional[object]], int]:
    """{(point, tenant-scope): fired} for every firing since the last
    :func:`reset_counts` — the harness's assertion surface."""
    with _lock:
        return dict(_counts)


@contextmanager
def inject(*specs: FaultSpec):
    """Context-managed ``install`` + ``clear`` (counters reset on
    entry so the body observes only its own firings)."""
    reset_counts()
    install(*specs)
    try:
        yield
    finally:
        clear()


def _matches(spec: FaultSpec, point: str, tenant) -> bool:
    if spec.point != point:
        return False
    return spec.tenant is None or spec.tenant == tenant


def fire(point: str, tenant=None) -> None:
    """The injection site hook: a no-op until a matching armed spec's
    ``after`` traversals have elapsed, then performs its action.
    Call sites pass the tenant NAME when the request has one (else the
    tenant id) so specs can scope deterministically."""
    with _lock:
        if not _specs:
            return
        hit = None
        for spec in _specs:
            if not _matches(spec, point, tenant):
                continue
            spec._seen += 1
            if spec._seen > spec.after and spec._fired < spec.times:
                spec._fired += 1
                key = (point, spec.tenant)
                _counts[key] = _counts.get(key, 0) + 1
                hit = spec
            break  # first matching spec owns this traversal
        if hit is None:
            return
        action, exc, msg = hit.action, hit.exc, hit.message
        secs = hit.seconds
    # act outside the lock: a raise must not hold it, and _exit never
    # returns
    if action == "kill":
        os._exit(9)
    if action == "sleep":
        import time

        time.sleep(secs)
        return
    if action == "die":
        raise WorkerDeath(f"{msg} [{point}]")
    raise _EXCS[exc](f"{msg} [{point}]")


def seeded_plan(seed: int, tenants: List[object],
                points: Tuple[str, ...] = ("callback", "lane_nan"),
                after_range: Tuple[int, int] = (1, 3)) -> List[FaultSpec]:
    """A deterministic fault plan from one integer seed: round-robins
    ``points`` over targets drawn (without replacement) from
    ``tenants`` with seeded ``after`` offsets (the JAX package's
    draw, so both packages pick the same victims). Same seed + tenant
    list = same plan, independent of host or scheduling."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = min(len(points), len(tenants))
    targets = rng.choice(len(tenants), size=k, replace=False)
    lo, hi = after_range
    return [
        FaultSpec(point=points[i], tenant=tenants[int(t)],
                  after=int(rng.integers(lo, hi + 1)))
        for i, t in enumerate(targets)
    ]
