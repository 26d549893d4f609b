"""The serving stall watchdog: liveness the executor cannot report itself.

Counterpart of ``gibbs_student_t_tpu/obs/watchdog.py``. A stalled
dispatch thread (a hung device call, a deadlocked boundary) is invisible
to every other surface: ``status()`` blocks on the server lock, the span
ring just stops growing, and nothing *failed*. The :class:`Watchdog` runs
an independent daemon ticker that reads executor heartbeats and
per-quantum walls and trips on three degradations:

- **dispatch stall**: the dispatch heartbeat's age exceeds a quantum
  deadline (``deadline_factor`` x the rolling median of the quantum
  walls, at least ``min_deadline_s``) while tenants are running;
- **drain backlog growth**: the drain queue's unfinished bundles grow
  monotonically across ``backlog_quanta`` quanta by at least
  ``backlog_min`` (the drain thread fell behind and is not catching up);
- **throughput collapse**: the rolling median of per-quantum
  chain-sweeps/s over the last ``collapse_window`` quanta drops more than
  ``collapse_drop`` below the median of the window before it (point
  noise cannot trip it).

A trip latches (one alert, one dump, not one a tick) and the owner
applies its policy (``GST_SERVE_WATCHDOG``): ``warn`` (an alert event and
a degraded ``healthz``), ``dump`` (also the flight recorder's postmortem
bundle), ``fail`` (also a latched pool error that the driver raises at
its next boundary: a device call in flight cannot be killed safely). In
every policy ``healthz()`` reports the cause, which is why ``healthz`` is
lock-free: it answers *during* the stall it reports.

The watchdog never raises into the serving path and never touches
chains: feeding it is host bookkeeping, and the ticker only reads. The
thresholds are conservative; a healthy pool under load must never trip
(tests/test_torch_serve_obs.py holds a clean stream with +-50 % noisy
walls, and an injected stall).
"""

from __future__ import annotations

import collections
import statistics
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

from gibbs_student_t_tpu_torch.utils.env import env_choice

#: Trip causes (the ``healthz.watchdog.trip.cause`` enum).
CAUSES = ("dispatch_stall", "drain_backlog", "throughput_collapse")

#: Trip policies. ``GST_SERVE_WATCHDOG`` takes these, ``auto`` (which
#: resolves to ``dump``: a trip should leave evidence) and ``0`` (off).
POLICIES = ("warn", "dump", "fail")

_ENV_VALUES = ("auto", "0") + POLICIES


def serve_watchdog_env() -> str:
    """The validated ``GST_SERVE_WATCHDOG`` (``auto`` when unset):
    strictly ``auto|0|warn|dump|fail``, and any other value raises a
    ``ValueError`` naming it."""
    return env_choice("GST_SERVE_WATCHDOG", _ENV_VALUES)


@dataclass
class WatchdogSpec:
    """Detector thresholds. The defaults suit real serving quanta (tens
    of ms to seconds); fault-injection runs shrink them to trip fast."""

    #: dispatch deadline = max(min_deadline_s, factor * median wall)
    deadline_factor: float = 8.0
    min_deadline_s: float = 5.0
    #: ticker cadence, seconds
    tick_s: float = 0.25
    #: rolling window of quantum walls the deadline's median is over
    wall_window: int = 16
    #: the backlog must grow monotonically across this many quanta ...
    backlog_quanta: int = 8
    #: ... by at least this many bundles
    backlog_min: int = 4
    #: the throughput medians compare two adjacent windows of this size
    collapse_window: int = 8
    #: trip when the recent median < (1 - collapse_drop) * the previous
    collapse_drop: float = 0.6

    def __post_init__(self):
        if self.deadline_factor <= 0 or self.min_deadline_s <= 0 \
                or self.tick_s <= 0:
            raise ValueError("deadline_factor, min_deadline_s and "
                             "tick_s must be positive")
        if self.backlog_quanta < 2 or self.collapse_window < 2:
            raise ValueError("backlog_quanta and collapse_window must "
                             "be >= 2")
        if not 0.0 < self.collapse_drop < 1.0:
            raise ValueError("collapse_drop must be in (0, 1)")


class Watchdog:
    """Heartbeat and quantum-deadline stall detector.

    ``active_fn`` says whether the pool has running work (a quiet pool
    owes no heartbeats); ``on_trip(trip_dict)`` fires exactly once, from
    the detecting thread (usually the ticker). Both callbacks are
    guarded: a raising provider costs only that one evaluation."""

    def __init__(self, policy: str = "dump",
                 spec: Optional[WatchdogSpec] = None,
                 active_fn: Optional[Callable[[], bool]] = None,
                 on_trip: Optional[Callable[[dict], None]] = None):
        if policy not in POLICIES:
            raise ValueError(
                f"watchdog policy must be one of {POLICIES}, got "
                f"{policy!r}")
        self.policy = policy
        self.spec = spec or WatchdogSpec()
        self._active_fn = active_fn
        self._on_trip = on_trip
        self._lock = threading.Lock()
        self._beats = {}
        self._walls = collections.deque(maxlen=self.spec.wall_window)
        self._backlog = collections.deque(
            maxlen=self.spec.backlog_quanta)
        self._tput = collections.deque(
            maxlen=2 * self.spec.collapse_window)
        self._quanta = 0
        self.trip: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- feeding (serving threads; never raises) ------------------------

    def beat(self, role: str) -> None:
        try:
            self._beats[role] = time.monotonic()
        except Exception:  # noqa: BLE001
            pass

    def note_quantum(self, wall_ms: float,
                     sweeps_per_s: Optional[float] = None,
                     backlog: Optional[int] = None) -> None:
        """One quantum's evidence: the dispatch wall (the deadline's
        median), the chain-sweeps/s (the collapse detector) and the drain
        backlog."""
        try:
            with self._lock:
                self._quanta += 1
                self._walls.append(float(wall_ms))
                if sweeps_per_s is not None:
                    self._tput.append(float(sweeps_per_s))
                if backlog is not None:
                    self._backlog.append(int(backlog))
        except Exception:  # noqa: BLE001
            pass

    # -- the ticker -----------------------------------------------------

    def start(self) -> None:
        """Start the daemon ticker (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._tick_loop, name="serve-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        th = self._thread
        if th is not None and th.is_alive():
            th.join(timeout=2.0)
        self._thread = None

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.spec.tick_s):
            try:
                self.check()
            except Exception:  # noqa: BLE001 - the ticker never dies
                pass

    # -- detection ------------------------------------------------------

    def deadline_s(self) -> float:
        """The current dispatch deadline (from the rolling median)."""
        with self._lock:
            walls = list(self._walls)
        med = statistics.median(walls) / 1e3 if walls else 0.0
        return max(self.spec.min_deadline_s,
                   self.spec.deadline_factor * med)

    def check(self, now: Optional[float] = None) -> Optional[dict]:
        """One evaluation of the detectors; returns (and latches) the
        trip dict, or None. Safe from any thread."""
        if self.trip is not None:
            return self.trip
        now = time.monotonic() if now is None else now
        trip = None
        # 1) dispatch stall: the beat's age against the deadline. Armed
        # only once a quantum wall is recorded: a process's first quantum
        # builds or loads the kernels, which may exceed the deadline's
        # floor before any median exists to size it, and that is no stall
        try:
            active = bool(self._active_fn()) if self._active_fn else False
        except Exception:  # noqa: BLE001
            active = False
        with self._lock:
            have_walls = len(self._walls) > 0
        beat = self._beats.get("dispatch")
        if active and have_walls and beat is not None:
            age = now - beat
            deadline = self.deadline_s()
            if age > deadline:
                trip = {"cause": "dispatch_stall",
                        "detail": (f"dispatch heartbeat {age:.2f}s old "
                                   f"(deadline {deadline:.2f}s)"),
                        "age_s": round(age, 3),
                        "deadline_s": round(deadline, 3)}
        # 2) drain backlog growth: monotone across the window
        if trip is None:
            with self._lock:
                bl = list(self._backlog)
            if (len(bl) == self.spec.backlog_quanta
                    and all(b1 >= b0 for b0, b1 in zip(bl, bl[1:]))
                    and bl[-1] - bl[0] >= self.spec.backlog_min):
                trip = {"cause": "drain_backlog",
                        "detail": (f"drain backlog grew {bl[0]} -> "
                                   f"{bl[-1]} over "
                                   f"{len(bl)} quanta"),
                        "backlog": bl[-1]}
        # 3) throughput collapse: adjacent rolling-median windows
        if trip is None:
            W = self.spec.collapse_window
            with self._lock:
                tp = list(self._tput)
            if len(tp) == 2 * W:
                prev = statistics.median(tp[:W])
                recent = statistics.median(tp[W:])
                if prev > 0 and recent < (1.0 - self.spec.collapse_drop) \
                        * prev:
                    trip = {"cause": "throughput_collapse",
                            "detail": (f"median throughput "
                                       f"{prev:.1f} -> {recent:.1f} "
                                       f"chain-sweeps/s "
                                       f"(> {self.spec.collapse_drop:.0%}"
                                       " drop)"),
                            "before": round(prev, 1),
                            "after": round(recent, 1)}
        if trip is None:
            return None
        with self._lock:
            if self.trip is not None:    # another thread latched first
                return self.trip
            trip["t"] = round(time.time(), 3)
            self.trip = trip
        if self._on_trip is not None:
            try:
                self._on_trip(trip)
            except Exception as e:  # noqa: BLE001
                warnings.warn(
                    f"watchdog on_trip handler failed "
                    f"({type(e).__name__}: {e}); the trip is still "
                    "latched", RuntimeWarning)
        return trip

    # -- reporting ------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``healthz()``/``status()`` watchdog block (lock-light:
        readable during the very stall it reports)."""
        now = time.monotonic()
        beats = dict(self._beats)
        return {
            "enabled": True,
            "policy": self.policy,
            "state": "tripped" if self.trip is not None else "ok",
            "trip": self.trip,
            "heartbeat_age_s": {
                role: round(now - t, 3) for role, t in beats.items()},
            "deadline_s": round(self.deadline_s(), 3),
            "quanta_seen": self._quanta,
        }
