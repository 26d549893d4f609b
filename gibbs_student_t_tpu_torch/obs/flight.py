"""The crash flight recorder: a bounded black box for the chain server.

Counterpart of ``gibbs_student_t_tpu/obs/flight.py``. Crash recovery
(serve/manifest.py) replays *state*, the manifest and the spool
checkpoints, but keeps no *evidence*: when a pool dies, a tenant fails or
the watchdog sees a stall, nothing says what the last quanta looked like.
:class:`FlightRecorder` is that black box: a bounded ring (one entry a
quantum), a bounded event log and the latest heartbeat of each executor
role. Feeding it costs a deque append on the serving path; it is dumped
atomically as a postmortem bundle (the schema's ``postmortem``) when
something goes wrong (a pool failure, a contained ``TenantError``, a
watchdog trip, SIGTERM or interpreter exit) or on demand through
``ChainServer.dump_postmortem()``.

Crash durability: ``os._exit`` skips every ``atexit`` and ``finally``, so
on-demand dumps alone would leave nothing behind. With ``sync_path`` set,
the recorder also rewrites a bundle without spans (``flight.json``) every
``sync_every`` quanta, small and atomic, so a hard kill always leaves a
parseable last-known-state bundle at most ``sync_every`` quanta stale
(tests/test_torch_faults.py kills a server process and reads it).

Recording and dumping never raise into the serving path (IO failures
warn once and serving continues), and the ring is host bookkeeping only,
so chains are bitwise identical with the recorder on or off.
``tools/postmortem.py`` renders a bundle.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

#: Bundle schema version (the schema's ``postmortem``).
BUNDLE_SCHEMA = 1


class FlightRecorder:
    """Bounded ring of per-quantum entries, events and heartbeats.

    ``capacity`` bounds the quantum ring and ``events_capacity`` the
    event log (drop-oldest deques). ``context_fn``, when set, is called
    at bundle time and its dict merged into the bundle (the server's
    lock-free views); ``spans_fn`` supplies the span ring's tail for
    on-demand dumps (the periodic syncs carry no spans: they are the
    bulky part, and the sync rides the quantum boundary). Both callbacks
    are guarded: a raising provider becomes an ``error`` marker inside
    the bundle, never an exception out of the recorder."""

    def __init__(self, capacity: int = 64, events_capacity: int = 256,
                 sync_path: Optional[str] = None, sync_every: int = 4,
                 span_tail: int = 500,
                 context_fn: Optional[Callable[[], dict]] = None,
                 spans_fn: Optional[Callable[[], List[dict]]] = None):
        if capacity < 1 or events_capacity < 1 or sync_every < 1:
            raise ValueError(
                "capacity, events_capacity and sync_every must be >= 1")
        self.capacity = int(capacity)
        self._quanta = collections.deque(maxlen=self.capacity)
        self._events = collections.deque(maxlen=int(events_capacity))
        self._beats: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._n_quanta = 0
        self._n_events = 0
        self._dumps = 0
        self._sync_path = sync_path
        self._sync_every = int(sync_every)
        self._span_tail = int(span_tail)
        self._context_fn = context_fn
        self._spans_fn = spans_fn
        self._warned = False

    # -- feeding --------------------------------------------------------

    def note_quantum(self, entry: dict) -> None:
        """Append one quantum's row (the server builds it: dispatch wall,
        occupancy, queue depth, fault counters) and, every
        ``sync_every`` quanta, rewrite the sync bundle. Never raises."""
        try:
            with self._lock:
                self._quanta.append(entry)
                self._n_quanta += 1
                due = (self._sync_path is not None
                       and self._n_quanta % self._sync_every == 0)
            if due:
                # atomic replace, no fsync: an fsync would put disk
                # latency on the serving path every few quanta, and a
                # torn sync leaves the previous complete bundle in place
                self.dump(self._sync_path, reason="sync",
                          include_spans=False, fsync=False)
        except Exception:  # noqa: BLE001 - never into the serving path
            pass

    def note_event(self, kind: str, **fields) -> None:
        """Append one lifecycle event (admit, evict, fault, alert, ...).
        Never raises."""
        try:
            rec = {"kind": kind,
                   "t": round(time.monotonic() - self._t0, 6)}
            rec.update(fields)
            with self._lock:
                self._events.append(rec)
                self._n_events += 1
        except Exception:  # noqa: BLE001
            pass

    def beat(self, role: str) -> None:
        """Record a heartbeat of an executor role (monotonic). The bundle
        reports ages, so a stalled thread shows as a stale beat even with
        the watchdog off."""
        try:
            self._beats[role] = time.monotonic()
        except Exception:  # noqa: BLE001
            pass

    # -- bundling -------------------------------------------------------

    def bundle(self, reason: str, include_spans: bool = True,
               extra: Optional[dict] = None) -> dict:
        """The postmortem document: ring, events, heartbeat ages and the
        server's context. Always succeeds: a broken provider lands as an
        ``error`` marker in its block."""
        now = time.monotonic()
        with self._lock:
            quanta = list(self._quanta)
            events = list(self._events)
            beats = dict(self._beats)
            n_q, n_e = self._n_quanta, self._n_events
        doc = {
            "schema": BUNDLE_SCHEMA,
            "t": round(time.time(), 3),
            "reason": reason,
            "ring_capacity": self.capacity,
            "quanta_recorded": n_q,
            "quanta_dropped": max(n_q - len(quanta), 0),
            "events_recorded": n_e,
            "events_dropped": max(n_e - len(events), 0),
            "heartbeat_age_s": {
                role: round(now - t, 3) for role, t in beats.items()},
            "quanta": quanta,
            "events": events,
        }
        if self._context_fn is not None:
            try:
                ctx = self._context_fn()
                if isinstance(ctx, dict):
                    doc.update(ctx)
            except Exception as e:  # noqa: BLE001
                doc["context_error"] = f"{type(e).__name__}: {e}"
        if include_spans and self._spans_fn is not None:
            try:
                spans = self._spans_fn() or []
                doc["spans"] = spans[-self._span_tail:]
            except Exception as e:  # noqa: BLE001
                doc["spans_error"] = f"{type(e).__name__}: {e}"
        if extra:
            doc.update(extra)
        return doc

    def dump(self, path: str, reason: str, include_spans: bool = True,
             extra: Optional[dict] = None,
             fsync: bool = True) -> Optional[str]:
        """Write the bundle atomically (a temporary file, then a replace:
        a reader, or a crash mid-write, never sees a torn bundle).
        Returns the path, or None on an IO failure (warned once a
        recorder)."""
        try:
            doc = self.bundle(reason, include_spans=include_spans,
                              extra=extra)
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(_jsonable(doc), fh)
                if fsync:
                    fh.flush()
                    os.fsync(fh.fileno())
            os.replace(tmp, path)
            with self._lock:
                self._dumps += 1
            return path
        except Exception as e:  # noqa: BLE001 - the box must not crash
            if not self._warned:
                self._warned = True
                warnings.warn(
                    f"flight-recorder dump to {path!r} failed "
                    f"({type(e).__name__}: {e}); serving continues "
                    "without the bundle", RuntimeWarning)
            return None


def _jsonable(v):
    """A JSON-safe copy (numpy scalars and arrays to Python values)."""
    import numpy as np

    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def read_bundle(path: str) -> dict:
    """Load a bundle and check its schema version."""
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(
            f"{path}: not a postmortem bundle (schema "
            f"{doc.get('schema')!r} != {BUNDLE_SCHEMA})")
    return doc
