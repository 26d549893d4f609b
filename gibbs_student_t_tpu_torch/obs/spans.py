"""Per-tenant host span tracing for the serving executor.

Counterpart of ``gibbs_student_t_tpu/obs/spans.py``. The pipelined
``ChainServer`` runs three cooperating threads (staging, dispatch and
drain) whose ordering is otherwise visible only through bitwise pins. A
:class:`SpanRecorder` makes it visible: every staging, admission,
dispatch, drain and finalize step emits one structured span (tenant id,
quantum index, thread role, monotonic start and duration) into a bounded
in-memory ring, and optionally a JSONL sink, and
:meth:`ChainServer.export_trace` renders the ring as Chrome trace-event
JSON, so a mixed-workload run opens in Perfetto or ``chrome://tracing``
as a per-tenant swimlane timeline (one "process" per tenant, one track
per thread role).

Contract: recording never raises into the serving path (a failing JSONL
sink is disabled with one warning and the run continues), and spans are
pure host bookkeeping, so chains are bitwise identical with tracing on
or off (tests/test_torch_serve_obs.py).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

#: Thread roles of the serving executor. The serial driver performs every
#: role on the calling thread; spans keep the ROLE (which executor step
#: ran), so swimlanes read the same either way.
ROLE_STAGING = "staging"
ROLE_DISPATCH = "dispatch"
ROLE_DRAIN = "drain"


class _SpanCtx:
    """Context manager measuring one span; records on exit."""

    __slots__ = ("_rec", "_name", "_role", "_tenant", "_quantum",
                 "_args", "_t0")

    def __init__(self, rec, name, role, tenant, quantum, args):
        self._rec = rec
        self._name = name
        self._role = role
        self._tenant = tenant
        self._quantum = quantum
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._rec.record(self._name, self._role, self._t0,
                         time.monotonic() - self._t0,
                         tenant=self._tenant, quantum=self._quantum,
                         **self._args)
        return False  # never swallow the traced code's exception


class SpanRecorder:
    """Bounded ring of host spans plus an optional JSONL sink.

    ``capacity`` bounds the in-memory ring (a deque: old spans fall off,
    so a long-lived server cannot grow without bound). Drops are counted,
    never silent: :attr:`dropped` counts overflow evictions, the first
    drop warns once, every drop increments a ``serve_spans_dropped``
    counter on the attached ``metrics`` registry (when one was passed),
    and the export carries the total in its ``otherData.dropped_spans``.
    ``jsonl_path``, when given, also appends one JSON line per span as it
    closes (line-buffered, so a crash keeps every closed span). A sink IO
    error disables the sink with a single ``RuntimeWarning`` and keeps
    recording in memory: observability never fails the run.
    """

    def __init__(self, capacity: int = 65536,
                 jsonl_path: Optional[str] = None, metrics=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.epoch = time.monotonic()   # export time base (t=0)
        #: wall-clock anchor of the epoch, sampled back to back with the
        #: monotonic one: ``epoch_wall + t0`` places a span on this host's
        #: wall clock
        self.epoch_wall = time.time()
        #: tenant id -> trace id: spans recorded with a mapped ``tenant=``
        #: carry it. A plain dict (reads are GIL-atomic; a missing entry
        #: leaves spans untagged)
        self.trace_ids: Dict = {}
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._dropped = 0
        self._drop_warned = False
        self._metrics = metrics
        self._sink = None
        self._sink_path = jsonl_path
        if jsonl_path:
            try:
                os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                            exist_ok=True)
                self._sink = open(jsonl_path, "a", buffering=1)
            except OSError as e:
                warnings.warn(f"span JSONL sink {jsonl_path!r} could not "
                              f"open ({e}); recording in memory only",
                              RuntimeWarning, stacklevel=2)

    # -- recording ------------------------------------------------------

    def set_trace_id(self, tenant, trace_id) -> None:
        """Register ``tenant``'s trace id: later spans for that tenant
        carry it. Never raises."""
        try:
            if tenant is not None and trace_id:
                self.trace_ids[tenant] = str(trace_id)
        except Exception:  # noqa: BLE001 - observability must not crash
            pass

    def span(self, name: str, role: str, tenant=None,
             quantum: Optional[int] = None, **args) -> _SpanCtx:
        """``with recorder.span("drain", ROLE_DRAIN, tenant=3,
        quantum=7): ...`` measures and records the enclosed step."""
        return _SpanCtx(self, name, role, tenant, quantum, args)

    def record(self, name: str, role: str, t0: float, dur: float,
               tenant=None, quantum: Optional[int] = None,
               **args) -> None:
        """Record one finished span (monotonic ``t0``, ``dur`` in
        seconds). Never raises: a broken recorder must not take the
        executor down with it."""
        try:
            rec = {"name": name, "role": role,
                   "t0": t0 - self.epoch, "dur": dur,
                   "tenant": tenant, "quantum": quantum,
                   "thread": threading.current_thread().name}
            # an explicit trace_id wins, else the tenant's registered one
            tid = args.pop("trace_id", None)
            if tid is None and tenant is not None:
                tid = self.trace_ids.get(tenant)
            if tid is not None:
                rec["trace_id"] = str(tid)
            if args:
                rec["args"] = args
            with self._lock:
                dropped_now = len(self._ring) == self.capacity
                if dropped_now:
                    self._dropped += 1
                self._ring.append(rec)
                sink = self._sink
            if dropped_now:
                if self._metrics is not None:
                    try:
                        self._metrics.counter(
                            "serve_spans_dropped").inc()
                    except Exception:  # noqa: BLE001 - accounting only
                        pass
                if not self._drop_warned:
                    self._drop_warned = True
                    warnings.warn(
                        f"span ring overflowed (capacity "
                        f"{self.capacity}); oldest spans are being "
                        "dropped — raise span_capacity or attach a "
                        "JSONL sink for complete traces",
                        RuntimeWarning)
            if sink is not None:
                line = json.dumps(rec) + "\n"
                try:
                    with self._lock:
                        if self._sink is not None:
                            self._sink.write(line)
                except (OSError, ValueError) as e:
                    self._disable_sink(e)
        except Exception:  # noqa: BLE001 - observability must not crash
            pass

    def _disable_sink(self, err) -> None:
        with self._lock:
            sink, self._sink = self._sink, None
        if sink is not None:
            try:
                sink.close()
            except Exception:  # noqa: BLE001
                pass
            warnings.warn(
                f"span JSONL sink {self._sink_path!r} failed "
                f"({type(err).__name__}: {err}); sink disabled, spans "
                "stay in memory", RuntimeWarning, stacklevel=3)

    # -- reading and export ---------------------------------------------

    def spans(self) -> List[Dict]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    @property
    def dropped(self) -> int:
        """Spans that fell off the ring (capacity overflow)."""
        with self._lock:
            return self._dropped

    def close(self) -> None:
        with self._lock:
            sink, self._sink = self._sink, None
        if sink is not None:
            try:
                sink.close()
            except Exception:  # noqa: BLE001
                pass

    def chrome_trace_doc(self,
                         tenant_names: Optional[Dict] = None) -> Dict:
        """The ring as a Chrome trace-event document (the Perfetto and
        ``chrome://tracing`` format), rendered in memory: one complete
        (``"ph": "X"``) event per span, ``pid`` = tenant id + 1 (each
        tenant a swimlane; pool-level spans on pid 0, "pool"), ``tid`` =
        thread role, ``ts`` and ``dur`` in microseconds since the
        recorder's epoch. ``tenant_names`` maps tenant id -> display name
        for the process_name metadata rows."""
        spans = self.spans()
        roles = {}   # role -> stable small tid
        events = []
        seen_pids = {}
        for s in spans:
            pid = 0 if s["tenant"] is None else int(s["tenant"]) + 1
            tid = roles.setdefault(s["role"], len(roles) + 1)
            seen_pids[pid] = s["tenant"]
            args = {k: v for k, v in (s.get("args") or {}).items()}
            if s["quantum"] is not None:
                args["quantum"] = s["quantum"]
            if s.get("trace_id") is not None:
                args["trace_id"] = s["trace_id"]
            args["thread"] = s["thread"]
            events.append({
                "name": s["name"], "ph": "X", "cat": s["role"],
                "pid": pid, "tid": tid,
                "ts": round(s["t0"] * 1e6, 3),
                "dur": round(s["dur"] * 1e6, 3),
                "args": args,
            })
        meta = []
        names = tenant_names or {}
        for pid, tenant in sorted(seen_pids.items()):
            label = ("pool" if tenant is None
                     else f"tenant {names.get(tenant, tenant)}")
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": label}})
            for role, tid in sorted(roles.items(), key=lambda kv: kv[1]):
                meta.append({"name": "thread_name", "ph": "M",
                             "pid": pid, "tid": tid,
                             "args": {"name": role}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.dropped,
                              # the wall-clock anchor of ts=0
                              "epoch_wall": self.epoch_wall}}

    def export_chrome_trace(self, path: str,
                            tenant_names: Optional[Dict] = None) -> str:
        """Write :meth:`chrome_trace_doc` to ``path`` (atomic). Returns
        ``path``."""
        doc = self.chrome_trace_doc(tenant_names=tenant_names)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, path)
        return path
