"""Metrics registry with a JSONL event sink and run-manifest writer.

Counterpart of ``gibbs_student_t_tpu/obs/metrics.py``. Host-side only.
The sampler's per-chain counters live in
:mod:`~gibbs_student_t_tpu_torch.obs.telemetry`; what lands here is their
per-chunk drain (``TelemetryAccumulator.emit_chunk``), plus whatever the
drivers record (throughput, run lifecycle events). Wall-clock attribution
goes through ``utils/timing.BlockTimer``, which the registry owns as
:attr:`MetricsRegistry.timer`.

File layout of a run directory (``MetricsRegistry(run_dir=...)``):

- ``manifest.json`` — one JSON object identifying the run: git SHA,
  config, device topology, seeds, versions, argv. Its keys are the JAX
  package's, with ``torch_version`` and ``cuda_version`` in place of
  ``jax_version``; in place of the ``xla`` block, :meth:`MetricsRegistry.close`
  adds the ``cuda`` block of obs/introspect.py (what the run built and
  launched) once anything ran (this package compiles no XLA).
- ``events.jsonl`` — append-only, one JSON object per line, each with
  ``event`` (kind), ``t`` (unix seconds) and ``elapsed_s`` (seconds since
  the registry opened). Every line is flushed, so a killed run keeps its
  readable prefix.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


class Counter:
    """Monotonic float counter (sweeps, accepted MH steps). Thread-safe:
    ``+=`` on a float attribute is a read-modify-write."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc by {amount})")
        with self._lock:
            self.value += amount


class Gauge:
    """Last-value metric (sweeps/s, diverged-chain count)."""

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max. ``buckets``
    are upper bounds (a +inf bucket is implicit)."""

    DEFAULT_BUCKETS = (1e-4, 1e-3, 1e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                       10.0, 60.0, 600.0)

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.counts[int(np.searchsorted(self.buckets, value))] += 1
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)

    def summary(self) -> Dict[str, object]:
        return {
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max,
            "mean": self.sum / self.count if self.count else None,
            "buckets": dict(zip([*map(str, self.buckets), "+inf"],
                                self.counts)),
        }


class MetricsRegistry:
    """Named counters/gauges/histograms + JSONL events + run manifest.

    With ``run_dir=None`` the registry is in memory only: ``snapshot()``
    works and ``emit()`` is a no-op, so instrumented code never branches
    on whether a sink exists. Registration, event writes and ``close()``
    are guarded by one lock; ``close()`` is idempotent."""

    def __init__(self, run_dir: Optional[str] = None):
        from gibbs_student_t_tpu_torch.utils.timing import BlockTimer

        self.run_dir = run_dir
        self._metrics: Dict[str, object] = {}
        self.timer = BlockTimer()  # the registry's wall-clock source
        self._t0 = time.time()
        self._lock = threading.RLock()
        self._events_fh = None
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self._events_fh = open(os.path.join(run_dir, "events.jsonl"),
                                   "a", buffering=1)

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def time(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` with device-fenced wall attribution (BlockTimer)
        and mirror the duration into ``histogram(name + "_seconds")``."""
        t0 = time.perf_counter()
        out = self.timer.time(name, fn, *args, **kwargs)
        self.histogram(name + "_seconds").observe(time.perf_counter() - t0)
        return out

    def snapshot(self) -> Dict[str, object]:
        """All metric values plus the timer summary, JSON-ready."""
        out: Dict[str, object] = {"counters": {}, "gauges": {},
                                  "histograms": {},
                                  "timers": self.timer.summary()}
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.summary()
        return out

    def emit(self, event: str, **fields) -> None:
        """Append one event line to ``events.jsonl`` (no-op without a
        run_dir, or after ``close()``). Values go through the JSON
        sanitizer; only the file write is under the lock, so concurrent
        emitters never interleave partial lines."""
        if self._events_fh is None:
            return
        rec = {"event": event, "t": round(time.time(), 3),
               "elapsed_s": round(time.time() - self._t0, 3)}
        rec.update(fields)
        line = json.dumps(_jsonable(rec)) + "\n"
        with self._lock:
            if self._events_fh is not None:
                self._events_fh.write(line)

    def write_manifest(self, **fields) -> Optional[str]:
        """Write ``manifest.json`` into the run directory
        (:func:`write_manifest`); its path, or None without a run_dir."""
        if self.run_dir is None:
            return None
        return write_manifest(self.run_dir, **fields)

    def close(self) -> None:
        """Emit a final ``snapshot`` event, close the sink and fold the
        process's introspection (obs/introspect.py) into the manifest as
        its ``cuda`` block. Idempotent: one caller wins the close."""
        with self._lock:
            if self._events_fh is None:
                return
            self.emit("snapshot", metrics=self.snapshot())
            self._events_fh.close()
            self._events_fh = None
        self._augment_manifest_cuda()

    def _augment_manifest_cuda(self) -> None:
        """Add the manifest's ``cuda`` block at the close (the manifest is
        written before the run, the records during it). An atomic rewrite;
        any failure leaves the manifest as it was."""
        if self.run_dir is None:
            return
        path = os.path.join(self.run_dir, "manifest.json")
        if not os.path.exists(path):
            return
        try:
            from gibbs_student_t_tpu_torch.obs.introspect import (
                compile_summary,
            )

            summ = compile_summary()
            if not summ["n_programs"] and not summ["kernels"]:
                return
            with open(path) as fh:
                manifest = json.load(fh)
            manifest["cuda"] = _jsonable(summ)
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(manifest, fh, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 - observability must not raise
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ----------------------------------------------------------------------
# run manifest
# ----------------------------------------------------------------------


def _git_sha() -> Optional[str]:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _device_topology() -> Dict[str, object]:
    """Best-effort device inventory from ``torch.cuda``: name, count and
    compute capability of each card; ``backend`` is ``"cuda"`` where CUDA
    is available, else ``"cpu"``."""
    if "torch" not in sys.modules:
        return {"probed": False, "reason": "torch not imported yet"}
    torch = sys.modules["torch"]
    try:
        if not torch.cuda.is_available():
            return {"probed": True, "backend": "cpu", "device_count": 0,
                    "process_count": 1, "kinds": []}
        n = torch.cuda.device_count()
        return {"probed": True, "backend": "cuda", "device_count": n,
                "process_count": 1,
                "kinds": sorted({torch.cuda.get_device_name(i)
                                 for i in range(n)}),
                "capability": [list(torch.cuda.get_device_capability(i))
                               for i in range(n)]}
    except Exception as e:  # noqa: BLE001 - the manifest must always write
        return {"probed": False, "reason": f"{type(e).__name__}: {e}"[:200]}


def _jsonable(obj):
    """Recursively coerce numpy/tensor/dataclass values into JSON-native
    ones."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _jsonable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if "torch" in sys.modules and sys.modules["torch"].is_tensor(obj):
        return _jsonable(obj.detach().cpu().numpy())
    if isinstance(obj, np.ndarray):
        return _jsonable(obj.tolist())
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, (np.integer, int)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        f = float(obj)
        return f if np.isfinite(f) else repr(f)  # JSON has no inf/nan
    return obj if isinstance(obj, (str, type(None))) else repr(obj)


def write_manifest(run_dir: str, config=None, seeds=None, argv=None,
                   extra: Optional[Dict] = None) -> str:
    """Write ``manifest.json``: what attributes a telemetry stream to an
    exact code, config and hardware state. ``config`` may be a
    GibbsConfig (dataclass), dict or None; ``seeds`` the RNG seeds in
    play. Atomic: a crash cannot leave a torn manifest."""
    import torch

    manifest = {
        "schema": 1,
        "created_unix": round(time.time(), 3),
        "git_sha": _git_sha(),
        "argv": list(argv if argv is not None else sys.argv),
        "python": sys.version.split()[0],
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "devices": _device_topology(),
        "seeds": _jsonable(seeds),
        "config": _jsonable(config),
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith(("GST_", "CUDA_VISIBLE_DEVICES", "PYTORCH_",
                                 "TORCH_"))},
    }
    if extra:
        manifest.update(_jsonable(extra))
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "manifest.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def read_events(path: str) -> List[Dict]:
    """Parse an ``events.jsonl`` (skipping a torn final line from a
    crash); ``path`` may be the file or its run directory."""
    if os.path.isdir(path):
        path = os.path.join(path, "events.jsonl")
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
