"""Durable run ledger: one append-only JSONL record per driver run.

Counterpart of ``gibbs_student_t_tpu/obs/ledger.py``. A driver
(``drivers/run_sims.py``) lands one schema-versioned record whatever
happens to its streams: the metrics it printed plus provenance (git SHA,
the platform it ran on, device kinds, config fingerprint, a host-speed
canary).

Write discipline: append-only; each record is one compact JSON line
written by a single ``os.write`` on an ``O_APPEND`` descriptor and
fsync'd, so concurrent writers interleave at line granularity and a crash
leaves at worst one torn last line, which :func:`read_ledger` skips.

Path: an explicit path wins, then ``GST_LEDGER_PATH``, then
``artifacts/ledger.jsonl`` relative to the current directory (the JAX
package's rule).

Schema v1, the JAX package's keys with ``cuda`` in place of ``xla``
(this package compiles no XLA): ``schema``, ``t``, ``timestamp_utc``,
``tool``, ``git_sha``, ``platform`` (``"cuda"`` or ``"cpu"``, the device
the sampler ran on), ``devices`` (obs/metrics topology), ``argv``,
``metrics``, ``cuda`` (obs/introspect.py ``compile_summary``: the
programs' first chunks, the kernels and linalg implementations that ran,
the kernels' build), ``config_fingerprint``, ``host_canary_ms``, optional
extras.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

LEDGER_SCHEMA = 1
DEFAULT_LEDGER = os.path.join("artifacts", "ledger.jsonl")


def ledger_path(path: Optional[str] = None) -> str:
    """The ledger file path (explicit > ``GST_LEDGER_PATH`` > default)."""
    if path:
        return path
    return os.environ.get("GST_LEDGER_PATH") or DEFAULT_LEDGER


def config_fingerprint(config) -> str:
    """12-hex-digit sha1 of the canonical JSON form of ``config``: key
    order independent, numpy/dataclass tolerant, and the same string the
    JAX package gives for the same config."""
    from gibbs_student_t_tpu_torch.obs.metrics import _jsonable

    blob = json.dumps(_jsonable(config), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def host_canary_ms(reps: int = 3) -> Optional[float]:
    """Fixed-work host-speed microbench: best-of-``reps`` wall ms of a
    seeded numpy dense solve and product, so a reader of the ledger can
    tell host drift from a code change. None when the probe itself
    fails."""
    try:
        import numpy as _np

        rng = _np.random.default_rng(1234)
        a = rng.standard_normal((192, 192))
        a = a @ a.T + 192 * _np.eye(192)
        b = rng.standard_normal((192, 64))
        best = None
        for _ in range(max(int(reps), 1)):
            t0 = time.perf_counter()
            x = _np.linalg.solve(a, b)
            y = a @ x
            float(y[0, 0])
            dt = (time.perf_counter() - t0) * 1e3
            if best is None or dt < best:
                best = dt
        return round(best, 4)
    except Exception:  # noqa: BLE001 - the canary never fails a run
        return None


def make_record(tool: str, metrics: Dict[str, Any], *,
                platform: Optional[str] = None,
                config=None,
                argv: Optional[List[str]] = None,
                cuda: Any = "auto",
                extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One schema-v1 record. ``metrics`` is the tool's payload;
    ``config`` is fingerprinted, not stored (the argv is in the record).
    ``cuda="auto"`` takes the process's introspection summary
    (obs/introspect.py); None records it as null."""
    from gibbs_student_t_tpu_torch.obs.introspect import compile_summary
    from gibbs_student_t_tpu_torch.obs.metrics import (
        _device_topology,
        _git_sha,
        _jsonable,
    )

    if cuda == "auto":
        cuda = compile_summary()

    rec: Dict[str, Any] = {
        "schema": LEDGER_SCHEMA,
        "t": round(time.time(), 3),
        "timestamp_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                       time.gmtime()),
        "tool": str(tool),
        "git_sha": _git_sha(),
        "platform": platform,
        "devices": _device_topology(),
        "argv": list(argv if argv is not None else sys.argv),
        "metrics": _jsonable(metrics),
        "cuda": _jsonable(cuda),
        "config_fingerprint": (config_fingerprint(config)
                               if config is not None else None),
        "host_canary_ms": host_canary_ms(),
    }
    if extra:
        rec.update(_jsonable(extra))
    return rec


def append_record(record: Dict[str, Any],
                  path: Optional[str] = None) -> str:
    """Append one record as a single atomic line write; the resolved
    path. An ``OSError`` gets one retry on a fresh descriptor, then a
    ``RuntimeWarning``: a ledger write never kills the run it
    describes."""
    from gibbs_student_t_tpu_torch.obs.metrics import _jsonable

    path = ledger_path(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    line = (json.dumps(_jsonable(record), separators=(",", ":"))
            + "\n").encode()
    for attempt in (0, 1):
        fd = None
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o644)
            os.write(fd, line)
            os.fsync(fd)
            return path
        except OSError as e:
            if attempt:
                import warnings

                warnings.warn(
                    f"ledger append to {path!r} failed twice "
                    f"({type(e).__name__}: {e}); record dropped",
                    RuntimeWarning, stacklevel=2)
        finally:
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
    return path


def read_ledger(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every parseable record, in file order; torn or garbage lines are
    skipped. A missing file gives []."""
    path = ledger_path(path)
    out: List[Dict[str, Any]] = []
    try:
        fh = open(path)
    except OSError:
        return out
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def last_record(tool: Optional[str] = None,
                path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The most recent record (optionally of one tool), or None."""
    recs = read_ledger(path)
    if tool is not None:
        recs = [r for r in recs if r.get("tool") == tool]
    return recs[-1] if recs else None
