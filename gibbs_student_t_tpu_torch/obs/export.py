"""Prometheus text exposition of a :class:`MetricsRegistry`.

Counterpart of ``gibbs_student_t_tpu/obs/export.py``
(:func:`prometheus_text`, :func:`prometheus_labeled` and
:func:`write_prometheus`). The serving stack keeps its live metrics in an
in-process registry (counters, gauges, histograms; obs/metrics.py). This
module renders a registry snapshot in the Prometheus text exposition
format (version 0.0.4: ``# HELP``/``# TYPE`` headers, cumulative
``_bucket{le=...}`` rows, ``_sum``/``_count``), so a scrape-shaped
consumer, or a plain ``watch cat``, can read a live server without any
RPC surface: ``ChainServer(obs_dir=...)`` refreshes ``metrics.prom`` and
``status.json`` at quantum boundaries. :func:`prometheus_labeled`
renders families whose samples carry a label set each (the fleet's
per-pool gauges).

Write discipline: atomic replace (a scraper never sees a torn file), and
:func:`write_prometheus` never raises: an IO error warns once per path
and returns None.
"""

from __future__ import annotations

import math
import os
import re
import time
import warnings
from typing import Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: paths that already warned about a failed write (warn once, then stay
#: quiet: the refresh runs every quantum)
_WARNED = set()

#: ``# HELP`` texts of the known metric families; other families get a
#: line derived from their kind (the format wants HELP and TYPE exactly
#: once a family, before its samples)
_HELP = {
    "gst_serve_occupancy": "Busy chain-lanes / pool lanes, per quantum",
    "gst_serve_queue_depth": "Admission queue depth",
    "gst_serve_admissions": "Tenants admitted",
    "gst_serve_admission_ms": "Submit->admit latency (queue wait incl.)",
    "gst_serve_first_result_ms": "Admit->first drained result latency",
    "gst_serve_converged_ms": "Submit->converged latency (monitored)",
    "gst_serve_sweeps_total": "Chain-sweeps served",
    "gst_serve_tenant_faults": "Tenant-scoped contained failures",
    "gst_serve_quarantined_lanes": "Lanes frozen by quarantine policy",
    "gst_serve_reinits": "Lanes re-drawn from the prior",
    "gst_serve_worker_restarts": "Supervised executor worker restarts",
    "gst_serve_monitor_errors": "Detached per-tenant monitors",
    "gst_serve_spans_dropped": "Spans dropped from the bounded ring",
}


def _metric_name(name: str, prefix: str = "gst_") -> str:
    """A valid Prometheus metric name: prefixed, invalid chars -> _."""
    name = _NAME_RE.sub("_", name)
    if not name or not (name[0].isalpha() or name[0] in "_:"):
        name = "_" + name
    return prefix + name if not name.startswith(prefix) else name


def _escape_label_value(value) -> str:
    """Label-value escaping: backslash, double quote and newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP-text escaping: backslash and newline only."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labels) -> str:
    """``{k="v",...}`` with sanitized names and escaped values; the empty
    string without labels."""
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        name = _LABEL_NAME_RE.sub("_", str(k)) or "_"
        parts.append(f'{name}="{_escape_label_value(labels[k])}"')
    return "{" + ",".join(parts) + "}"


def _merge_labels(label_str: str, extra: str) -> str:
    """A rendered label block with one extra ``k="v"`` pair (the
    histogram's ``le``)."""
    if not label_str:
        return "{" + extra + "}"
    return label_str[:-1] + "," + extra + "}"


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def prometheus_text(snapshot: dict, prefix: str = "gst_",
                    ts_ms: Optional[int] = None,
                    labels: Optional[dict] = None) -> str:
    """Render a ``MetricsRegistry.snapshot()`` dict as Prometheus text.

    Counters keep their value, gauges their last value, histograms
    become the cumulative ``_bucket``/``_sum``/``_count`` family.
    ``ts_ms`` (unix milliseconds) stamps every sample when given;
    ``labels`` attaches one label set to every sample, its values escaped
    (``\\``, ``"``, newline), so hostile strings cannot tear the text.
    ``# HELP`` and ``# TYPE`` come exactly once a family, before its
    samples.
    """
    out = []
    suffix = f" {ts_ms}" if ts_ms is not None else ""
    lbl = _label_str(labels)

    def _head(n: str, kind: str) -> None:
        out.append(f"# HELP {n} "
                   f"{_escape_help(_HELP.get(n, f'{kind} {n}'))}")
        out.append(f"# TYPE {n} {kind}")

    for name, value in sorted((snapshot.get("counters") or {}).items()):
        n = _metric_name(name, prefix)
        _head(n, "counter")
        out.append(f"{n}{lbl} {_fmt(value)}{suffix}")
    for name, value in sorted((snapshot.get("gauges") or {}).items()):
        n = _metric_name(name, prefix)
        _head(n, "gauge")
        out.append(f"{n}{lbl} {_fmt(value)}{suffix}")
    for name, h in sorted((snapshot.get("histograms") or {}).items()):
        n = _metric_name(name, prefix)
        _head(n, "histogram")
        cum = 0
        buckets = h.get("buckets") or {}
        # the registry's buckets are per-bin counts keyed by ascending
        # upper bound (with a trailing "+inf"); the format wants
        # cumulative le= rows
        for le, c in buckets.items():
            cum += int(c)
            le_lbl = "+Inf" if le in ("+inf", "+Inf") else le
            row_lbl = _merge_labels(lbl, f'le="{le_lbl}"')
            out.append(f"{n}_bucket{row_lbl} {cum}{suffix}")
        out.append(f"{n}_sum{lbl} {_fmt(h.get('sum', 0.0))}{suffix}")
        out.append(f"{n}_count{lbl} {int(h.get('count', 0))}{suffix}")
    return "\n".join(out) + "\n"


def prometheus_labeled(families: dict, prefix: str = "gst_",
                       ts_ms: Optional[int] = None) -> str:
    """Render families of samples with a label set each.

    :func:`prometheus_text` attaches one label set to a whole registry
    snapshot; a fleet's exposition declares each family once with a
    sample row a pool (a repeated ``# TYPE`` is invalid exposition).
    ``families`` maps a family's name to ``{"kind": "gauge"|"counter",
    "help": str (optional), "samples": [(labels_dict, value), ...]}``;
    ``# HELP`` and ``# TYPE`` come once a family, then every sample row
    with its own label block. The fleet router's ``GET /metrics`` renders
    its counters and per-pool gauges with it."""
    out = []
    suffix = f" {ts_ms}" if ts_ms is not None else ""
    for name in sorted(families):
        fam = families[name] or {}
        n = _metric_name(name, prefix)
        kind = fam.get("kind") or "gauge"
        help_ = fam.get("help") or _HELP.get(n, f"{kind} {n}")
        out.append(f"# HELP {n} {_escape_help(help_)}")
        out.append(f"# TYPE {n} {kind}")
        for labels, value in fam.get("samples") or ():
            out.append(f"{n}{_label_str(labels)} {_fmt(value)}{suffix}")
    return "\n".join(out) + ("\n" if out else "")


def write_prometheus(registry, path: str, prefix: str = "gst_",
                     labels: Optional[dict] = None) -> Optional[str]:
    """Atomically write ``registry``'s snapshot to ``path`` in the
    exposition format. Returns the path, or None (with one warning a
    path) when the write fails: a refresh must never crash a run."""
    try:
        text = prometheus_text(registry.snapshot(), prefix=prefix,
                               ts_ms=int(time.time() * 1e3),
                               labels=labels)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
        return path
    except Exception as e:  # noqa: BLE001 - observability must not raise
        if path not in _WARNED:
            _WARNED.add(path)
            warnings.warn(f"prometheus exposition write {path!r} failed "
                          f"({type(e).__name__}: {e}); writes keep being "
                          "attempted, this warning is not repeated",
                          RuntimeWarning, stacklevel=2)
        return None
