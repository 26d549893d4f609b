"""Observability: in-run telemetry, chain health, metrics, ledger, tracing.

- :mod:`~gibbs_student_t_tpu_torch.obs.telemetry` — the ``Telemetry``
  counters carried through a chunk of sweeps: per-block MH accept sums,
  per-chain non-finite divergence counters, the chunk-end log-posterior.
  Drained to the host once per chunk with the record pull, and written
  into a metrics registry as one ``chunk`` event a flush.
- :mod:`~gibbs_student_t_tpu_torch.obs.health` — stuck/dead/diverged
  chain classification from the drained counters and the
  ``parallel/diagnostics`` ESS/R-hat machinery.
- :mod:`~gibbs_student_t_tpu_torch.obs.metrics` — counters, gauges and
  histograms with a JSONL event sink and the run manifest.
- :mod:`~gibbs_student_t_tpu_torch.obs.ledger` — the append-only run
  ledger, one record per driver run.
- :mod:`~gibbs_student_t_tpu_torch.obs.tracing` — ``torch.profiler``
  capture to a Chrome trace (``--trace-dir``) and named spans.
- :mod:`~gibbs_student_t_tpu_torch.obs.introspect` — what a run built and
  launched: each chunk program's first chunk, the hand-written kernels
  with their implementation and launch form, the linalg implementations
  and the kernels' build; the ``cuda`` block of the ledger record and the
  manifest, and ``run_sims --introspect``. The sweep's per-stage device
  times are ``ops/timers.py``'s, read by ``serve.ChainServer``.

The serving observability plane (``serve.ChainServer`` drives it):

- :mod:`~gibbs_student_t_tpu_torch.obs.spans` — per-tenant executor spans
  in a bounded ring, exported as a Chrome trace.
- :mod:`~gibbs_student_t_tpu_torch.obs.flight` — the flight recorder: the
  last quanta, events and heartbeats, dumped as a postmortem bundle.
- :mod:`~gibbs_student_t_tpu_torch.obs.watchdog` — the stall watchdog
  (``GST_SERVE_WATCHDOG``).
- :mod:`~gibbs_student_t_tpu_torch.obs.export` — the Prometheus text of a
  metrics registry (``obs_dir/metrics.prom``), and of families with a
  label set a sample (``prometheus_labeled``, the fleet's exposition).
- :mod:`~gibbs_student_t_tpu_torch.obs.schema` — the validator and this
  package's copy of the records' schemas.
- :mod:`~gibbs_student_t_tpu_torch.obs.http` — the read-only HTTP
  endpoints (``/healthz``, ``/status``, ``/metrics``, ``/trace``,
  ``/tenants/<id>/progress``, ``/postmortem``), mounted by
  ``ChainServer(http_port=...)``.
- :mod:`~gibbs_student_t_tpu_torch.obs.aggregate` — the fleet's view over
  those endpoints (or ``status.json`` paths): the merged occupancy and SLO
  snapshot the fleet router (serve/router.py) places by and serves, and
  the fleet trace stitched over the router's and the pools' clocks.
"""

from gibbs_student_t_tpu_torch.obs.aggregate import (
    fleet_status,
    read_status,
)
from gibbs_student_t_tpu_torch.obs.export import (
    prometheus_labeled,
    prometheus_text,
    write_prometheus,
)
from gibbs_student_t_tpu_torch.obs.flight import FlightRecorder, read_bundle
from gibbs_student_t_tpu_torch.obs.http import ObsHttpServer
from gibbs_student_t_tpu_torch.obs.introspect import (
    clear_introspection,
    compile_summary,
    format_summary,
    linalg_impls,
    register_kernel,
    register_linalg_impl,
)
from gibbs_student_t_tpu_torch.obs.metrics import MetricsRegistry
from gibbs_student_t_tpu_torch.obs.spans import SpanRecorder
from gibbs_student_t_tpu_torch.obs.watchdog import (
    Watchdog,
    WatchdogSpec,
    serve_watchdog_env,
)

__all__ = ["FlightRecorder", "MetricsRegistry", "ObsHttpServer",
           "SpanRecorder", "Watchdog", "WatchdogSpec", "clear_introspection",
           "compile_summary", "fleet_status", "format_summary",
           "linalg_impls", "prometheus_labeled", "prometheus_text",
           "read_bundle", "read_status", "register_kernel",
           "register_linalg_impl", "serve_watchdog_env",
           "write_prometheus"]
