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

The serving observability plane (``serve.ChainServer`` drives it):

- :mod:`~gibbs_student_t_tpu_torch.obs.spans` — per-tenant executor spans
  in a bounded ring, exported as a Chrome trace.
- :mod:`~gibbs_student_t_tpu_torch.obs.flight` — the flight recorder: the
  last quanta, events and heartbeats, dumped as a postmortem bundle.
- :mod:`~gibbs_student_t_tpu_torch.obs.watchdog` — the stall watchdog
  (``GST_SERVE_WATCHDOG``).
- :mod:`~gibbs_student_t_tpu_torch.obs.export` — the Prometheus text of a
  metrics registry (``obs_dir/metrics.prom``).
- :mod:`~gibbs_student_t_tpu_torch.obs.schema` — the validator and this
  package's copy of the records' schemas.

Not ported: the JAX package's XLA compile introspection
(``obs/introspect.py``; ROADMAP A-10), and the wire's HTTP endpoints and
fleet views (``obs/http.py``, ``obs/aggregate.py``; ROADMAP A-9).
"""

from gibbs_student_t_tpu_torch.obs.export import (
    prometheus_text,
    write_prometheus,
)
from gibbs_student_t_tpu_torch.obs.flight import FlightRecorder, read_bundle
from gibbs_student_t_tpu_torch.obs.metrics import MetricsRegistry
from gibbs_student_t_tpu_torch.obs.spans import SpanRecorder
from gibbs_student_t_tpu_torch.obs.watchdog import (
    Watchdog,
    WatchdogSpec,
    serve_watchdog_env,
)

__all__ = ["FlightRecorder", "MetricsRegistry", "SpanRecorder", "Watchdog",
           "WatchdogSpec", "prometheus_text", "read_bundle",
           "serve_watchdog_env", "write_prometheus"]
