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

The JAX package's XLA compile introspection (``obs/introspect.py``) and
its serving observability modules are not part of this package yet.
"""

from gibbs_student_t_tpu_torch.obs.metrics import MetricsRegistry

__all__ = ["MetricsRegistry"]
