"""Observability: in-run telemetry and chain health.

- :mod:`~gibbs_student_t_tpu_torch.obs.telemetry` — the ``Telemetry``
  counters carried through a chunk of sweeps: per-block MH accept sums,
  per-chain non-finite divergence counters, the chunk-end log-posterior.
  Drained to the host once per chunk with the record pull.
- :mod:`~gibbs_student_t_tpu_torch.obs.health` — stuck/dead/diverged
  chain classification from the drained counters and the
  ``parallel/diagnostics`` ESS/R-hat machinery.

The JAX package's metrics registry, tracing, compile introspection and
ledger (``gibbs_student_t_tpu/obs/``) are not part of this package yet.
"""
