"""Chain-health monitoring: stuck / dead / diverged classification.

A copy of ``gibbs_student_t_tpu/obs/health.py``. Combines the drained
in-run telemetry counters
(:mod:`~gibbs_student_t_tpu_torch.obs.telemetry`, the ``tele_*`` entries of
``ChainResult.stats``) with the existing cross-chain ESS / split-R-hat
machinery (``parallel/diagnostics.py``) into one per-chain verdict:

- **diverged** — the state went non-finite at least once (the sticky
  in-kernel flag; these chains' records after the divergence are noise);
- **stuck** — finite, but both MH blocks accepted (almost) nothing over
  the run: the chain is frozen at its current point and contributes no
  mixing (typical cause: a jump scale far past adaptation's bracket);
- **dead** — finite and accepting, but the recorded window has ~zero
  variance in every parameter (a chain wedged in a degenerate mode);
- **ok** — everything else.

Diagnostics imports are deferred to call time: ``obs`` is imported by
``backends/torch_backend.py`` at module load, and ``parallel``'s package
init imports the backend right back.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

STATUS_OK = "ok"
STATUS_DIVERGED = "diverged"
STATUS_STUCK = "stuck"
STATUS_DEAD = "dead"


def chain_health(stats: Dict[str, np.ndarray],
                 window: Optional[np.ndarray] = None,
                 stuck_accept: float = 0.01,
                 rhat_threshold: float = 1.1) -> Dict[str, object]:
    """Per-chain health verdicts from a run's telemetry stats.

    ``stats`` is a ``ChainResult.stats`` dict holding the ``tele_*``
    aggregates (any leading batch shape — ``(C,)`` single-model,
    ``(P, C)`` ensemble; verdicts keep that shape). ``window``, when
    given, is a ``(rows, C, p)`` recorded-chain window (e.g.
    ``res.chain[rows//2:]``) used for the dead-chain test plus pooled
    ESS / split-R-hat context; pass the matching single-pulsar slice for
    ensembles. Returns a report dict (see ``format_health``).
    """
    div = np.asarray(stats.get("tele_diverged", np.zeros(0, bool)), bool)
    if div.size == 0:
        raise ValueError("stats carry no telemetry (no tele_* keys); "
                         "run the sampler with telemetry enabled")
    nonf = np.asarray(stats.get("tele_nonfinite", np.zeros_like(div, int)))
    acc_w = np.asarray(stats.get("tele_accept_white",
                                 np.zeros(div.shape, np.float32)))
    acc_h = np.asarray(stats.get("tele_accept_hyper",
                                 np.zeros(div.shape, np.float32)))

    diverged = div | (nonf > 0)
    stuck = ~diverged & (acc_w < stuck_accept) & (acc_h < stuck_accept)

    dead = np.zeros(div.shape, bool)
    ess_min = rhat_max = None
    if window is not None and window.size:
        window = np.asarray(window)
        if window.ndim != 3 or window.shape[1] != div.size:
            raise ValueError(
                f"window must be (rows, nchains={div.size}, p), got "
                f"{window.shape}; slice one pulsar for ensemble stats")
        # a chain is dead when EVERY parameter's in-window variance is
        # ~zero relative to the cross-chain spread of that parameter
        var = window.var(axis=0)                      # (C, p)
        scale = np.maximum(window.std(axis=(0, 1)), 1e-30) ** 2   # (p,)
        dead_flat = (var <= 1e-12 * scale).all(axis=1) & ~diverged.ravel()
        dead = dead_flat.reshape(div.shape)
        from gibbs_student_t_tpu_torch.parallel.diagnostics import (
            ess_per_param,
            split_rhat_per_param,
        )

        ok_chains = ~(diverged | dead).ravel()
        if ok_chains.sum() >= 2 and window.shape[0] >= 4:
            healthy = window[:, ok_chains]
            ess_min = float(ess_per_param(healthy).min())
            rhat_max = float(split_rhat_per_param(healthy).max())

    status = np.full(div.shape, STATUS_OK, dtype=object)
    status[stuck] = STATUS_STUCK
    status[dead] = STATUS_DEAD
    status[diverged] = STATUS_DIVERGED  # strongest verdict wins
    report = {
        "nchains": int(div.size),
        "status": status,
        "n_ok": int((status == STATUS_OK).sum()),
        "n_diverged": int(diverged.sum()),
        "n_stuck": int(stuck.sum()),
        "n_dead": int(dead.sum()),
        "accept_white_mean": float(acc_w.mean()),
        "accept_hyper_mean": float(acc_h.mean()),
        "nonfinite_sweeps": int(nonf.sum()),
        "ess_min": ess_min,
        "rhat_max": rhat_max,
        "rhat_ok": (None if rhat_max is None
                    else bool(rhat_max < rhat_threshold)),
    }
    return report


def format_health(report: Dict[str, object]) -> str:
    """One stderr-ready line per report, for a command-line run."""
    bits = [f"chains {report['n_ok']}/{report['nchains']} ok"]
    for k in ("diverged", "stuck", "dead"):
        if report[f"n_{k}"]:
            bits.append(f"{report[f'n_{k}']} {k}")
    bits.append(f"acc w/h {report['accept_white_mean']:.2f}/"
                f"{report['accept_hyper_mean']:.2f}")
    if report["rhat_max"] is not None:
        bits.append(f"rhat_max {report['rhat_max']:.3f}")
    if report["ess_min"] is not None:
        bits.append(f"ess_min {report['ess_min']:.0f}")
    return "health: " + ", ".join(bits)
