"""In-run sampler telemetry: the ``Telemetry`` tuple of tensors.

Counterpart of ``gibbs_student_t_tpu/obs/telemetry.py``. A small batch of
per-chain counters carried through the sweeps of one chunk
(``backends/torch_backend.py`` ``TorchGibbs._run``, which the ensemble
shares). Per sweep it accumulates, on the device:

- per-MH-block accept sums (the sweep's ``acc_white``/``acc_hyper``
  rates summed, so the drain yields exact per-chunk acceptance rates);
- a per-chain non-finite divergence counter plus a sticky flag, with the
  state predicate of ``TorchGibbs.diverged_mask`` (:func:`state_bad`);
- the chunk-end log-posterior (filled once per chunk after the last
  sweep: a per-sweep evaluation would pay a factorization per sweep).

The tensors are zeroed at each chunk start and drained to the host WITH
the chunk's records, so telemetry adds no synchronization beyond the one
the record pull already pays; the cross-chunk totals live on the host in
:class:`TelemetryAccumulator`. Updates read the post-sweep state only and
never touch the generator, so chains with telemetry on are bitwise the
chains with it off.

The host half (``TelemetryAccumulator``, ``combine_tele_stats``,
``tele_stats_of``, ``TELE_PREFIX``) is a numpy copy of the JAX module's;
``TelemetryAccumulator.emit_chunk`` writes each drained chunk into a
metrics registry (obs/metrics.py) when the sampler has one
(``TorchGibbs(metrics=...)``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

#: ``ChainResult.stats`` key prefix for drained telemetry. These are
#: run-level per-chain aggregates, not per-sweep arrays: ``burn`` passes
#: them through and ``select_pulsar`` indexes their leading pulsar axis
#: (backends/base.py).
TELE_PREFIX = "tele_"


class Telemetry(NamedTuple):
    """Per-chain telemetry of one chunk. Every field has the chains'
    batch shape: ``(C,)`` in the solo sampler, ``(P, C)`` in the
    ensemble."""

    sweeps: torch.Tensor        # int32 — sweeps folded into this chunk
    accept_white: torch.Tensor  # f32 — sum of per-sweep block accept rates
    accept_hyper: torch.Tensor  # f32
    nonfinite: torch.Tensor     # int32 — sweeps whose state went non-finite
    diverged: torch.Tensor      # bool — sticky non-finite flag
    logpost: torch.Tensor       # f32 — chunk-end log-posterior


def telemetry_init(batch, device, dtype=torch.float32) -> Telemetry:
    """Chunk-start zeros of batch shape ``batch`` (a fresh tuple per
    chunk; cross-chunk totals accumulate on the host so float32 sums
    cannot saturate on long runs)."""
    batch = tuple(batch)

    def zeros(dt):
        return torch.zeros(batch, dtype=dt, device=device)

    return Telemetry(sweeps=zeros(torch.int32), accept_white=zeros(dtype),
                     accept_hyper=zeros(dtype), nonfinite=zeros(torch.int32),
                     diverged=zeros(torch.bool), logpost=zeros(dtype))


def state_bad(state, batch_ndim: int) -> torch.Tensor:
    """Bool of the state's batch shape: True where a chain is numerically
    dead, the predicate of the JAX package's ``_diverged_mask_device``:
    any of x, b, theta, alpha or df non-finite, or any alpha <= 0.

    One pass over the state: ``log(alpha)`` is finite exactly where alpha
    is finite and positive (log 0 = -inf, log of a negative or NaN is
    NaN, log inf = inf), so the predicate is one ``isfinite`` over
    ``[x, b, theta, df, log alpha]``."""
    batch = state.theta.shape[:batch_ndim]

    def flat(a):
        return a.reshape(*batch, -1)

    cols = torch.cat([flat(state.x), flat(state.b), flat(state.theta),
                      flat(state.df), flat(torch.log(state.alpha))], -1)
    return ~torch.isfinite(cols).all(-1)


def telemetry_update(tl: Telemetry, state) -> Telemetry:
    """Fold one post-sweep state (batch shape of ``tl``) into the chunk
    telemetry: elementwise reductions, O(n) a chain against the sweep's
    O(n·m + m³), and no host synchronization."""
    bad = state_bad(state, tl.sweeps.dim())
    return Telemetry(
        sweeps=tl.sweeps + 1,
        accept_white=tl.accept_white + state.acc_white,
        accept_hyper=tl.accept_hyper + state.acc_hyper,
        nonfinite=tl.nonfinite + bad,
        diverged=tl.diverged | bad,
        logpost=tl.logpost,
    )


class TelemetryAccumulator:
    """Host-side cross-chunk aggregation of drained ``Telemetry`` tuples.

    ``add`` takes one chunk's host copy (fields shaped ``(C,)`` for the
    solo sampler, ``(P, C)`` for ensembles; numpy arrays or CPU tensors)
    and folds it into running totals; ``stats()`` renders the run-level
    per-chain aggregates under :data:`TELE_PREFIX` keys for
    ``ChainResult.stats``.
    """

    def __init__(self):
        self._sweeps = 0
        self._acc_w = None
        self._acc_h = None
        self._nonfinite = None
        self._diverged = None
        self._logpost = None

    def add(self, tl: Telemetry) -> Dict[str, object]:
        """Fold one drained chunk in; returns that chunk's own summary."""
        sweeps = int(np.asarray(tl.sweeps).flat[0])
        acc_w = np.asarray(tl.accept_white, np.float64)
        acc_h = np.asarray(tl.accept_hyper, np.float64)
        nonf = np.asarray(tl.nonfinite, np.int64)
        div = np.asarray(tl.diverged, bool)
        self._sweeps += sweeps
        self._acc_w = acc_w if self._acc_w is None else self._acc_w + acc_w
        self._acc_h = acc_h if self._acc_h is None else self._acc_h + acc_h
        self._nonfinite = (nonf if self._nonfinite is None
                           else self._nonfinite + nonf)
        self._diverged = (div if self._diverged is None
                          else self._diverged | div)
        self._logpost = np.asarray(tl.logpost, np.float64)
        denom = max(sweeps, 1)
        finite_lp = self._logpost[np.isfinite(self._logpost)]
        return {
            "sweeps": sweeps,
            "acc_white": round(float(acc_w.mean()) / denom, 4),
            "acc_hyper": round(float(acc_h.mean()) / denom, 4),
            "nonfinite_sweeps": int(nonf.sum()),
            "diverged_chains": int(div.sum()),
            "logpost_mean": (round(float(finite_lp.mean()), 3)
                             if finite_lp.size else None),
            "logpost_min": (round(float(finite_lp.min()), 3)
                            if finite_lp.size else None),
        }

    def emit_chunk(self, registry, sweep_end: int,
                   chunk_summary: Dict[str, object]) -> None:
        """One ``chunk`` event (the summary :meth:`add` returned, at the
        sweep the chunk ends on) and the run counters and gauges it
        moves: ``sweeps_total`` (chain-sweeps), ``nonfinite_sweeps_total``,
        ``diverged_chains``, ``accept_white``, ``accept_hyper``."""
        nchains = int(np.asarray(self._acc_w).size)
        registry.counter("sweeps_total").inc(
            chunk_summary["sweeps"] * nchains)
        registry.counter("nonfinite_sweeps_total").inc(
            chunk_summary["nonfinite_sweeps"])
        registry.gauge("diverged_chains").set(
            chunk_summary["diverged_chains"])
        for blk in ("white", "hyper"):
            registry.gauge(f"accept_{blk}").set(
                chunk_summary[f"acc_{blk}"])
        registry.emit("chunk", sweep_end=sweep_end, **chunk_summary)

    @property
    def empty(self) -> bool:
        return self._acc_w is None

    def stats(self) -> Dict[str, np.ndarray]:
        """Run-level ``ChainResult.stats`` entries (TELE_PREFIX keys)."""
        if self.empty:
            return {}
        denom = max(self._sweeps, 1)
        return {
            "tele_sweeps": np.asarray(self._sweeps),
            "tele_accept_white": (self._acc_w / denom).astype(np.float32),
            "tele_accept_hyper": (self._acc_h / denom).astype(np.float32),
            "tele_nonfinite": self._nonfinite,
            "tele_diverged": self._diverged,
            "tele_logpost": self._logpost.astype(np.float32),
        }


def combine_tele_stats(per_segment: List[Dict[str, np.ndarray]]
                       ) -> Dict[str, np.ndarray]:
    """Merge TELE_PREFIX stats across ``sample_until`` segments: sweep
    counts and non-finite counters sum, acceptance means reweight by
    each segment's sweep count, the sticky flag ORs, and the running
    log-posterior keeps the last segment's value."""
    per_segment = [s for s in per_segment if "tele_sweeps" in s]
    if not per_segment:
        return {}
    weights = np.array([int(s["tele_sweeps"]) for s in per_segment],
                       np.float64)
    total = max(weights.sum(), 1.0)
    out = {
        "tele_sweeps": np.asarray(int(weights.sum())),
        "tele_nonfinite": np.sum(
            [s["tele_nonfinite"] for s in per_segment], axis=0),
        "tele_diverged": np.logical_or.reduce(
            [s["tele_diverged"] for s in per_segment]),
        "tele_logpost": per_segment[-1]["tele_logpost"],
    }
    for blk in ("white", "hyper"):
        k = f"tele_accept_{blk}"
        out[k] = (np.sum([w * np.asarray(s[k], np.float64) for w, s
                          in zip(weights, per_segment)], axis=0)
                  / total).astype(np.float32)
    return out


def tele_stats_of(stats: Dict[str, np.ndarray]
                  ) -> Optional[Dict[str, np.ndarray]]:
    """The TELE_PREFIX subset of a ``ChainResult.stats`` dict, or None
    when the run carried no telemetry."""
    sub = {k: v for k, v in stats.items() if k.startswith(TELE_PREFIX)}
    return sub or None
