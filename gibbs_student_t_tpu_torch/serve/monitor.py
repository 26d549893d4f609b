"""Streaming per-tenant convergence monitoring for the chain server.

Counterpart of ``gibbs_student_t_tpu/serve/monitor.py``. A tenant of a
shared card pays for effective samples, and without a monitor it sees
nothing of its own convergence until ``result()``. A
:class:`TenantMonitor` closes that: the drain feeds it each quantum's
rows of the parameter chain ``x`` (already on the host with the rest of
the quantum's records; the monitored columns are a slice), it keeps
per-chain Welford running moments incrementally (O(new rows) an update),
and it evaluates ESS and split-R-hat over the monitored parameters with
the same ``parallel/diagnostics.py`` functions a post-hoc health report
uses, so ``TenantHandle.progress()`` matches ``ess_per_param`` and
``split_rhat_per_param`` on the same rows to 1e-6
(tests/test_torch_serve_obs.py, and chip_smoke.py phase 17a on the card).

Cost: an update appends the new rows and folds them into the moments;
the windowed autocorrelation (one batched FFT over ``rows x nchains x
|params|`` columns) reruns over the accumulated rows, throttled by
``MonitorSpec.every``. It runs on the drain thread, never the dispatch
thread.

Recycling (parallel/recycle.py): the drain passes each quantum's count of
recycled partial-scan rows, and the Welford moments weight them in (each
recycled row's x equals the next scan-end row's, so the weighting is
multiplicity 2 on the trailing rows, with no rebuilt array). ESS and
split-R-hat stay on the scan-end rows: a recycled row repeats its
neighbour's per-parameter values, so it would double the rows and the
measured autocorrelation time for the same verdict.

Failure contract: the server wraps every monitor call, and a monitor
exception detaches THAT tenant's monitor with a warning while the tenant
keeps serving.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np


@dataclass
class MonitorSpec:
    """A tenant's convergence-monitoring request
    (``TenantRequest.monitor``).

    ``params`` selects the monitored parameters: indices, or names
    resolved against the pool template's ``param_names`` at admission;
    ``None`` monitors every parameter (the monitored columns are what the
    diagnostics pay for, so pick a subset of a wide model).
    ``ess_target`` and ``rhat_target`` arm the convergence verdict: the
    tenant counts as converged at the first evaluation where every armed
    target holds (min ESS >= ``ess_target``, max split-R-hat <=
    ``rhat_target``), recorded as ``converged_at`` (the sweep). ``every``
    evaluates the windowed diagnostics every N quanta (the Welford fold
    still runs every quantum); ``min_rows`` suppresses evaluation below a
    floor where split-R-hat is noise.
    """

    params: Optional[Sequence] = None
    ess_target: Optional[float] = None
    rhat_target: Optional[float] = None
    every: int = 1
    min_rows: int = 8

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"monitor every must be >= 1, got "
                             f"{self.every}")
        if self.min_rows < 4:
            raise ValueError(f"monitor min_rows must be >= 4, got "
                             f"{self.min_rows}")


def resolve_params(spec: MonitorSpec, param_names) -> np.ndarray:
    """The monitored parameter indices of a spec's names or indices,
    against the template's ``param_names`` (checked at admission: a bad
    name or index rejects the tenant, never the pool)."""
    names = list(param_names)
    if spec.params is None:
        return np.arange(len(names))
    idx = []
    for p in spec.params:
        if isinstance(p, str):
            if p not in names:
                raise ValueError(f"monitored parameter {p!r} not in "
                                 f"the pool template ({names[:8]}...)")
            idx.append(names.index(p))
        else:
            i = int(p)
            if not 0 <= i < len(names):
                raise ValueError(f"monitored parameter index {i} out "
                                 f"of range [0, {len(names)})")
            idx.append(i)
    if not idx:
        raise ValueError("monitor params must not be empty")
    return np.asarray(idx, int)


class TenantMonitor:
    """Online ESS and split-R-hat over one tenant's monitored columns.

    ``update()`` runs on the drain thread (one call a drained quantum);
    ``snapshot()`` and the handle's ``progress()`` may be called from any
    thread at any time: the state is guarded by a lock and snapshots are
    plain dicts.
    """

    def __init__(self, spec: MonitorSpec, nchains: int,
                 param_idx: np.ndarray, param_names=None,
                 record_thin: int = 1, blocks=None, block_names=None):
        self.spec = spec
        self.nchains = int(nchains)
        self.param_idx = np.asarray(param_idx, int)
        self.param_names = (None if param_names is None else
                            [str(param_names[i]) for i in self.param_idx])
        self.record_thin = int(record_thin)
        # each monitored column's block index (-1: none); arms the
        # per-block rows of the snapshot, min-reductions over the
        # per-parameter ESS already computed
        self.blocks = None if blocks is None else np.asarray(blocks, int)
        self.block_names = (None if block_names is None
                            else [str(n) for n in block_names])
        self._block_ess: Dict[int, float] = {}
        self._lock = threading.Lock()
        # the accumulated monitored window, (rows, nchains, |params|)
        # float32, grown geometrically so an append copies O(new rows)
        self._buf = np.empty((0, self.nchains, len(self.param_idx)),
                             np.float32)
        self._rows = 0
        # Welford running moments per (chain, param): count, mean and M2,
        # live between (and independent of) the windowed evaluations
        self._w_n = 0
        self._w_mean = np.zeros((self.nchains, len(self.param_idx)),
                                np.float64)
        self._w_m2 = np.zeros_like(self._w_mean)
        self._updates = 0
        self._t_first: Optional[float] = None
        # recycled partial-scan rows folded into the weighted moments
        # (the windowed ESS and R-hat stay on the scan-end rows)
        self._recycled = 0
        self._snap: Dict[str, object] = {
            "rows": 0, "sweeps": 0, "params": self.param_names,
            "ess": None, "ess_min": None, "rhat": None, "rhat_max": None,
            "ess_per_s": None, "est_sweeps_to_target": None,
            "converged_at": None,
        }

    # -- the drain's side -----------------------------------------------

    def _append(self, rows: np.ndarray) -> None:
        need = self._rows + rows.shape[0]
        if need > self._buf.shape[0]:
            grown = np.empty((max(need, 2 * self._buf.shape[0]),)
                             + self._buf.shape[1:], np.float32)
            grown[:self._rows] = self._buf[:self._rows]
            self._buf = grown
        self._buf[self._rows:need] = rows
        self._rows = need

    def _welford(self, rows: np.ndarray,
                 weights: Optional[np.ndarray] = None) -> None:
        """Chan's batched merge: fold the new rows' count, mean and M2
        into the running moments in one vectorized step. ``weights`` (per
        row, the recycled rows' multiplicities) makes it the weighted
        merge; integer weights equal duplicated rows."""
        rows = np.asarray(rows, np.float64)            # (nb, nchains, p)
        nb = rows.shape[0]
        if nb == 0:
            return
        if weights is None:
            wsum = float(nb)
            bm = rows.mean(axis=0)
            bm2 = ((rows - bm) ** 2).sum(axis=0)
        else:
            w = np.asarray(weights, np.float64).reshape(nb, 1, 1)
            wsum = float(w.sum())
            bm = (w * rows).sum(axis=0) / wsum
            bm2 = (w * (rows - bm) ** 2).sum(axis=0)
        tot = self._w_n + wsum
        delta = bm - self._w_mean
        self._w_m2 += bm2 + delta ** 2 * (self._w_n * wsum / tot)
        self._w_mean += delta * (wsum / tot)
        self._w_n = tot

    def _columns(self, x_rows: np.ndarray, what: str) -> np.ndarray:
        x_rows = np.asarray(x_rows)
        if x_rows.ndim != 3 or x_rows.shape[1] != self.nchains:
            raise ValueError(
                f"monitor {what} wants (rows, nchains={self.nchains}, "
                f"p), got {x_rows.shape}")
        if x_rows.shape[2] != len(self.param_idx):
            x_rows = x_rows[:, :, self.param_idx]
        return x_rows

    @staticmethod
    def _recycle_weights(nb: int, recycled: int):
        """``(weights, recycled)`` of ``nb`` scan-end rows of which the
        trailing ``recycled`` each stand for a recycled row too."""
        if not recycled:
            return None, 0
        recycled = min(int(recycled), nb)
        weights = np.ones(nb)
        weights[nb - recycled:] += 1.0
        return weights, recycled

    def update(self, x_rows: np.ndarray, sweep_end: int,
               recycled: int = 0) -> None:
        """Fold one drained quantum: ``x_rows`` is the tenant's new
        ``(rows, nchains, p_model)`` rows (or ``(rows, nchains,
        |params|)``, already sliced). ``recycled`` is the quantum's count
        of recycled partial-scan rows, which the moments weight in (see
        the module docstring). O(new rows) plus the throttled windowed
        evaluation."""
        x_rows = self._columns(x_rows, "update")
        now = time.monotonic()
        weights, recycled = self._recycle_weights(x_rows.shape[0], recycled)
        with self._lock:
            if self._t_first is None:
                self._t_first = now
            self._append(np.asarray(x_rows, np.float32))
            self._welford(x_rows, weights=weights)
            self._recycled += recycled
            self._updates += 1
            self._snap["rows"] = self._rows
            self._snap["sweeps"] = int(sweep_end)
            if self._recycled:
                self._snap["recycled_rows"] = self._recycled
            if (self._updates % self.spec.every == 0
                    and self._rows >= self.spec.min_rows):
                self._evaluate(now, int(sweep_end))

    def backfill(self, x_rows: np.ndarray, sweep_end: int,
                 updates: int = 0, recycled: int = 0) -> None:
        """Seed the window with rows recorded before this monitor existed
        (a resumed tenant's spooled prefix): one fold without an
        evaluation, plus the update count the prefix's quanta would have
        advanced, so the first evaluation after the resume sees the same
        rows, at the same ``every`` phase, as the uninterrupted run's at
        that sweep."""
        x_rows = self._columns(x_rows, "backfill")
        weights, recycled = self._recycle_weights(x_rows.shape[0], recycled)
        with self._lock:
            self._append(np.asarray(x_rows, np.float32))
            self._welford(x_rows, weights=weights)
            self._recycled += recycled
            self._updates += int(updates)
            self._snap["rows"] = self._rows
            self._snap["sweeps"] = int(sweep_end)
            if self._recycled:
                self._snap["recycled_rows"] = self._recycled

    def _evaluate(self, now: float, sweep_end: int) -> None:
        """The windowed diagnostics over the accumulated rows: exactly
        the post-hoc ``parallel/diagnostics`` functions. The caller holds
        the lock."""
        from gibbs_student_t_tpu_torch.parallel.diagnostics import (
            ess_per_param,
            split_rhat_per_param,
        )

        window = self._buf[:self._rows]
        ess = ess_per_param(window)
        rhat = split_rhat_per_param(window)
        s = self._snap
        s["ess"] = [float(v) for v in ess]
        s["ess_min"] = float(ess.min())
        s["rhat"] = [float(v) for v in rhat]
        rhat_fin = rhat[np.isfinite(rhat)]
        s["rhat_max"] = (float(rhat_fin.max()) if rhat_fin.size
                         else None)
        dt = now - (self._t_first or now)
        s["ess_per_s"] = (float(ess.min()) / dt if dt > 0 else None)
        spec = self.spec
        if self.blocks is not None:
            bl = {}
            for bi in np.unique(self.blocks[self.blocks >= 0]):
                sel = self.blocks == bi
                be = float(ess[sel].min())
                self._block_ess[int(bi)] = be
                name = (self.block_names[bi] if self.block_names
                        else str(int(bi)))
                entry = {"ess_min": be, "params": int(sel.sum())}
                if spec.ess_target is not None:
                    entry["converged"] = bool(be >= spec.ess_target)
                bl[name] = entry
            s["blocks"] = bl
        if spec.ess_target is not None and ess.min() > 0:
            # sweeps scale about linearly with ESS once mixing: extrapolate
            # from the observed sweeps per effective sample
            need = spec.ess_target / float(ess.min())
            s["est_sweeps_to_target"] = int(max(
                0.0, np.ceil(sweep_end * (need - 1.0))))
        ok = spec.ess_target is not None or spec.rhat_target is not None
        if spec.ess_target is not None:
            ok = ok and float(ess.min()) >= spec.ess_target
        if spec.rhat_target is not None:
            ok = ok and (s["rhat_max"] is not None
                         and s["rhat_max"] <= spec.rhat_target)
        if ok and s["converged_at"] is None:
            s["converged_at"] = int(sweep_end)
            s["converged_t"] = now
            if spec.ess_target is not None:
                s["est_sweeps_to_target"] = 0

    # -- any thread -----------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """The latest progress view (a plain dict copy): ``rows``,
        ``sweeps``, per-parameter ``ess``/``rhat`` with their
        ``ess_min``/``rhat_max``, ``ess_per_s``,
        ``est_sweeps_to_target`` and ``converged_at`` (None until the
        armed targets hold)."""
        with self._lock:
            out = dict(self._snap)
            if self._w_n >= 2:
                # the Welford within-chain spread: live, even between
                # windowed evaluations
                out["within_chain_std_mean"] = float(
                    np.sqrt(self._w_m2 / (self._w_n - 1)).mean())
        out.pop("converged_t", None)
        return out

    def block_ess(self) -> Dict[int, float]:
        """The latest per-block min-ESS by block index; empty before the
        first evaluation or without a block mapping."""
        with self._lock:
            return dict(self._block_ess)

    @property
    def converged_at(self) -> Optional[int]:
        with self._lock:
            v = self._snap.get("converged_at")
            return None if v is None else int(v)

    @property
    def converged_t(self) -> Optional[float]:
        """Monotonic time of the convergence verdict (the
        submit->converged latency's end), None while unconverged."""
        with self._lock:
            v = self._snap.get("converged_t")
            return None if v is None else float(v)
