"""Adaptive block scans for the slot pool (arXiv:1808.09047).

Counterpart of ``gibbs_student_t_tpu/serve/adapt.py``. A systematic Gibbs
scan re-samples every conditional block every sweep, but in a served pool
the streaming monitor knows which blocks' marginals have already delivered
their requested effective sample size. The adaptive scan thins a converged
block to a learned selection probability instead (the random-scan form of
the hybrid scans in arXiv:1808.09047), while unconverged blocks keep full
rate; a floor probability keeps every conditional selectable, so the chain
stays irreducible and targets the same posterior.

Plumbing: ``TorchGibbs._sweep`` takes a per-chain ``(NBLOCKS,)`` 0/1
enable vector (``block_gates``) and gates each block's draw: computed and
discarded, the draws made either way. The pool keeps the vectors in a
host buffer of its lanes (:meth:`SlotPool.set_block_gates`, uploaded at the
next dispatch), and the server redraws each monitored tenant's gates at
drain boundaries from a host stream seeded by ``(seed, tenant, sweep)``,
so a replayed request makes the same decisions at the same boundaries.
``GST_ADAPT_SCAN=0`` builds the pool without gates: today's sweep, op for
op.

Only the blocks with monitored x columns (white, hyper) ever thin: the
monitor measures their ESS. The theta, z, alpha and df conditionals and
the b draw stay full rate (b's gate is tied to hyper's; see
``torch_backend.BLOCK_B``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from gibbs_student_t_tpu_torch.backends.torch_backend import (
    BLOCK_HYPER,
    BLOCK_NAMES,
    BLOCK_WHITE,
    NBLOCKS,
)
from gibbs_student_t_tpu_torch.utils.env import env_choice

__all__ = ["BLOCK_NAMES", "NBLOCKS", "BLOCK_WHITE", "BLOCK_HYPER",
           "THINNABLE", "AdaptScanSpec", "adapt_scan_env",
           "adapt_scan_enabled", "resolve_adapt_scan", "param_blocks",
           "selection_probs", "draw_gates"]

#: blocks the policy may thin (the monitor measures their columns)
THINNABLE = (BLOCK_WHITE, BLOCK_HYPER)


def adapt_scan_env() -> str:
    """The validated ``GST_ADAPT_SCAN`` (``auto`` when unset), strictly
    ``auto|1|0``. ``auto`` and ``1`` give the pool its block gates (all
    ones until a policy thins a tenant, which is the ungated sweep's
    values); ``auto`` honours each request's ``adapt_scan`` while ``1``
    arms every monitored tenant with an ESS target with the default
    policy; ``0`` builds the pool without gates, today's sweep op for
    op."""
    return env_choice("GST_ADAPT_SCAN")


def adapt_scan_enabled() -> bool:
    """The pool's verdict at construction: does it carry block gates?"""
    return adapt_scan_env() != "0"


@dataclass
class AdaptScanSpec:
    """A tenant's adaptive-scan policy (``TenantRequest.adapt_scan``).

    ``ess_target`` is the per-block convergence threshold (the min ESS
    over the block's monitored columns); ``None`` takes the tenant's
    ``MonitorSpec.ess_target`` (submit checks that one of the two is set).
    ``floor`` is the least selection probability of a thinned block. A
    converged block's selection probability is ``clip(ess_target /
    ess_block, floor, 1)``: the more surplus ESS, the harder it thins."""

    ess_target: Optional[float] = None
    floor: float = 0.1

    def __post_init__(self):
        if not 0.0 < self.floor <= 1.0:
            raise ValueError(
                f"adapt_scan floor must be in (0, 1], got {self.floor}")
        if self.ess_target is not None and self.ess_target <= 0:
            raise ValueError(
                f"adapt_scan ess_target must be > 0, got "
                f"{self.ess_target}")


def resolve_adapt_scan(request_adapt, monitor_spec,
                       env: Optional[str] = None):
    """The tenant's policy under ``GST_ADAPT_SCAN``: ``0`` disables every
    request, ``1`` arms every tenant whose monitor has an ESS target with
    the default spec, ``auto`` honours the request. Returns the
    :class:`AdaptScanSpec`, or None (full-rate scan)."""
    env = env if env is not None else adapt_scan_env()
    if env == "0":
        return None
    spec = request_adapt
    if spec is None and env == "1":
        if monitor_spec is None or monitor_spec.ess_target is None:
            return None          # nothing to measure convergence by
        spec = AdaptScanSpec()
    if spec is None:
        return None
    if not isinstance(spec, AdaptScanSpec):
        raise ValueError(
            f"adapt_scan must be a serve.adapt.AdaptScanSpec or None, "
            f"got {type(spec).__name__}")
    return spec


def param_blocks(param_idx, white_indices, hyper_indices) -> np.ndarray:
    """Each monitored parameter's conditional block: ``BLOCK_WHITE``,
    ``BLOCK_HYPER`` or ``-1`` (a column no thinnable block owns). Pure
    model structure (``ModelArrays.white_indices`` and
    ``hyper_indices``), computed once at admission."""
    w = {int(i) for i in np.asarray(white_indices).ravel()}
    h = {int(i) for i in np.asarray(hyper_indices).ravel()}
    out = np.full(len(param_idx), -1, int)
    for j, p in enumerate(np.asarray(param_idx, int)):
        if int(p) in w:
            out[j] = BLOCK_WHITE
        elif int(p) in h:
            out[j] = BLOCK_HYPER
    return out


def selection_probs(block_ess: Dict[int, float], ess_target: float,
                    floor: float) -> np.ndarray:
    """Per-block selection probabilities from the monitor's per-block min
    ESS: unconverged (or unmeasured) blocks stay at 1; a block whose ESS
    reached the target thins to ``clip(target / ess, floor, 1)``."""
    probs = np.ones(NBLOCKS, np.float64)
    for bi in THINNABLE:
        ess = block_ess.get(bi)
        if ess is None or not np.isfinite(ess) or ess < ess_target:
            continue
        probs[bi] = float(np.clip(ess_target / ess, floor, 1.0))
    return probs


def draw_gates(probs: np.ndarray, seed: int, tenant_id: int,
               sweep: int) -> np.ndarray:
    """One ``(NBLOCKS,)`` 0/1 float32 enable vector: independent Bernoulli
    draws from a host stream seeded by ``(seed, tenant, sweep)``, the JAX
    package's numbers exactly."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(tenant_id) & 0xFFFFFFFF,
         int(sweep) & 0xFFFFFFFF, 0xADA7]))
    u = rng.random(NBLOCKS)
    probs = np.asarray(probs, np.float64)
    return (u < probs).astype(np.float32)
