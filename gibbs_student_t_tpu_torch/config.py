"""Configuration dataclasses for the sampler.

The reference spreads configuration across constructor kwargs
(reference gibbs.py:9-11) and hard-coded constants in the drivers
(reference run_sims.py:32-35, 57-76) with the MH step-size table duplicated
inline in two methods (reference gibbs.py:92-94, 125-127). Here every knob is
a frozen dataclass so configs hash, print, and thread through jit as static
arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Likelihood families of the reference (gibbs.py:50, 187-189, 206-208):
#   gaussian : plain Gaussian likelihood, z == 0 throughout
#   t        : Student-t via per-TOA auxiliary inverse-gamma scales, z == 1
#   mixture  : Gaussian/Gaussian outlier mixture with Bernoulli indicators
#   vvh17    : Vallisneri & van Haasteren (2017) uniform-in-phase outlier model
MODELS = ("gaussian", "t", "mixture", "vvh17")

THETA_PRIORS = ("beta", "uniform")


@dataclasses.dataclass(frozen=True)
class MHConfig:
    """Random-walk Metropolis jump kernel shared by the white and hyper blocks.

    Mirrors the jump structure of reference gibbs.py:88-97 and 121-130: a
    scale drawn from a discrete mixture, one uniformly-chosen coordinate per
    step, sigma proportional to the size of the parameter group.
    """

    n_white_steps: int = 20       # reference gibbs.py:121
    n_hyper_steps: int = 10       # reference gibbs.py:88
    sigma_per_param: float = 0.05  # reference gibbs.py:92,125
    scale_sizes: Tuple[float, ...] = (0.1, 0.5, 1.0, 3.0, 10.0)
    scale_probs: Tuple[float, ...] = (0.1, 0.15, 0.5, 0.15, 0.1)
    # Opt-in Robbins-Monro step-size adaptation (JAX backend): for the
    # first ``adapt_until`` sweeps, each chain's per-block log jump scale
    # moves by eta_t * (acc - target_accept), eta_t = (t+1)^-adapt_decay,
    # then freezes — the chain is ordinary (valid) MH from that sweep on,
    # so set burn >= adapt_until when analyzing. The reference's fixed
    # scales (gibbs.py:92-94,125-127) sit at ~0.95 white acceptance on
    # the flagship model — far above the ~0.44 optimum for
    # one-coordinate random-walk MH — so adaptation buys mixing speed
    # without touching the model. 0 (default) reproduces the reference's
    # fixed-scale behavior exactly.
    adapt_until: int = 0
    target_accept: float = 0.44
    adapt_decay: float = 0.66
    # Opt-in population-covariance proposals (JAX backend, requires
    # adapt_until > 0): while adapting, the proposal direction becomes a
    # draw from the EMPIRICAL COVARIANCE of each coordinate block across
    # the chain population (re-estimated at chunk boundaries, shrunk
    # toward its diagonal, frozen together with the scales at
    # adapt_until). A thousand parallel chains make the estimate
    # essentially free and unbiased by single-chain autocorrelation —
    # an axis the reference's one-chain design cannot exploit. Joint
    # proposals target the multivariate RWM optimum (~0.234) instead of
    # the one-coordinate 0.44.
    adapt_cov: bool = False
    cov_target_accept: float = 0.234
    cov_shrinkage: float = 0.1
    # Opt-in multiple-try Metropolis (JAX backend): each MH step draws
    # ``mtm_tries`` iid candidates from the (symmetric) jump kernel,
    # selects one by importance weight (posterior density, Gumbel-max),
    # draws ``mtm_tries - 1`` reference points around the selected
    # candidate, and accepts on the weight-sum ratio (Liu, Liang & Wong
    # 2000, MTM(II) with w = pi). Trades (2K-1)x likelihood evaluations
    # per step for larger accepted moves — a fit for the fused kernels'
    # precomputed-draw shape where per-evaluation arithmetic is far
    # below the VPU roofline (docs/PERFORMANCE.md). 0 (default)
    # disables; values >= 2 run the XLA closure path (the fused
    # single-try Pallas kernels are bypassed while MTM is on).
    # ``mtm_blocks`` selects which MH blocks use MTM — the white block's
    # likelihood evaluations are cheap (elementwise) while the hyper
    # block's each pay a factorization, so the cost/benefit differs
    # sharply per block; the per-block A/B (tools/adapt_ess.py --mtm)
    # is what decides where in-kernel fusion would pay.
    mtm_tries: int = 0
    mtm_blocks: Tuple[str, ...] = ("white", "hyper")


@dataclasses.dataclass(frozen=True)
class GibbsConfig:
    """Model flags of the reference ``Gibbs.__init__`` (gibbs.py:9-51)."""

    model: str = "gaussian"
    tdf: int = 4                   # Student-t degrees of freedom (initial/fixed)
    outlier_mean: float = 0.01     # `m`, a-priori outlier probability
    vary_df: bool = True
    theta_prior: str = "beta"
    vary_alpha: bool = True
    alpha: float = 1e10            # fixed alpha when vary_alpha=False
    pspin: float | None = None     # spin period (s), needed by model='vvh17'
    df_max: int = 30               # df grid 1..df_max (reference gibbs.py:248)
    # Outlier-indicator initialization. "model" reproduces the reference
    # (gibbs.py:50-51: z starts at 1 for t/mixture/vvh17). "zeros" starts
    # the outlier models at z == 0 — in the dominant all-inlier posterior
    # mode. The reference init puts vvh17 (fixed alpha=1e10) into a
    # METASTABLE all-outlier mode on outlier-contaminated data: with every
    # TOA inflated by alpha, the coefficient draw is prior-dominated,
    # residuals are huge, p_in underflows, and q -> 1 keeps z pinned at 1
    # for O(10^3)+ sweeps until a red-noise-amplitude excursion lets the
    # unflagging cascade start (measured: NumPy oracle escapes at sweep
    # ~1700 (seed 3) or not within 8000 (seed 11); the f32 JAX kernel at
    # sweeps ~70-150). Both settle in the same good mode; "zeros" skips
    # the trap, which the distributional gates rely on (tools/j1713_gate).
    # Not meaningful for model='t', where z == 1 is structural (the
    # auxiliary-scale mixture representation, reference gibbs.py:206-208).
    z_init: str = "model"
    mh: MHConfig = dataclasses.field(default_factory=MHConfig)
    # Cholesky jitter added to Sigma's (preconditioned) diagonal. Plays the
    # role of the reference's SVD->QR fallback / -inf guard
    # (gibbs.py:168-178, 320-324) in branchless form.
    jitter: float = 1e-6

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"model must be one of {MODELS}, got {self.model!r}")
        if self.theta_prior not in THETA_PRIORS:
            raise ValueError(
                f"theta_prior must be one of {THETA_PRIORS}, got {self.theta_prior!r}"
            )
        if self.model == "vvh17" and self.pspin is None:
            raise ValueError("model='vvh17' requires pspin (spin period in s)")
        if self.z_init not in ("model", "zeros"):
            raise ValueError(
                f"z_init must be 'model' or 'zeros', got {self.z_init!r}")
        if self.z_init == "zeros" and self.model == "t":
            raise ValueError(
                "z_init='zeros' is invalid for model='t': z == 1 is "
                "structural there (every TOA carries an auxiliary "
                "inverse-gamma scale, reference gibbs.py:206-208), and "
                "update_z never redraws it")
        if self.mh.mtm_tries not in (0,) and self.mh.mtm_tries < 2:
            raise ValueError(
                f"MHConfig.mtm_tries must be 0 (off) or >= 2, got "
                f"{self.mh.mtm_tries}")
        if not set(self.mh.mtm_blocks) <= {"white", "hyper"}:
            raise ValueError(
                f"MHConfig.mtm_blocks must be a subset of "
                f"('white', 'hyper'), got {self.mh.mtm_blocks!r}")
        if self.mh.mtm_tries >= 2 and not self.mh.mtm_blocks:
            raise ValueError(
                "MHConfig.mtm_tries is set but mtm_blocks is empty — "
                "MTM would silently never run; select ('white',), "
                "('hyper',) or both")
        if self.mh.adapt_cov and self.mh.adapt_until <= 0:
            raise ValueError(
                "MHConfig.adapt_cov requires adapt_until > 0 (the "
                "population covariance is estimated while adapting and "
                "frozen at adapt_until)")

    def with_adapt(self, adapt_until: int,
                   adapt_cov: bool = False) -> "GibbsConfig":
        """This config with MH jump-scale adaptation for the first
        ``adapt_until`` sweeps (the drivers' ``--adapt`` flag; see
        MHConfig), optionally with population-covariance proposals
        (``--adapt-cov``). Shared so bench.py and run_sims.py cannot
        drift."""
        return dataclasses.replace(
            self, mh=dataclasses.replace(self.mh,
                                         adapt_until=adapt_until,
                                         adapt_cov=adapt_cov))

    def with_mtm(self, tries: int,
                 blocks: Tuple[str, ...] = ("white", "hyper"),
                 ) -> "GibbsConfig":
        """This config with multiple-try Metropolis proposals (the
        drivers' ``--mtm`` flag; see MHConfig.mtm_tries/mtm_blocks)."""
        return dataclasses.replace(
            self, mh=dataclasses.replace(self.mh, mtm_tries=tries,
                                         mtm_blocks=tuple(blocks)))

    @property
    def is_outlier_model(self) -> bool:
        return self.model in ("mixture", "vvh17")

    @property
    def z_init_ones(self) -> bool:
        # reference gibbs.py:50-51: z starts at 1 for t/mixture/vvh17
        # (unless z_init='zeros' opts into the dominant-mode start)
        if self.z_init == "zeros":
            return False
        return self.model in ("t", "mixture", "vvh17")
