"""PTA: the model seam, and ModelArrays: its frozen device-ready form.

The reference sampler consumes its entire model through six calls on an
``enterprise`` PTA object (SURVEY.md §1 L3->L4; reference gibbs.py:29,
154-161, 209-210, 235-236, 268-269, 297-304):

    pta.get_residuals()[0]         -> y      (n,)
    pta.get_basis(params)[0]       -> T      (n, m)
    pta.get_ndiag(params)[0]       -> Nvec0  (n,)
    pta.get_phiinv(params, logdet) -> phiinv (m,) [+ logdet]
    pta.params                     -> parameter objects (name/sample/logpdf)

:class:`PTA` reproduces that contract on our first-party signal layer; its
``freeze()`` produces :class:`ModelArrays` — plain arrays plus static
metadata. The array-namespace-generic functions below take ``xp=numpy``
on the host; the torch sampler evaluates the same formulas on batched
device tensors (backends/torch_backend.py).

Freezing applies a global time rescale (default: seconds -> microseconds).
The reference works in seconds, where white variances are ~1e-14 and
prior precisions span ~40 decades; in microseconds every quantity lands
within float32 range, which is what makes the float32 device path viable
(SURVEY.md §7 "hard parts: float64").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gibbs_student_t_tpu_torch.models.parameter import Constant, Parameter, lnprior_specs
from gibbs_student_t_tpu_torch.models.signals import (
    ConstPhi,
    EcorrPhi,
    FYR,
    ImproperPhi,
    PowerlawPhi,
    SignalModel,
)

LN10 = float(np.log(10.0))


# ---------------------------------------------------------------------------
# Frozen phi blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PowerlawBlock:
    start: int
    stop: int
    freqs: np.ndarray        # (k,) per-column frequencies
    df: float
    idx_log10A: int          # index into x, or -1 if constant
    const_log10A: float
    idx_gamma: int
    const_gamma: float


@dataclasses.dataclass(frozen=True)
class EcorrBlock:
    start: int
    stop: int
    col_group: Tuple[int, ...]   # group per column
    idx: Tuple[int, ...]         # index into x or -1, per group
    const: np.ndarray            # (G,) log10 values for constants


@dataclasses.dataclass(frozen=True)
class ImproperBlock:
    start: int
    stop: int


@dataclasses.dataclass(frozen=True)
class ConstBlock:
    start: int
    stop: int
    phi: np.ndarray          # (k,) fixed scaled variances


# ---------------------------------------------------------------------------
# ModelArrays
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ModelArrays:
    """One pulsar's frozen model. All times scaled by ``time_scale``
    (variances by ``time_scale**2``); parameters keep their reference
    semantics (e.g. log10_equad is still log10 *seconds*)."""

    name: str
    y: np.ndarray                    # (n,) scaled residuals
    T: np.ndarray                    # (n, m) combined basis
    sigma2: np.ndarray               # (n,) scaled toaerr^2
    efac_masks: np.ndarray           # (Ge, n)
    efac_idx: Tuple[int, ...]        # per group, -1 => constant
    efac_const: np.ndarray           # (Ge,)
    equad_masks: np.ndarray          # (Gq, n)
    equad_idx: Tuple[int, ...]
    equad_const: np.ndarray          # log10 seconds
    phi_blocks: Tuple
    param_names: Tuple[str, ...]
    prior_specs: np.ndarray          # (p, 4) kind/a/b/init
    # (n,) bool: True for real TOA rows, False for suffix padding rows
    # added by parallel.ensemble.pad_model_arrays so heterogeneous
    # per-pulsar TOA counts can stack. None means every row is real.
    row_mask: Optional[np.ndarray] = None
    time_scale: float = 1e6

    @property
    def n(self) -> int:
        return self.y.shape[0]

    @property
    def m(self) -> int:
        return self.T.shape[1]

    @property
    def nparam(self) -> int:
        return len(self.param_names)

    # Substring-based index groups, the reference's coordinate-block
    # convention (reference gibbs.py:64-77).
    def _match(self, subs) -> np.ndarray:
        return np.array(
            [i for i, nm in enumerate(self.param_names)
             if any(s in nm for s in subs)],
            dtype=int,
        )

    @property
    def hyper_indices(self) -> np.ndarray:
        return self._match(("ecorr", "log10_A", "gamma"))

    @property
    def white_indices(self) -> np.ndarray:
        return self._match(("efac", "equad"))

    @property
    def specs_np(self) -> np.ndarray:
        return np.asarray(self.prior_specs)

    def x_init(self, rng: np.random.Generator | None = None) -> np.ndarray:
        """Draw x0 from the priors (reference run_sims.py:111)."""
        rng = rng or np.random.default_rng()
        specs = self.specs_np
        kind = specs[:, 0].astype(int)
        a, b = specs[:, 1], specs[:, 2]
        u = rng.uniform(size=self.nparam)
        x = np.where(kind == 1, a + b * rng.standard_normal(self.nparam),
                     a + (b - a) * u)
        return np.asarray(x, dtype=np.float64)


# --- xp-generic evaluation --------------------------------------------------

def _pval(x, idx, const, xp):
    """Parameter-or-constant lookup, batched-safe: value of x[idx] where
    idx >= 0 else const."""
    idx = xp.asarray(idx)
    safe = xp.clip(idx, 0, None)
    return xp.where(idx >= 0, x[safe], xp.asarray(const))


def ndiag(ma: ModelArrays, x, xp=np):
    """White-noise variances Nvec0(x) (scaled), the get_ndiag seam
    (reference gibbs.py:154,209,235,268,297): sum over selection groups of
    (efac*sigma)^2 plus 10^(2 log10_equad)."""
    efac = _pval(x, ma.efac_idx, ma.efac_const, xp)
    nv = (efac[:, None] ** 2 * ma.efac_masks * ma.sigma2[None, :]).sum(axis=0)
    if len(ma.equad_idx):
        equad = _pval(x, ma.equad_idx, ma.equad_const, xp)
        scaled = 10.0 ** (2.0 * equad) * ma.time_scale ** 2
        nv = nv + (scaled[:, None] * ma.equad_masks).sum(axis=0)
    return nv


def static_phi_columns(ma: ModelArrays) -> np.ndarray:
    """Boolean mask over the m basis columns whose prior precision does
    not depend on the sampled parameter vector: improper/constant blocks,
    plus powerlaw/ecorr blocks pinned to constants. These columns keep
    the same ``Sigma`` contribution across every hyper-MH proposal in a
    sweep, so the hyper block can Schur-eliminate them once per sweep
    and factor only the varying columns per evaluation
    (backends/torch_backend.py)."""
    mask = np.zeros(ma.m, dtype=bool)
    for blk in ma.phi_blocks:
        if isinstance(blk, (ImproperBlock, ConstBlock)):
            mask[blk.start:blk.stop] = True
        elif isinstance(blk, PowerlawBlock):
            if blk.idx_log10A < 0 and blk.idx_gamma < 0:
                mask[blk.start:blk.stop] = True
        elif isinstance(blk, EcorrBlock):
            if all(i < 0 for i in blk.idx):
                mask[blk.start:blk.stop] = True
    return mask


def phiinv_logdet(ma: ModelArrays, x, xp=np):
    """Prior precision diag phi^-1(x) (scaled) and logdet phi, the
    get_phiinv seam (reference gibbs.py:155,298). Improper (timing) blocks
    contribute exactly zero to both (see signals.ImproperPhi)."""
    pieces = []
    logdet = xp.asarray(0.0)
    s2 = ma.time_scale ** 2
    for blk in ma.phi_blocks:
        k = blk.stop - blk.start
        if isinstance(blk, ImproperBlock):
            pieces.append(xp.zeros(k))
        elif isinstance(blk, ConstBlock):
            phi = xp.asarray(blk.phi)
            pieces.append(1.0 / phi)
            logdet = logdet + xp.sum(xp.log(phi))
        elif isinstance(blk, PowerlawBlock):
            log10A = (x[blk.idx_log10A] if blk.idx_log10A >= 0
                      else blk.const_log10A)
            gamma = (x[blk.idx_gamma] if blk.idx_gamma >= 0
                     else blk.const_gamma)
            # log phi to keep the full dynamic range; exponentiate the
            # *negative* for phiinv.
            logphi = (2.0 * log10A * LN10
                      - np.log(12.0 * np.pi ** 2)
                      + (gamma - 3.0) * np.log(FYR)
                      - gamma * xp.log(xp.asarray(blk.freqs))
                      + xp.log(xp.asarray(blk.df)) + np.log(s2))
            pieces.append(xp.exp(-logphi))
            logdet = logdet + xp.sum(logphi)
        elif isinstance(blk, EcorrBlock):
            ec = _pval(x, blk.idx, blk.const, xp)
            logphi_g = 2.0 * ec * LN10 + np.log(s2)
            logphi = logphi_g[xp.asarray(blk.col_group)]
            pieces.append(xp.exp(-logphi))
            logdet = logdet + xp.sum(logphi)
        else:  # pragma: no cover
            raise TypeError(f"unknown phi block {type(blk)}")
    if not pieces:
        return xp.zeros(0), logdet
    return xp.concatenate(pieces), logdet


def lnprior(ma: ModelArrays, x, xp=np):
    """Sum of parameter log-priors, the get_lnprior seam
    (reference gibbs.py:337-339). Single xp-generic implementation shared
    by the oracle and the jitted kernel."""
    return xp.sum(lnprior_specs(xp.asarray(ma.prior_specs), x, xp))


# ---------------------------------------------------------------------------
# PTA
# ---------------------------------------------------------------------------

class PTA:
    """Aggregate of per-pulsar :class:`SignalModel`s exposing the reference
    sampler's six-call contract (reference run_sims.py:83)."""

    def __init__(self, models: Sequence[SignalModel], time_scale: float = 1e6):
        self.models = list(models)
        self.time_scale = time_scale
        self._frozen: List[ModelArrays] | None = None

    @property
    def params(self) -> List[Parameter]:
        seen: Dict[str, Parameter] = {}
        for model in self.models:
            for p in model.params:
                seen.setdefault(p.name, p)
        return [seen[k] for k in sorted(seen)]

    @property
    def param_names(self) -> List[str]:
        return [p.name for p in self.params]

    def map_params(self, xs) -> Dict[str, float]:
        return {p.name: x for p, x in zip(self.params, xs)}

    # -- freezing -----------------------------------------------------------

    def freeze(self) -> List[ModelArrays]:
        if self._frozen is None:
            order = {nm: i for i, nm in enumerate(self.param_names)}
            self._frozen = [
                _freeze_model(model, order, self.param_names, self.params,
                              self.time_scale)
                for model in self.models
            ]
        return self._frozen

    def frozen(self, idx: int = 0) -> ModelArrays:
        return self.freeze()[idx]

    # -- the six-call seam (host-side, reference units: seconds) ------------

    def _x(self, params: Dict[str, float]) -> np.ndarray:
        return np.array([params[nm] for nm in self.param_names])

    def get_residuals(self):
        return [m.psr.residuals for m in self.models]

    def get_basis(self, params=None):
        return [ma.T for ma in self.freeze()]

    def get_ndiag(self, params: Dict[str, float]):
        x = self._x(params)
        s2 = self.time_scale ** 2
        return [ndiag(ma, x, np) / s2 for ma in self.freeze()]

    def get_phiinv(self, params: Dict[str, float], logdet: bool = False):
        x = self._x(params)
        s2 = self.time_scale ** 2
        out = []
        for ma in self.freeze():
            pinv, ld = phiinv_logdet(ma, x, np)
            # unscale: phi_s2 = phi_scaled / s2 -> phiinv_s2 = phiinv * s2;
            # logdet in seconds^2 units drops the m*log(s2) offset, but only
            # over proper (finite-prior) columns.
            nfinite = sum(
                blk.stop - blk.start for blk in ma.phi_blocks
                if not isinstance(blk, ImproperBlock)
            )
            if logdet:
                out.append((pinv * s2, ld - nfinite * np.log(s2)))
            else:
                out.append(pinv * s2)
        return out

    def get_lnprior(self, xs) -> float:
        return float(sum(p.get_logpdf(x) for p, x in zip(self.params, xs)))


def _freeze_model(model: SignalModel, order: Dict[str, int],
                  all_names: List[str], all_params: List[Parameter],
                  time_scale: float) -> ModelArrays:
    psr = model.psr
    scale2 = time_scale ** 2

    def pidx(p) -> Tuple[int, float]:
        if isinstance(p, Constant):
            return -1, p.value
        return order[p.name], 0.0

    efac_masks, efac_idx, efac_const = [], [], []
    equad_masks, equad_idx, equad_const = [], [], []
    bases, blocks = [], []
    col = 0
    for inst in model.instances:
        for kind, mask, p in inst.white_specs():
            i, c = pidx(p)
            if kind == "efac":
                efac_masks.append(mask)
                efac_idx.append(i)
                efac_const.append(c)
            else:
                equad_masks.append(mask)
                equad_idx.append(i)
                equad_const.append(c)
        bb = inst.basis_block()
        if bb is None:
            continue
        basis, spec = bb
        k = basis.shape[1]
        start, stop = col, col + k
        col = stop
        bases.append(basis)
        if isinstance(spec, PowerlawPhi):
            ia, ca = pidx(spec.log10_A)
            ig, cg = pidx(spec.gamma)
            blocks.append(PowerlawBlock(start, stop, spec.freqs, spec.df,
                                        ia, ca, ig, cg))
        elif isinstance(spec, EcorrPhi):
            idx, const = [], []
            for p in spec.params:
                i, c = pidx(p)
                idx.append(i)
                const.append(c)
            blocks.append(EcorrBlock(start, stop,
                                     tuple(int(g) for g in spec.col_group),
                                     tuple(idx), np.asarray(const)))
        elif isinstance(spec, ImproperPhi):
            blocks.append(ImproperBlock(start, stop))
        elif isinstance(spec, ConstPhi):
            blocks.append(ConstBlock(start, stop, spec.phi * scale2))
        else:  # pragma: no cover
            raise TypeError(f"unknown phi spec {type(spec)}")

    # An efac-free model leaves raw radiometer noise out of N (enterprise
    # semantics); guard against that foot-gun by adding a unit-efac group.
    if not efac_masks:
        efac_masks.append(np.ones(psr.n))
        efac_idx.append(-1)
        efac_const.append(1.0)

    T = (np.concatenate(bases, axis=1) if bases
         else np.zeros((psr.n, 0)))
    specs = np.array([p.spec() for p in all_params], dtype=np.float64)
    if specs.size == 0:
        specs = np.zeros((0, 4))

    return ModelArrays(
        name=psr.name,
        y=psr.residuals * time_scale,
        T=T,
        sigma2=psr.toaerrs ** 2 * scale2,
        efac_masks=np.asarray(efac_masks),
        efac_idx=tuple(efac_idx),
        efac_const=np.asarray(efac_const),
        equad_masks=(np.asarray(equad_masks) if equad_masks
                     else np.zeros((0, psr.n))),
        equad_idx=tuple(equad_idx),
        equad_const=np.asarray(equad_const),
        phi_blocks=tuple(blocks),
        param_names=tuple(all_names),
        prior_specs=specs,
        time_scale=time_scale,
    )
