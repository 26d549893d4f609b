"""Signal algebra: white-noise and basis-GP building blocks.

First-party replacement for the ``enterprise.signals`` surface the reference
builds its model from (reference run_sims.py:57-76; notebook cell 2):
``MeasurementNoise`` (efac), ``EquadNoise``, ``EcorrBasisModel``,
``FourierBasisGP``, ``BasisGP``/``TimingModel``, ``Selection``, and the
``powerlaw`` spectrum. Templates compose with ``+`` and are instantiated on
a :class:`~gibbs_student_t_tpu_torch.data.pulsar.Pulsar`, exactly like the
reference's ``s = ef + eq + rn + tm; s(psr)`` idiom.

Bases in scope are parameter-independent (Fourier, SVD timing, ecorr
quantization), so each instance exposes a static ``basis`` plus a *phi
spec* — a typed description of how its prior variances depend on sampled
parameters — that the freeze step (models/pta.py) turns into device arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from gibbs_student_t_tpu_torch.data.pulsar import Pulsar
from gibbs_student_t_tpu_torch.models.parameter import Constant, Parameter, Uniform

FYR = 1.0 / (365.25 * 86400.0)


# ---------------------------------------------------------------------------
# Selections
# ---------------------------------------------------------------------------

class Selection:
    """Partition of TOAs into named groups, each with its own noise
    parameter instance (mirrors ``enterprise.signals.selections``,
    reference run_sims.py:61)."""

    def __init__(self, fn: Callable[[Pulsar], Dict[str, np.ndarray]]):
        self.fn = fn

    def __call__(self, psr: Pulsar) -> Dict[str, np.ndarray]:
        return self.fn(psr)


def no_selection(psr: Pulsar) -> Dict[str, np.ndarray]:
    return {"": np.ones(psr.n, dtype=bool)}


def by_backend(psr: Pulsar) -> Dict[str, np.ndarray]:
    groups: Dict[str, np.ndarray] = {}
    backends = np.asarray(psr.backend_flags)
    for be in sorted(set(backends.tolist())):
        groups[str(be)] = backends == be
    return groups


def _named(psr_name: str, group: str, suffix: str) -> str:
    parts = [psr_name] + ([group] if group else []) + [suffix]
    return "_".join(parts)


# ---------------------------------------------------------------------------
# Phi specs — typed prior-variance descriptions consumed by the freeze step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PowerlawPhi:
    """phi_k = A^2/(12 pi^2) * fyr^(gamma-3) * f_k^-gamma * df  (seconds^2),
    the standard PTA powerlaw convention (reference run_sims.py:67)."""
    freqs: np.ndarray          # per-column frequency (each f repeated sin/cos)
    df: float                  # frequency bin width 1/T_span
    log10_A: object            # Parameter or Constant
    gamma: object


@dataclasses.dataclass
class EcorrPhi:
    """phi_col = 10^(2*log10_ecorr_g(col)) (seconds^2) for epoch-averaged
    white noise (notebook cell 2's EcorrBasisModel)."""
    col_group: np.ndarray      # (k,) int — group index per basis column
    params: List[object]       # per-group Parameter or Constant (log10 s)


@dataclasses.dataclass
class ImproperPhi:
    """Flat (improper) prior on the block: phi -> infinity, phiinv = 0 and no
    logdet contribution. Exact-limit form of the reference's 1e40 timing
    prior (reference run_sims.py:27-29) — the 1e-40 precision and constant
    logdet of the reference affect the posterior by strictly nothing, and
    the exact limit is what makes float32 viable on TPU (SURVEY.md §7)."""


@dataclasses.dataclass
class ConstPhi:
    """Fixed prior variances (BasisGP with a constant prior function)."""
    phi: np.ndarray


# ---------------------------------------------------------------------------
# Signal instances
# ---------------------------------------------------------------------------

class SignalInstance:
    params: List[Parameter]

    # white-noise pieces: list of (kind, mask, Parameter|Constant)
    def white_specs(self) -> List:
        return []

    # basis piece: (basis (n,k), phi spec) or None
    def basis_block(self):
        return None


class _WhiteInstance(SignalInstance):
    def __init__(self, kind: str, psr: Pulsar, param_tpl, selection: Selection,
                 suffix: str):
        self.kind = kind
        self.params = []
        self._specs = []
        for group, mask in selection(psr).items():
            name = _named(psr.name, group, suffix)
            if isinstance(param_tpl, Constant):
                p = Constant(param_tpl.value, name)
            else:
                p = param_tpl.with_name(name)
                self.params.append(p)
            self._specs.append((kind, mask.astype(np.float64), p))

    def white_specs(self):
        return self._specs


class _BasisInstance(SignalInstance):
    def __init__(self, basis: np.ndarray, phi_spec, params: List[Parameter]):
        self.basis = basis
        self.phi_spec = phi_spec
        self.params = params

    def basis_block(self):
        return (self.basis, self.phi_spec)


# ---------------------------------------------------------------------------
# Signal templates (user-facing constructors)
# ---------------------------------------------------------------------------

class SignalTemplate:
    def __call__(self, psr: Pulsar) -> SignalInstance:
        raise NotImplementedError

    def __add__(self, other) -> "SignalCollection":
        return SignalCollection([self]) + other


class SignalCollection(SignalTemplate):
    def __init__(self, templates: Sequence[SignalTemplate]):
        self.templates = list(templates)

    def __add__(self, other):
        if isinstance(other, SignalCollection):
            return SignalCollection(self.templates + other.templates)
        return SignalCollection(self.templates + [other])

    def __call__(self, psr: Pulsar) -> "SignalModel":
        return SignalModel([t(psr) for t in self.templates], psr)


class SignalModel:
    """All signal instances for one pulsar — the per-pulsar model object
    aggregated by :class:`~gibbs_student_t_tpu_torch.models.pta.PTA`."""

    def __init__(self, instances: List[SignalInstance], psr: Pulsar):
        self.instances = instances
        self.psr = psr

    @property
    def params(self) -> List[Parameter]:
        out = []
        for inst in self.instances:
            out.extend(inst.params)
        return out


class MeasurementNoise(SignalTemplate):
    """N += (efac * toaerr)^2 per selection group (reference run_sims.py:63)."""

    def __init__(self, efac=None, selection: Optional[Selection] = None):
        self.efac = efac if efac is not None else Uniform(0.1, 10.0)
        self.selection = selection or Selection(no_selection)

    def __call__(self, psr: Pulsar):
        return _WhiteInstance("efac", psr, self.efac, self.selection, "efac")


class EquadNoise(SignalTemplate):
    """N += 10^(2*log10_equad) per selection group (reference run_sims.py:64)."""

    def __init__(self, log10_equad=None, selection: Optional[Selection] = None):
        self.log10_equad = (log10_equad if log10_equad is not None
                            else Uniform(-10.0, -5.0))
        self.selection = selection or Selection(no_selection)

    def __call__(self, psr: Pulsar):
        return _WhiteInstance("equad", psr, self.log10_equad, self.selection,
                              "log10_equad")


@dataclasses.dataclass
class PowerlawSpectrum:
    log10_A: object
    gamma: object


def powerlaw(log10_A=None, gamma=None) -> PowerlawSpectrum:
    """Powerlaw PSD factory (reference run_sims.py:67's ``utils.powerlaw``)."""
    return PowerlawSpectrum(
        log10_A if log10_A is not None else Uniform(-18.0, -12.0),
        gamma if gamma is not None else Uniform(0.0, 7.0),
    )


def fourier_basis(toas: np.ndarray, components: int):
    """Standard PTA Fourier design matrix: interleaved sin/cos pairs at
    f_k = k / T_span (enterprise's createfourierdesignmatrix_red)."""
    tspan = toas.max() - toas.min()
    k = np.arange(1, components + 1)
    f = k / tspan
    arg = 2 * np.pi * f[None, :] * (toas - toas.min())[:, None]
    F = np.empty((len(toas), 2 * components))
    F[:, 0::2] = np.sin(arg)
    F[:, 1::2] = np.cos(arg)
    return F, np.repeat(f, 2), 1.0 / tspan


class FourierBasisGP(SignalTemplate):
    """Fourier-basis Gaussian process with a parametrized spectrum
    (reference run_sims.py:68)."""

    def __init__(self, spectrum: PowerlawSpectrum, components: int = 30,
                 name: str = "red_noise"):
        self.spectrum = spectrum
        self.components = components
        self.name = name

    def __call__(self, psr: Pulsar):
        F, freqs, df = fourier_basis(psr.toas, self.components)
        params = []

        def bind(p, suffix):
            if isinstance(p, Constant):
                return Constant(p.value, _named(psr.name, self.name, suffix))
            bound = p.with_name(_named(psr.name, self.name, suffix))
            params.append(bound)
            return bound

        spec = PowerlawPhi(
            freqs=freqs,
            df=df,
            log10_A=bind(self.spectrum.log10_A, "log10_A"),
            gamma=bind(self.spectrum.gamma, "gamma"),
        )
        return _BasisInstance(F, spec, params)


def create_quantization_matrix(toas: np.ndarray, dt: float = 600.0,
                               nmin: int = 2):
    """Epoch quantization matrix U (n x n_epochs): U[i,j] = 1 iff TOA i falls
    in epoch j; epochs are runs of TOAs separated by < ``dt`` seconds, kept
    only when they contain >= ``nmin`` TOAs (enterprise's
    create_quantization_matrix semantics)."""
    isort = np.argsort(toas)
    groups = []
    current = [isort[0]]
    for idx in isort[1:]:
        if toas[idx] - toas[current[-1]] < dt:
            current.append(idx)
        else:
            groups.append(current)
            current = [idx]
    groups.append(current)
    groups = [g for g in groups if len(g) >= nmin]
    U = np.zeros((len(toas), len(groups)))
    for j, g in enumerate(groups):
        U[g, j] = 1.0
    epoch_toas = np.array([toas[g].mean() for g in groups])
    return U, epoch_toas


class EcorrBasisModel(SignalTemplate):
    """Epoch-correlated white noise as a basis GP over the quantization
    matrix (notebook cell 2). Each selection group gets its own
    ``log10_ecorr`` parameter applied to the epochs it owns."""

    def __init__(self, log10_ecorr=None, selection: Optional[Selection] = None,
                 dt: float = 600.0, nmin: int = 2):
        self.log10_ecorr = (log10_ecorr if log10_ecorr is not None
                            else Uniform(-10.0, -5.0))
        self.selection = selection or Selection(no_selection)
        self.dt = dt
        self.nmin = nmin

    def __call__(self, psr: Pulsar):
        groups = self.selection(psr)
        bases, col_group, bound = [], [], []
        params: List[Parameter] = []
        for gi, (gname, mask) in enumerate(groups.items()):
            if not mask.any():
                continue
            sub_toas = psr.toas[mask]
            U_sub, _ = create_quantization_matrix(sub_toas, self.dt, self.nmin)
            if U_sub.shape[1] == 0:
                continue
            U = np.zeros((psr.n, U_sub.shape[1]))
            U[np.flatnonzero(mask), :] = U_sub
            bases.append(U)
            col_group.extend([len(bound)] * U.shape[1])
            name = _named(psr.name, gname, "log10_ecorr")
            if isinstance(self.log10_ecorr, Constant):
                bound.append(Constant(self.log10_ecorr.value, name))
            else:
                p = self.log10_ecorr.with_name(name)
                params.append(p)
                bound.append(p)
        if not bases:
            basis = np.zeros((psr.n, 0))
            spec = EcorrPhi(np.zeros(0, dtype=int), [])
        else:
            basis = np.concatenate(bases, axis=1)
            spec = EcorrPhi(np.asarray(col_group, dtype=int), bound)
        return _BasisInstance(basis, spec, params)


# --- timing model ----------------------------------------------------------

def svd_tm_basis(Mmat: np.ndarray):
    """Left singular vectors of the timing design matrix, unit weights —
    numerically-conditioned timing basis (reference run_sims.py:22-25)."""
    u, s, _ = np.linalg.svd(Mmat, full_matrices=False)
    return u, np.ones_like(s)


def tm_prior(weights: np.ndarray):
    """Improper flat prior on timing coefficients. The reference uses
    ``weights * 1e40`` (run_sims.py:27-29); we take the exact limit (see
    :class:`ImproperPhi`)."""
    return ImproperPhi()


class BasisGP(SignalTemplate):
    """Generic fixed-basis GP: ``basis_fn(Mmat) -> (basis, weights)`` and
    ``prior_fn(weights) -> phi spec | array`` (reference run_sims.py:73)."""

    def __init__(self, prior_fn: Callable = tm_prior,
                 basis_fn: Callable = svd_tm_basis):
        self.prior_fn = prior_fn
        self.basis_fn = basis_fn

    def __call__(self, psr: Pulsar):
        basis, weights = self.basis_fn(psr.Mmat)
        spec = self.prior_fn(weights)
        if isinstance(spec, np.ndarray):
            spec = ConstPhi(spec)
        return _BasisInstance(basis, spec, [])


def TimingModel() -> BasisGP:
    """SVD-basis timing model with improper flat prior (notebook cell 2)."""
    return BasisGP(tm_prior, svd_tm_basis)
