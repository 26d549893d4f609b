"""Sampling parameters: name / sample / logpdf objects.

The sampler-facing contract is the three-method seam the reference consumes
from ``enterprise.signals.parameter`` (reference gibbs.py:56-58,339;
run_sims.py:111): ``.name``, ``.sample()``, ``.get_logpdf(x)``. Families
cover the reference's usage (Uniform, Constant — reference run_sims.py:57-58,
67) plus Normal and LinearExp for model-building parity.

Each parameter also exposes a ``spec()`` 4-tuple ``(kind, a, b, init)`` so
the frozen model can evaluate all priors vectorized on device
(models/pta.py, backends/jax_backend.py).
"""

from __future__ import annotations

import numpy as np

# Integer prior kinds for the vectorized on-device lnprior.
KIND_UNIFORM = 0
KIND_NORMAL = 1
KIND_LINEAREXP = 2

_LN10 = float(np.log(10.0))


class Parameter:
    """Abstract sampled parameter."""

    def __init__(self, name: str = ""):
        self.name = name

    def with_name(self, name: str) -> "Parameter":
        clone = self.__class__.__new__(self.__class__)
        clone.__dict__.update(self.__dict__)
        clone.name = name
        return clone

    def sample(self, rng: np.random.Generator | None = None) -> float:
        raise NotImplementedError

    def get_logpdf(self, x: float) -> float:
        raise NotImplementedError

    def spec(self):
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.name!r})"


class Uniform(Parameter):
    def __init__(self, pmin: float, pmax: float, name: str = ""):
        super().__init__(name)
        self.pmin = float(pmin)
        self.pmax = float(pmax)

    def sample(self, rng=None) -> float:
        rng = rng or np.random.default_rng()
        return float(rng.uniform(self.pmin, self.pmax))

    def get_logpdf(self, x: float) -> float:
        if self.pmin <= x <= self.pmax:
            return -float(np.log(self.pmax - self.pmin))
        return -np.inf

    def spec(self):
        return (KIND_UNIFORM, self.pmin, self.pmax,
                0.5 * (self.pmin + self.pmax))


class Normal(Parameter):
    def __init__(self, mu: float, sigma: float, name: str = ""):
        super().__init__(name)
        self.mu = float(mu)
        self.sigma = float(sigma)

    def sample(self, rng=None) -> float:
        rng = rng or np.random.default_rng()
        return float(rng.normal(self.mu, self.sigma))

    def get_logpdf(self, x: float) -> float:
        z = (x - self.mu) / self.sigma
        return float(-0.5 * z * z - np.log(self.sigma)
                     - 0.5 * np.log(2 * np.pi))

    def spec(self):
        return (KIND_NORMAL, self.mu, self.sigma, self.mu)


class LinearExp(Parameter):
    """Prior uniform in 10**x over [pmin, pmax] (enterprise's LinearExp)."""

    def __init__(self, pmin: float, pmax: float, name: str = ""):
        super().__init__(name)
        self.pmin = float(pmin)
        self.pmax = float(pmax)

    def sample(self, rng=None) -> float:
        rng = rng or np.random.default_rng()
        u = rng.uniform(10 ** self.pmin, 10 ** self.pmax)
        return float(np.log10(u))

    def get_logpdf(self, x: float) -> float:
        if self.pmin <= x <= self.pmax:
            return float(x * _LN10
                         + np.log(_LN10 / (10 ** self.pmax - 10 ** self.pmin)))
        return -np.inf

    def spec(self):
        return (KIND_LINEAREXP, self.pmin, self.pmax,
                0.5 * (self.pmin + self.pmax))


class Constant:
    """Fixed model value; not part of the sampled vector (mirrors
    ``enterprise.signals.parameter.Constant``, reference run_sims.py:57)."""

    def __init__(self, value: float, name: str = ""):
        self.value = float(value)
        self.name = name

    def __repr__(self) -> str:
        return f"Constant({self.value})"


def lnprior_specs(specs, x, xp=np):
    """Vectorized lnprior over a spec table (kind, a, b, init), written
    once for both backends: ``xp`` is ``numpy`` on the host oracle path and
    ``jax.numpy`` inside the jitted kernel. Returns per-parameter logpdfs;
    callers sum."""
    kind = specs[:, 0].astype(int)
    a, b = specs[:, 1], specs[:, 2]
    out = xp.full(x.shape, -xp.inf)
    inb = (x >= a) & (x <= b)
    u = kind == KIND_UNIFORM
    out = xp.where(u & inb, -xp.log(xp.where(u, b - a, 1.0)), out)
    nrm = kind == KIND_NORMAL
    z = (x - a) / xp.where(nrm, b, 1.0)
    out = xp.where(nrm, -0.5 * z * z - xp.log(xp.where(nrm, b, 1.0))
                   - 0.5 * np.log(2 * np.pi), out)
    lexp = kind == KIND_LINEAREXP
    denom = xp.where(lexp, 10.0 ** b - 10.0 ** a, 1.0)
    out = xp.where(lexp & inb, x * _LN10 + xp.log(_LN10 / denom), out)
    return out
