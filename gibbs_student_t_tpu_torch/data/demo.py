"""Demo dataset generator.

Produces a self-contained millisecond-pulsar par/tim pair with the same
*shape* as the reference's assets (reference J1713+0747.par:1-23,
J1713+0747.tim:1-132: ~5-yr span, ~14-day cadence, ~0.1 us errors, DD
binary) without copying them — all values are synthetic. Used by tests,
benchmarks, and the quickstart.
"""

from __future__ import annotations

import numpy as np

from gibbs_student_t_tpu_torch.data.par import Par, ParParam
from gibbs_student_t_tpu_torch.data.simulate import FakePulsar


def make_demo_par(name: str = "J0123+4567") -> Par:
    ld = np.longdouble
    entries = [
        ParParam("PSRJ", name),
        ParParam("RAJ", "01:23:45.6789012", 1, ld("1e-10")),
        ParParam("DECJ", "+45:06:07.8901", 1, ld("1e-10")),
        ParParam("F0", ld("245.4261196241850123"), 1, ld("1e-13")),
        ParParam("F1", ld("-5.382947318734e-16"), 1, ld("1e-21")),
        ParParam("PEPOCH", ld("53900")),
        ParParam("POSEPOCH", ld("53900")),
        ParParam("DMEPOCH", ld("53900")),
        ParParam("PMRA", ld("3.8214"), 1, ld("2e-3")),
        ParParam("PMDEC", ld("-2.1173"), 1, ld("3e-3")),
        ParParam("PX", ld("1.1032"), 1, ld("1e-2")),
        ParParam("SINI", ld("0.91347"), 1, ld("2e-3")),
        ParParam("BINARY", "DD"),
        ParParam("PB", ld("61.03128749217"), 1, ld("1e-9")),
        ParParam("T0", ld("52089.3726140"), 1, ld("8e-5")),
        ParParam("A1", ld("28.77139428"), 1, ld("2e-8")),
        ParParam("OM", ld("141.6542817"), 1, ld("4e-4")),
        ParParam("ECC", ld("6.118402e-05"), 1, ld("4e-10")),
        ParParam("M2", ld("0.25")),
        ParParam("EPHVER", "5"),
        ParParam("CLK", "UNCORR"),
        ParParam("MODE", ld("1")),
        ParParam("EPHEM", "DE421"),
    ]
    return Par({p.name: p for p in entries})


def make_demo_epochs(
    n: int = 130,
    mjd_start: float = 53000.0,
    cadence_days: float = 14.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Observation epochs: regular cadence with +-0.5 d observing jitter."""
    rng = rng or np.random.default_rng(0)
    base = mjd_start + cadence_days * np.arange(n)
    return np.asarray(
        np.asarray(base, dtype=np.longdouble)
        + np.asarray(rng.uniform(-0.5, 0.5, n), dtype=np.longdouble)
    )


def make_demo_fakepulsar(
    n: int = 130,
    error_us: float = 0.1,
    rng: np.random.Generator | None = None,
) -> FakePulsar:
    rng = rng or np.random.default_rng(0)
    par = make_demo_par()
    epochs = make_demo_epochs(n, rng=rng)
    return FakePulsar(par, epochs, np.full(n, error_us))


def make_contaminated_pulsar(
    n: int = 130,
    components: int = 30,
    theta: float = 0.05,
    sigma_out: float = 1e-6,
    seed: int = 42,
    A: float = 1e-14,
    gamma: float = 4.33,
    roundtrip_dir: str | None = None,
):
    """Demo pulsar with the reference simulator's noise regime
    (reference simulate_data.py:15-26): injected power-law red noise,
    white noise at the TOA errors, Bernoulli(theta) outliers at
    ``sigma_out``. Shared by the benchmark, the graft entry, and the test
    fixtures so they all exercise the same data regime.

    Returns ``(Pulsar, z_true)``. With ``roundtrip_dir`` the dataset is
    written to par/tim and re-read, exercising the full ingestion path.
    """
    from gibbs_student_t_tpu_torch.data.pulsar import Pulsar

    rng = np.random.default_rng(seed)
    fp = make_demo_fakepulsar(n=n, rng=rng)
    fp.add_rednoise(A, gamma, components=min(30, components), rng=rng)
    z = rng.random(fp.n) < theta
    sigma = np.where(z, sigma_out, fp.errors_us * 1e-6)
    fp.stoas = fp.stoas + np.asarray(
        sigma * rng.standard_normal(fp.n), dtype=np.longdouble) / 86400.0
    if roundtrip_dir is not None:
        fp.savepar(f"{roundtrip_dir}/demo.par")
        fp.savetim(f"{roundtrip_dir}/demo.tim")
        return Pulsar(f"{roundtrip_dir}/demo.par",
                      f"{roundtrip_dir}/demo.tim"), z
    return Pulsar(par=fp.par, tim=fp.to_tim()), z


def make_reference_pta(psr, components: int = 30):
    """The reference's simulated-data model (reference run_sims.py:57-76):
    constant efac=1, uniform equad, powerlaw red noise on ``components``
    Fourier pairs, SVD timing basis with flat prior."""
    from gibbs_student_t_tpu_torch.models import (
        Constant,
        EquadNoise,
        FourierBasisGP,
        MeasurementNoise,
        PTA,
        TimingModel,
        Uniform,
        powerlaw,
    )

    s = (MeasurementNoise(efac=Constant(1.0))
         + EquadNoise(Uniform(-10, -5))
         + FourierBasisGP(powerlaw(Uniform(-18, -12), Uniform(1, 7)),
                          components=components)
         + TimingModel())
    return PTA([s(psr)])


def make_demo_model_arrays(n: int = 130, components: int = 30,
                           theta: float = 0.05, seed: int = 42):
    """One-call frozen demo model (bench.py / __graft_entry__.py)."""
    psr, _ = make_contaminated_pulsar(n=n, components=components,
                                      theta=theta, seed=seed)
    return make_reference_pta(psr, components).frozen()
