"""SamplerBackend seam and chain containers.

The plugin boundary named by the north star (BASELINE.json): drivers select
a backend flag, and everything behind this interface is free to be host
code or a device kernel. The chain surface mirrors the seven
chain arrays of the reference (reference gibbs.py:344-350): ``chain``
(hyper/white params), ``bchain``, ``zchain``, ``thetachain``, ``alphachain``,
``poutchain``, ``dfchain`` — with a chain axis after the sweep axis in the
many-chain torch backend.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.models.pta import ModelArrays

#: ``ChainResult.stats`` keys that are run-level metadata rather than
#: per-sweep arrays: ``burn`` passes them through untouched and
#: ``select_pulsar`` reduces them instead of slicing a sweep axis.
#: ``n_toa`` is the per-pulsar real TOA count of a (padded) ensemble run;
#: ``n_reinits`` the cumulative diverged-chain re-inits; ``record_mode``
#: the recording mode the run used (so compact-transport quantization of
#: b/alpha/pout is discoverable downstream); ``record_thin`` the on-device
#: sweep-thinning factor (rows = every ``record_thin``-th sweep);
#: ``rhat``/``rhat_history``/``converged`` are ``sample_until``'s
#: convergence verdict (per-parameter / per-check, not per-sweep).
#: Keys under ``obs.telemetry.TELE_PREFIX`` (``tele_*``) are run-level
#: per-chain telemetry aggregates: ``burn`` passes them through like
#: META_STATS, and ``select_pulsar`` indexes their leading pulsar axis
#: (they are ``(npulsars, nchains)`` in ensemble results, not
#: ``(niter, ...)``).
META_STATS = ("n_toa", "n_reinits", "record_mode", "record_thin",
              "rhat", "rhat_history", "converged")

TELE_PREFIX = "tele_"


@dataclasses.dataclass
class ChainResult:
    """Sampled chains. Arrays are shaped ``(niter, ...)`` for single-chain
    backends and ``(niter, nchains, ...)`` for vmapped backends."""

    chain: np.ndarray        # parameter vectors
    bchain: np.ndarray       # basis coefficients
    zchain: np.ndarray       # outlier indicators
    thetachain: np.ndarray   # outlier fraction
    alphachain: np.ndarray   # per-TOA variance scales
    poutchain: np.ndarray    # per-TOA outlier probabilities
    dfchain: np.ndarray      # Student-t dof
    stats: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def burn(self, nburn: int) -> "ChainResult":
        """Drop burn-in samples (reference run_sims.py:118-124 drops 100).
        Per-sweep stats arrays are trimmed too so they stay aligned with
        the chains."""
        return ChainResult(
            **{
                f.name: getattr(self, f.name)[nburn:]
                for f in dataclasses.fields(self)
                if f.name not in ("stats",)
            },
            # per-sweep stats stay sweep-aligned; run-level metadata
            # (META_STATS, tele_* aggregates) passes through untouched
            stats={k: (v[nburn:] if np.ndim(v) and k not in META_STATS
                       and not k.startswith(TELE_PREFIX)
                       else v)
                   for k, v in self.stats.items()},
        )

    def select_pulsar(self, i: int) -> "ChainResult":
        """Slice one pulsar out of an ensemble result (arrays shaped
        ``(niter, npulsars, nchains, ...)``, parallel/ensemble.py) into
        the ordinary ``(niter, nchains, ...)`` form drivers save.

        A heterogeneous ensemble pads every pulsar's TOA axis to the
        maximum so the stacked arrays are rectangular; the per-pulsar
        real counts ride along as ``stats['n_toa']``, and the slice cuts
        the padded suffix back off the per-TOA chains here — saved trees
        are ``(niter, nchains, n_i)``, exactly the reference's per-pulsar
        layout (reference run_sims.py:118-124). A chain the run did not
        record (``record="light"``: empty) stays empty."""
        fields = {}
        for f in dataclasses.fields(self):
            if f.name != "stats":
                arr = getattr(self, f.name)
                fields[f.name] = arr[:, i] if arr.size else arr
        stats = {}
        for k, v in self.stats.items():
            if k.startswith(TELE_PREFIX):
                # (npulsars, nchains) per-chain aggregates -> (nchains,)
                stats[k] = v[i] if np.ndim(v) >= 2 else v
            elif k in META_STATS or np.ndim(v) < 2:
                stats[k] = v
            else:
                stats[k] = v[:, i]
        n_toa = self.stats.get("n_toa")
        if n_toa is not None:
            n_i = int(np.asarray(n_toa)[i])
            for name in ("zchain", "alphachain", "poutchain"):
                arr = fields[name]
                if arr.size and arr.shape[-1] > n_i:
                    fields[name] = arr[..., :n_i]
            stats["n_toa"] = np.asarray(n_i)
        return ChainResult(**fields, stats=stats)

    def save(self, outdir: str) -> None:
        """Persist in the reference's on-disk layout
        (reference run_sims.py:118-124)."""
        import os

        os.makedirs(outdir, exist_ok=True)
        for name in ("chain", "bchain", "zchain", "poutchain",
                     "thetachain", "alphachain", "dfchain"):
            np.save(os.path.join(outdir, f"{name}.npy"), getattr(self, name))

    def acceptance_rates(self) -> Dict[str, np.ndarray]:
        """Per-MH-block acceptance arrays present in ``stats`` — the one
        place the block list lives, shared by every driver's
        observability output (bench.py, run_sims.py)."""
        out = {}
        for blk in ("white", "hyper"):
            acc = np.asarray(self.stats.get(f"acc_{blk}", np.zeros(0)))
            if acc.size:
                out[blk] = acc
        return out


class SamplerBackend:
    """Common construction: a frozen model + config; subclasses implement
    ``sample``. ``supports_chains`` advertises a vmapped chain axis (and a
    ``nchains=`` constructor kwarg) so drivers can dispatch generically."""

    supports_chains = False

    def __init__(self, ma: ModelArrays, config: GibbsConfig):
        self.ma = ma
        self.config = config

    def sample(self, x0: np.ndarray, niter: int,
               seed: int = 0) -> ChainResult:
        raise NotImplementedError


def get_backend(name: str):
    """Resolve a backend by flag value (``run_sims --backend``): ``cpu`` or
    ``numpy`` the float64 NumPy oracle, ``torch`` the many-chain sampler
    (the JAX package's ``jax``/``tpu``)."""
    from gibbs_student_t_tpu_torch.backends.numpy_backend import NumpyGibbs
    from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs

    table = {"cpu": NumpyGibbs, "numpy": NumpyGibbs, "torch": TorchGibbs}
    if name not in table:
        raise ValueError(f"unknown backend {name!r}; options: {sorted(table)}")
    return table[name]
