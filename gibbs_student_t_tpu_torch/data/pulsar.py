"""Pulsar: the ingestion object the model layer consumes.

First-party equivalent of ``enterprise.pulsar.Pulsar`` (reference
run_sims.py:47,51; notebook cell 1): parses par/tim, forms prefit residuals
from the longdouble phase model, performs the weighted linear fit that
tempo2 would do (the reference's data are always loaded post-fit), and
exposes the NumPy arrays the signal layer needs: ``toas`` (s), ``residuals``
(s), ``toaerrs`` (s), ``freqs`` (MHz), ``flags``, ``Mmat``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from gibbs_student_t_tpu_torch.data.par import Par, read_par
from gibbs_student_t_tpu_torch.data.tim import TimFile, read_tim
from gibbs_student_t_tpu_torch.data.timing_model import (
    SECS_PER_DAY,
    design_matrix,
    prefit_residuals,
)


class Pulsar:
    def __init__(
        self,
        parfile: Optional[str] = None,
        timfile: Optional[str] = None,
        *,
        par: Optional[Par] = None,
        tim: Optional[TimFile] = None,
        fit: bool = True,
        sort: bool = True,
    ):
        if par is None:
            if parfile is None:
                raise ValueError("need parfile or par")
            par = read_par(parfile)
        if tim is None:
            if timfile is None:
                raise ValueError("need timfile or tim")
            tim = read_tim(timfile)

        self.par = par
        self.name = par.name

        order = np.argsort(tim.mjds) if sort else np.arange(tim.n)
        self._mjds = tim.mjds[order]                       # longdouble days
        self.toas = np.asarray(self._mjds * SECS_PER_DAY, dtype=np.float64)
        self.toaerrs = tim.errors[order] * 1e-6            # us -> seconds
        self.freqs = tim.freqs[order]
        self.flags: Dict[str, np.ndarray] = {
            k: v[order] for k, v in tim.flags.items()
        }
        self.backend_flags = self.flags.get(
            "f", np.array([tim.sites[i] for i in order], dtype=object)
        )

        self.Mmat, self.fitpars = design_matrix(par, self._mjds)

        resid = prefit_residuals(par, self._mjds)
        if fit:
            resid = self._wls_fit(resid)
        self.residuals = resid

    def _wls_fit(self, resid: np.ndarray) -> np.ndarray:
        """Weighted least-squares removal of the linearized timing model —
        the role of tempo2's fit (reference simulate_data.py:12)."""
        w = 1.0 / self.toaerrs
        A = self.Mmat * w[:, None]
        beta, *_ = np.linalg.lstsq(A, resid * w, rcond=None)
        return resid - self.Mmat @ beta

    @property
    def n(self) -> int:
        return len(self.toas)

    def __repr__(self) -> str:
        return f"Pulsar({self.name!r}, n={self.n})"


def load_pulsars(pairs: List) -> List[Pulsar]:
    """Load a list of (parfile, timfile) pairs."""
    return [Pulsar(parfile, timfile) for parfile, timfile in pairs]
