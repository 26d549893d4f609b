"""Model layer: parameters, signal algebra, the PTA seam, frozen arrays.

First-party replacement for the slice of ``enterprise`` the reference
consumes (SURVEY.md §1 L3->L4, §2.2): parameter objects, white-noise and
basis-GP signals, and a ``PTA`` object exposing exactly the six-call
contract the sampler uses — plus ``ModelArrays``, the device-ready frozen
bundle the torch backend runs on.
"""

from gibbs_student_t_tpu_torch.models.parameter import (
    Constant,
    LinearExp,
    Normal,
    Uniform,
)
from gibbs_student_t_tpu_torch.models.signals import (
    BasisGP,
    EcorrBasisModel,
    EquadNoise,
    FourierBasisGP,
    MeasurementNoise,
    Selection,
    TimingModel,
    by_backend,
    no_selection,
    powerlaw,
    svd_tm_basis,
    tm_prior,
)
from gibbs_student_t_tpu_torch.models.pta import PTA, ModelArrays

__all__ = [
    "Uniform", "Normal", "Constant", "LinearExp",
    "MeasurementNoise", "EquadNoise", "EcorrBasisModel", "FourierBasisGP",
    "BasisGP", "TimingModel", "Selection", "no_selection", "by_backend",
    "powerlaw", "svd_tm_basis", "tm_prior",
    "PTA", "ModelArrays",
]
