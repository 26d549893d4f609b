"""Sampler backends behind the ``SamplerBackend`` seam: the ``ChainResult``
container, ``NumpyGibbs`` (the single-chain float64 host oracle) and
``TorchGibbs`` (many chains on the GPU), resolved by ``get_backend``."""

from gibbs_student_t_tpu_torch.backends.base import (
    ChainResult,
    SamplerBackend,
    get_backend,
)
from gibbs_student_t_tpu_torch.backends.numpy_backend import NumpyGibbs
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs

__all__ = ["SamplerBackend", "ChainResult", "get_backend", "NumpyGibbs",
           "TorchGibbs"]
