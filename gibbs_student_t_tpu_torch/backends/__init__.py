"""Sampler backends: the ``ChainResult`` container and ``TorchGibbs``."""

from gibbs_student_t_tpu_torch.backends.base import ChainResult, SamplerBackend
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs

__all__ = ["SamplerBackend", "ChainResult", "TorchGibbs"]
