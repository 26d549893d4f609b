"""gibbs_student_t_tpu_torch — the PyTorch/CUDA port of the robust
(Student-t / Gaussian-mixture) Gibbs sampler for pulsar-timing noise
models, for NVIDIA Hopper GPUs.

It stands beside the JAX package ``gibbs_student_t_tpu`` (the reference)
and shares no code with it: the host layer (par/tim ingestion, timing
model, signal algebra, ``ModelArrays``) is a numpy copy, and the sampler
is plain PyTorch around six CUDA kernels written by hand for ``sm_90a``
(``csrc/``, built at first use by ``ops/_cuda.py``).

Layout:
  data/      host-side NumPy ingestion + simulation (par/tim, design matrix)
  models/    parameters, signal algebra, PTA seam, frozen ModelArrays
  backends/  ChainResult + the many-chain ``TorchGibbs`` sampler
  ops/       TNT products, preconditioned Cholesky algebra, the kernel
             wrappers (chol, tnt, white_mh, hyper_mh) and their plain
             versions
  csrc/      the CUDA C++ kernels
  parallel/  the multi-pulsar ensemble and the chain diagnostics
  obs/       telemetry, chain health, metrics registry, run ledger, traces
  serve/     the serving slot pool and its serial server
  utils/     checkpoints, the chain spool (resumable runs), timing
  drivers/   ``python -m gibbs_student_t_tpu_torch.drivers.simulate_data``
             and ``.drivers.run_sims``, the experiment drivers
  convert.py carries a JAX-side model/state (as numpy) into this package
  testing.py float64 replays that keep MH decisions clear of float32 ties

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

import torch

# Full float32 contractions everywhere. The reference pins its likelihood
# matmuls to full precision because reduced-precision inputs (bf16 on the
# TPU, TF32 here) measurably biased the red-noise spectral-index posterior
# (gibbs_student_t_tpu/ops/tnt.py module docstring); TF32 keeps ~3 decimal
# digits, the same failure mode.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from gibbs_student_t_tpu_torch.config import GibbsConfig, MHConfig  # noqa: E402
from gibbs_student_t_tpu_torch.models.pta import PTA, ModelArrays  # noqa: E402

__all__ = ["GibbsConfig", "MHConfig", "PTA", "ModelArrays", "__version__"]
