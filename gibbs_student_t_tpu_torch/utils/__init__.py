"""Utilities: checkpoints, the chain spool, timing.

- :mod:`~gibbs_student_t_tpu_torch.utils.checkpoint` — the sampler state
  as one ``.npz`` (readable by the JAX package too);
- :mod:`~gibbs_student_t_tpu_torch.utils.spoolfile` — the spool file
  format, the JAX package's native one written in Python;
- :mod:`~gibbs_student_t_tpu_torch.utils.spool` — ``ChainSpool`` and its
  readers (``sample(spool_dir=...)``);
- :mod:`~gibbs_student_t_tpu_torch.utils.timing` — ``BlockTimer``.
"""

from gibbs_student_t_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from gibbs_student_t_tpu_torch.utils.timing import BlockTimer

__all__ = ["save_checkpoint", "load_checkpoint", "BlockTimer"]
