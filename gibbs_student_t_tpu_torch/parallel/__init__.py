"""Multi-pulsar ensembles, meshes of blocks, several processes, and the
convergence diagnostics: the JAX package's ``parallel`` names."""

from gibbs_student_t_tpu_torch.parallel.diagnostics import (
    effective_sample_size,
    gelman_rubin,
    rhat_collective,
    split_rhat,
)
from gibbs_student_t_tpu_torch.parallel.ensemble import (
    EnsembleGibbs,
    localized_padded,
    pad_model_arrays,
    stack_model_arrays,
)
from gibbs_student_t_tpu_torch.parallel.mesh import Mesh, make_mesh
from gibbs_student_t_tpu_torch.parallel.multihost import (
    initialize_distributed,
    local_shard,
    make_hybrid_mesh,
)

__all__ = ["make_mesh", "EnsembleGibbs", "stack_model_arrays",
           "effective_sample_size", "gelman_rubin", "split_rhat",
           "initialize_distributed", "local_shard", "make_hybrid_mesh",
           "Mesh", "rhat_collective", "localized_padded",
           "pad_model_arrays"]
