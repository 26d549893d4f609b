"""Multi-pulsar ensembles: every pulsar's chains sampled together."""

from gibbs_student_t_tpu_torch.parallel.ensemble import (
    EnsembleGibbs,
    localized_padded,
    pad_model_arrays,
    stack_model_arrays,
)

__all__ = ["EnsembleGibbs", "localized_padded", "pad_model_arrays",
           "stack_model_arrays"]
