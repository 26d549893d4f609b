"""Host-side data layer: par/tim ingestion, timing model, simulation.

First-party NumPy replacement for the reference's use of
``enterprise.pulsar.Pulsar`` / ``libstempo`` / tempo2 (C++)
(reference run_sims.py:11,47,51; simulate_data.py:5-6). Scope is the
reference's two data paths — simulated single-pulsar par/tim sets and
NANOGrav-style par/tim with flags — not full tempo2 generality
(see SURVEY.md §7 step 1).

Everything here is host NumPy; device arrays are produced exactly once at
model-freeze time (models/pta.py).
"""

from gibbs_student_t_tpu_torch.data.par import read_par, write_par
from gibbs_student_t_tpu_torch.data.tim import read_tim, write_tim
from gibbs_student_t_tpu_torch.data.pulsar import Pulsar
from gibbs_student_t_tpu_torch.data.timing_model import design_matrix
from gibbs_student_t_tpu_torch.data.simulate import simulate_data, FakePulsar

__all__ = [
    "read_par",
    "write_par",
    "read_tim",
    "write_tim",
    "Pulsar",
    "design_matrix",
    "simulate_data",
    "FakePulsar",
]
