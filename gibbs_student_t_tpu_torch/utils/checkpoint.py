"""Checkpoint and resume of the sampler state.

Counterpart of ``gibbs_student_t_tpu/utils/checkpoint.py``. The full
sampler state is the batched :class:`ChainState` plus a sweep counter, so
a checkpoint is one ``.npz`` whose keys are the ``ChainState`` field names
(the same in both packages) plus ``sweep`` and ``seed``: a checkpoint
written by either package loads in the other. Resume is exact because
sweep ``i`` draws from ``sweep_key(seed, i)``
(backends/torch_backend.py), whatever chunk or call it falls in.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_checkpoint(path: str, state, sweep: int, seed: int) -> None:
    """Write ``state`` (a ``ChainState`` of tensors on any device, or of
    numpy arrays) with the index of the next sweep and the run's seed.
    Atomic: the file is written beside ``path`` and renamed over it, so a
    kill never leaves a torn checkpoint."""
    arrays = {f: _host(getattr(state, f)) for f in state._fields}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, sweep=sweep, seed=seed, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, device=None) -> Tuple[object, int, int]:
    """``(state, next_sweep_index, seed)``, the state's tensors on
    ``device`` (``None`` means ``"cuda"`` and raises when CUDA is absent,
    as the samplers do). A checkpoint written before a field existed loads
    it at its neutral value: zero log jump-scales (``mh_log_scale``) and
    the empty covariance factor (``mh_cov_chol``), the values of a run
    without adaptation."""
    from gibbs_student_t_tpu_torch.backends.torch_backend import ChainState
    from gibbs_student_t_tpu_torch.convert import chain_state_from_arrays

    with np.load(path) as data:
        missing = [f for f in ChainState._fields if f not in data
                   and f not in ("mh_log_scale", "mh_cov_chol")]
        if missing:
            raise KeyError(f"checkpoint {path} lacks field {missing[0]!r}")
        arrays = {f: data[f] for f in ChainState._fields if f in data}
        state = chain_state_from_arrays(arrays, device=device)
        return state, int(data["sweep"]), int(data["seed"])
