"""Several processes: initialization, hybrid meshes and per-process shards.

Counterpart of ``gibbs_student_t_tpu/parallel/multihost.py``. The JAX
package coordinates processes through ``jax.distributed`` and lets XLA
compile its collectives; here ``torch.distributed`` is both the bootstrap
and the data plane, and the collectives are explicit calls
(``parallel/diagnostics.py`` ``rhat_collective``, the ensemble's gather of
each pulsar's chains for its proposal covariance).

Placement follows the JAX package: chains are embarrassingly parallel
and meet only in diagnostics and the covariance estimate, so ``'chain'``
belongs on the links inside one host; pulsars share nothing in this
model family, so ``'pulsar'`` is the axis that may span hosts (the DCN
axes of :func:`make_hybrid_mesh`).

The backend is never chosen behind the caller's back: ``"nccl"`` unless
the caller asks for ``"gloo"`` (the CPU tests, and processes that share
one card, which NCCL refuses).
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gibbs_student_t_tpu_torch.parallel.mesh import (
    Mesh,
    cuda_devices,
    process_rank,
)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the ``torch.distributed`` process group at
    ``tcp://<coordinator_address>``.

    Arguments default to torch's own environment variables where the JAX
    package reads its ``JAX_*`` ones: ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. Returns False, and does nothing, for one
    process with no coordinator (a one-process ensemble is the degenerate
    mesh); True once the group is up. ``backend=None`` means ``"nccl"``,
    which needs CUDA; ``"gloo"`` is used only when asked for. Several
    processes with no coordinator raise ``ValueError``."""
    import torch.distributed as dist

    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        if num_processes in (None, 1):
            return False  # one process, nothing to coordinate
        raise ValueError(
            f"num_processes={num_processes} with no coordinator address: "
            "pass coordinator_address= or set MASTER_ADDR/MASTER_PORT")
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "the nccl backend needs CUDA, and CUDA is not available here; "
            "pass backend='gloo' to coordinate processes on the CPU")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes or 1),
                            rank=int(process_id or 0))
    return True


def _line_groups(ranks: np.ndarray, axis_names: Sequence[str]) -> Dict:
    """``{(axis, line): group}`` for every line of every axis whose blocks
    belong to more than one process. ``new_group`` is a collective of the
    whole world: every rank walks the same lines in the same order (axes
    in mesh order, lines in C order) and so calls it for the same rank
    sets in the same order; a rank set met twice reuses its group."""
    import torch.distributed as dist

    groups, made = {}, {}
    for a, axis in enumerate(axis_names):
        others = [range(n) if k != a else range(1)
                  for k, n in enumerate(ranks.shape)]
        for line in itertools.product(*others):
            sel = list(line)
            sel[a] = slice(None)
            members = tuple(sorted(set(ranks[tuple(sel)].tolist())))
            if len(members) < 2:
                continue
            if members not in made:
                made[members] = dist.new_group(list(members))
            groups[(axis, tuple(line))] = made[members]
    return groups


def make_hybrid_mesh(ici_axes: Dict[str, int],
                     dcn_axes: Optional[Dict[str, int]] = None,
                     devices: Optional[Sequence] = None) -> Mesh:
    """Mesh whose ``dcn_axes`` span processes and ``ici_axes`` stay on each
    process's own devices.

    ``make_hybrid_mesh({'chain': 8}, {'pulsar': 4})`` in 4 processes of 8
    cards each gives each process one pulsar group and shards its chains
    over its cards. Across processes the DCN axes run over ranks,
    rank-major (one process a granule, as the JAX package's fallback for
    platforms without slices), and the ICI axes over ``devices``, this
    process's devices (default: every CUDA device); every rank must have
    the same number, and every rank must call this function, since it
    creates the groups of the lines that cross processes
    (:func:`_line_groups`). With one process it gives the local mesh with
    the DCN axes first, so the slowest axis varies slowest as it would
    across hosts; the axis product must then equal the device count."""
    import torch.distributed as dist

    dcn_axes = dict(dcn_axes or {})
    axis_names = tuple(dcn_axes) + tuple(ici_axes)
    devices = list(devices) if devices is not None else cuda_devices()
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if n_proc == 1:
        shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
        if int(np.prod(shape)) != len(devices):
            raise ValueError(
                f"mesh {dict(**dcn_axes, **ici_axes)} needs "
                f"{int(np.prod(shape))} devices, have {len(devices)}")
        arr = np.empty(len(devices), dtype=object)
        arr[:] = [torch.device(d) for d in devices]
        return Mesh(arr.reshape(shape), axis_names)
    dcn_shape = tuple(dcn_axes.values())
    ici_shape = tuple(ici_axes.values())
    if int(np.prod(dcn_shape)) != n_proc:
        raise ValueError(f"DCN axes {dcn_axes} need {int(np.prod(dcn_shape))}"
                         f" processes, have {n_proc}")
    if int(np.prod(ici_shape)) != len(devices):
        raise ValueError(f"ICI axes {ici_axes} need {int(np.prod(ici_shape))}"
                         f" devices in each process, have {len(devices)}")
    shape = dcn_shape + ici_shape
    arr = np.empty(shape, dtype=object)
    ranks = np.empty(shape, np.int64)
    for idx in np.ndindex(*shape):
        nd = len(dcn_shape)
        ranks[idx] = np.ravel_multi_index(idx[:nd], dcn_shape) if nd else 0
        arr[idx] = torch.device(devices[
            np.ravel_multi_index(idx[nd:], ici_shape) if ici_shape else 0])
    return Mesh(arr, axis_names, ranks, _line_groups(ranks, axis_names))


def local_shard(n_items: int, axis_size: int,
                axis_index: Optional[int] = None) -> slice:
    """The contiguous slice of ``n_items`` this process owns along an axis
    of ``axis_size`` processes: the per-process data-loading contract
    (each process reads only its own pulsars' files). ``axis_index``
    defaults to this process's rank modulo ``axis_size`` (0 before
    initialization)."""
    if axis_index is None:
        axis_index = process_rank() % axis_size
    per = -(-n_items // axis_size)
    start = axis_index * per
    return slice(start, min(start + per, n_items))
