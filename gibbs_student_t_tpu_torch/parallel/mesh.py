"""Meshes of blocks: named axes over devices and the processes that own them.

Counterpart of ``gibbs_student_t_tpu/parallel/mesh.py``. A ``Mesh`` here
is the port's own small class, not ``torch.distributed.DeviceMesh``: that
one assumes one device for each rank and NCCL, where the ensemble needs
blocks that may share a device (several blocks on one card, run one after
another) and processes that may own several devices. Each position of the
mesh is one block of work, with the device it runs on and the rank of the
process that owns it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def process_rank() -> int:
    """This process's rank in the ``torch.distributed`` world, 0 before
    initialization."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """Named axes over blocks: ``axis_names``; ``devices``, a numpy object
    array of ``torch.device`` shaped by the axes; ``ranks``, an int array
    of the same shape, the process that owns each block; ``shape``, a dict
    from axis name to size (JAX's ``mesh.shape``). ``groups`` maps
    ``(axis, line)`` to the ``torch.distributed`` group of the processes
    along that line of that axis, where the line crosses processes
    (``line`` is the block index with the axis's own entry set to 0)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None,
                 groups: Optional[Dict] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh devices of shape {devices.shape} for "
                             f"axes {self.axis_names}")
        self.ranks = (np.full(devices.shape, process_rank(), np.int64)
                      if ranks is None else np.asarray(ranks, np.int64))
        self.groups = dict(groups or {})

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh lacks (JAX's
        ``mesh.shape.get(axis, 1)``)."""
        return self.shape.get(axis, 1)

    def group(self, axis: str, index):
        """The process group of the line of ``axis`` through the block at
        ``index``, or None where that line stays in one process."""
        if axis not in self.axis_names:
            return None
        line = list(index)
        line[self.axis_names.index(axis)] = 0
        return self.groups.get((axis, tuple(line)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def cuda_devices() -> list:
    """Every CUDA device of this process, ``cuda:0 ... cuda:k-1``; raises
    without CUDA (a mesh never falls back to the CPU on its own)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh over the default devices needs CUDA, and CUDA is not "
            "available here; pass devices= (e.g. [torch.device('cpu')] * k)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``Mesh`` with named axes, e.g. ``{'pulsar': 2, 'chain': 4}``,
    owned by this process.

    The axis product must equal the device count. ``devices=None`` means
    every CUDA device (:func:`cuda_devices`), in order, reshaped row-major
    (put ``'chain'`` last to keep a pulsar's chains on neighbouring
    devices). An explicit list may repeat a device: ``[cuda:0] * 4`` puts
    a 2 x 2 mesh on one card, whose four blocks then run one after another
    on it; tests pass ``[torch.device('cpu')] * k``."""
    devices = list(devices) if devices is not None else cuda_devices()
    shape = tuple(axes.values())
    if int(np.prod(shape)) != len(devices):
        raise ValueError(
            f"mesh {axes} needs {int(np.prod(shape))} devices, "
            f"have {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(shape), tuple(axes.keys()))
