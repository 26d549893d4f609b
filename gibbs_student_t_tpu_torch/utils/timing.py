"""Wall-clock instrumentation: ``BlockTimer``.

Counterpart of ``gibbs_student_t_tpu/utils/timing.py``. ``BlockTimer``
times a call and attributes its wall to a name. PyTorch returns before a
CUDA device finishes, so when the call's result holds CUDA tensors the
timer fences with ``torch.cuda.synchronize`` on their devices before it
reads the clock (the JAX timer's ``block_until_ready``); a result on the
CPU is complete when the call returns and needs no fence. It is the
wall-clock source of the metrics registry (``obs.metrics.MetricsRegistry
.timer``).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict

import torch


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of the tensors in ``obj`` (tensors, and tuples,
    lists and dicts of them)."""
    if torch.is_tensor(obj):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, found)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    return found


class BlockTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def time(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` and attribute its wall, device work included, to
        ``name``."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": self.totals[name], "calls": self.counts[name],
                   "mean_s": self.totals[name] / max(self.counts[name], 1)}
            for name in self.totals
        }

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:24s} {s['total_s']:8.3f}s "
                         f"({s['calls']}x, {s['mean_s'] * 1e3:.2f} ms)")
        return "\n".join(lines)
