"""Profiler hooks: trace capture and named spans.

Counterpart of ``gibbs_student_t_tpu/obs/tracing.py``:

- :func:`trace_to` — ``torch.profiler.profile`` over the enclosed work
  (CPU activity, and CUDA where CUDA is available), written as a Chrome
  trace (``trace_<pid>_<ns>.json``, open it in Perfetto) into the
  directory on exit; a null context when the directory is falsy, so
  drivers pass ``--trace-dir`` straight through.
- :func:`block_span` — a named span over the sweep's stages
  (``gibbs/white_mh``, ``gibbs/tnt_reduction``, ``gibbs/hyper_mh``,
  ``gibbs/b_draw``; backends/torch_backend.py). Eager PyTorch has no
  trace-time scope, so this is ``torch.profiler.record_function``: a
  host-side marker that launches nothing on the device. It is entered
  only while a profiler records; otherwise it is a null context, so an
  untraced sweep pays no dispatcher call for it.
- :func:`host_span` — the same marker for host work between launches
  (chunk flush, spool append).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def _trace(trace_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def trace_to(trace_dir):
    """A profiler capture of the enclosed work written into ``trace_dir``
    as a Chrome trace, or a null context when ``trace_dir`` is None or
    empty."""
    if not trace_dir:
        return contextlib.nullcontext()
    return _trace(trace_dir)


def _span(name: str):
    """``record_function(name)`` while a profiler records, else a null
    context: a ``record_function`` is a dispatcher call on the host
    thread even when nothing records."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def block_span(name: str):
    """Named span over a stage of the sweep (no device launch; a null
    context outside a profiler capture)."""
    return _span(name)


def host_span(name: str):
    """Named span over host work between launches (shows in a
    :func:`trace_to` capture, a null context outside one)."""
    return _span(name)
