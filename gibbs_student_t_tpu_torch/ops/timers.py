"""Per-stage device times of the sweep: the stage timers.

Counterpart of the timer section of ``gibbs_student_t_tpu/native/ffi.py``
(the JAX package's rdtsc brackets inside its CPU kernels). Here the sweep
(``TorchGibbs._sweep`` and ``_draw``; the ensemble and the serving pool's
lanes run the same two methods) opens :func:`stage` around each of its
eight stages, :data:`STAGE_NAMES` in the JAX enum's order:

- ``draws``: all of ``_draw`` (the draw kernel D1 and the jump algebra);
- ``white_mh``: the white MH block and the new noise vector (B3, B6);
- ``tnt``: the Gram products (B5, or the dense products on the flagship);
- ``schur``: the Schur elimination of the static block (B1 at m = 14, the
  solves of the A block);
- ``hyper_mh``: the hyper MH block (B4; under MTM its stacked factors);
- ``bdraw_factor``: the b draw's escalating-jitter factor and its
  back-solve (B1 and B2 at the varying block);
- ``solves``: the assembly of b from the A block's factor (B2);
- ``resid``: the residual and the noise vector at ``x``.

The theta, z, alpha and df glue and the Robbins-Monro step stay
unattributed, as the XLA glue is in the JAX package.

The clock follows the device of the tensors the stage works on, as a
kernel wrapper's choice of its plain version does, never a probe. On a
CUDA device a bracket records two ``torch.cuda.Event(enable_timing=True)``
on the device's current stream, taken from a pool and given back once
read, each recorded under ``_cuda.guard`` of that device, as the kernels
are launched. A bracket opened with ``follows=`` the bracket that just closed on
the same thread, with no device work issued between the two, starts at
that bracket's end event on its stream instead of recording its own: the
sweep's brackets from ``white_mh`` to ``solves`` (and ``resid`` where
nothing runs between) are one chain, 10 event records a sweep instead of
16, and two ``torch.cuda.current_stream`` calls instead of eight (an
event record costs the host and the stream microseconds each:
chip_smoke.py phase 22 times a sweep's brackets on both). **An event
pair measures the stream's time between its two points: that includes
any time the stream sat idle because the host had not yet issued the
stage's next launch. It is not the kernels' busy time.** Where
the host sets the pace (the flagship and the serving pool), most of a
stage's milliseconds are that wait; where the device does (ens32), a
stage's milliseconds are close to its kernels' time. On the CPU, where
PyTorch runs each op before it returns, a bracket reads
``time.perf_counter``.

The flag is process-global and down until a consumer raises it. It is up
while :func:`timers_enable` has set it or any consumer holds it: a
``ChainServer`` that wants the timers (``kernel_timers=True`` or
``GST_KERNEL_TIMERS=1``) takes a hold with :func:`timers_acquire` when it
is built and gives it back with :func:`timers_release` when it closes, so
one server neither lowers the flag under another nor leaves it up for the
samplers that run after it. Unlike the JAX package's rdtsc brackets, which
cost nanoseconds, a bracket here costs the host microseconds of Python and
CUDA calls (chip_smoke.py phase 22a times them), so nothing raises the
flag by default: ``GST_KERNEL_TIMERS=auto`` resolves to off in this
package. With the flag down :func:`stage` returns a null context; with it
up a bracket touches no tensor, so the sweep's results are bit for bit the
same either way. Recorded pairs wait in a pending
list (guarded by a lock: the dispatch thread records, a drain thread
reads) until :func:`timers_snapshot` folds those whose end event is done,
in the order they were recorded, stopping at the first that is not; it
never synchronizes. With nobody reading, a bracket folds what is done once
the list passes :data:`PENDING_CAP`.

While a profiler records, an open bracket also opens
``record_function("stage/<name>")``, so a trace shows which kernels each
stage launched.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict

import torch

from gibbs_student_t_tpu_torch.ops import _cuda
from gibbs_student_t_tpu_torch.utils.env import env_choice

#: stage names in the JAX enum's order (native/src/gst_kernels.h StageId)
STAGE_NAMES = ("schur", "hyper_mh", "bdraw_factor", "solves",
               "white_mh", "tnt", "resid", "draws")
_INDEX = {name: i for i, name in enumerate(STAGE_NAMES)}
#: pending event pairs past which a recording bracket folds what is done
PENDING_CAP = 1024

_lock = threading.Lock()
_on = False
_set = False        # timers_enable's setting
_holds = 0          # consumers' holds (timers_acquire)
_ms = [0.0] * len(STAGE_NAMES)
_calls = [0] * len(STAGE_NAMES)
# [stage index, device index, start event, end event, end shared, folded],
# in recording order; "end shared": a later bracket starts at this end
_pending: collections.deque = collections.deque()
# device index -> timing events free for reuse
_free: Dict[int, list] = {}


def kernel_timers_env() -> str:
    """Validated ``GST_KERNEL_TIMERS`` (``auto`` when unset; strict
    ``auto|1|0``, a typo raises). ``auto`` resolves to off here (on in the
    JAX package): see the module docstring."""
    return env_choice("GST_KERNEL_TIMERS")


def timers_available() -> bool:
    """Whether a clock exists for the stages: always, here (CUDA events on
    the card, ``time.perf_counter`` on the CPU)."""
    return True


def timers_enable(on: bool) -> None:
    """Set or clear the direct setting of the process-global flag
    (idempotent; a sweep reads the flag at each bracket). Clearing it
    leaves the flag up while a consumer holds it."""
    global _on, _set
    with _lock:
        _set = bool(on)
        _on = _set or _holds > 0


def timers_acquire() -> None:
    """Take a consumer's hold: the flag stays up until every hold is
    given back with :func:`timers_release`."""
    global _on, _holds
    with _lock:
        _holds += 1
        _on = True


def timers_release() -> None:
    """Give back a hold of :func:`timers_acquire`; the flag falls with the
    last one unless :func:`timers_enable` set it."""
    global _on, _holds
    with _lock:
        _holds = max(_holds - 1, 0)
        _on = _set or _holds > 0


def timers_reset() -> None:
    """Zero the accumulators and drop the pending pairs. Only exact with
    no sweep in flight: consumers on a live server difference
    :func:`timers_snapshot` values instead."""
    with _lock:
        for i in range(len(STAGE_NAMES)):
            _ms[i] = 0.0
            _calls[i] = 0
        _pending.clear()


def _fold_locked() -> None:
    """Fold the pending pairs whose end event is done, in recording order,
    up to the first that is not (the caller holds ``_lock``)."""
    while _pending:
        entry = _pending[0]
        i, dev, start, end, shared = entry[:5]
        try:
            if not end.query():
                return
            ms = start.elapsed_time(end)
        except RuntimeError:
            ms = None       # a pair the device cannot time is dropped
        _pending.popleft()
        entry[5] = True
        if ms is not None:
            _ms[i] += ms
            _calls[i] += 1
        # the start is free now (a shared one's earlier pair folded first);
        # a shared end waits for the pair that starts at it
        free = _free.setdefault(dev, [])
        free.append(start)
        if not shared:
            free.append(end)


def timers_snapshot() -> dict:
    """Cumulative ``{stage: {"ms": float, "calls": int}}`` since the last
    reset, every stage, after folding what the device has finished."""
    with _lock:
        _fold_locked()
        return {name: {"ms": _ms[i], "calls": _calls[i]}
                for i, name in enumerate(STAGE_NAMES)}


def timers_delta_ms(prev: dict, cur: dict) -> dict:
    """``{stage: {"ms": float, "calls": int}}`` for the stages that
    advanced between two cumulative snapshots; stages with no new calls
    are left out."""
    out = {}
    for name in STAGE_NAMES:
        c0 = prev.get(name) or {"ms": 0.0, "calls": 0}
        c1 = cur.get(name)
        if c1 is None:
            continue
        dcalls = c1["calls"] - c0["calls"]
        dms = c1["ms"] - c0["ms"]
        if dcalls <= 0 and dms <= 0:
            continue
        out[name] = {"ms": dms, "calls": int(dcalls)}
    return out


def _annotation(i: int):
    """``record_function("stage/<name>")`` entered while a profiler
    records, else None."""
    if not torch._C._autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function("stage/" + STAGE_NAMES[i])
    rf.__enter__()
    return rf


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _HostBracket:
    """A stage on the CPU: ``time.perf_counter`` around it."""

    __slots__ = ("i", "t0", "rf")

    def __init__(self, i: int):
        self.i = i

    def __enter__(self):
        self.rf = _annotation(self.i)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self.t0) * 1e3
        with _lock:
            _ms[self.i] += ms
            _calls[self.i] += 1
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def _event(dev: int):
    pool = _free.get(dev)
    if pool:
        try:
            return pool.pop()
        except IndexError:
            pass
    return torch.cuda.Event(enable_timing=True)


class _CudaBracket:
    """A stage on a CUDA device: an event pair on its current stream, or,
    following ``prev``, the pair from ``prev``'s end event."""

    __slots__ = ("i", "device", "dev", "prev", "stream", "start", "entry",
                 "rf")

    def __init__(self, i: int, device, prev):
        self.i = i
        self.device = device
        self.dev = device.index
        self.prev = prev
        self.entry = None

    def __enter__(self):
        self.rf = _annotation(self.i)
        prev, self.prev = self.prev, None
        if prev is not None and prev.dev == self.dev:
            with _lock:
                entry = prev.entry
                if entry is not None and not entry[5]:
                    entry[4] = True
                    self.stream, self.start = prev.stream, entry[3]
                    return self
        self.stream = torch.cuda.current_stream(self.device)
        self.start = _event(self.dev)
        with _cuda.guard(self.device):
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        end = _event(self.dev)
        with _cuda.guard(self.device):
            end.record(self.stream)
        self.entry = [self.i, self.dev, self.start, end, False, False]
        with _lock:
            _pending.append(self.entry)
            if len(_pending) > PENDING_CAP:
                _fold_locked()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def stage(name: str, device, follows=None):
    """The bracket of sweep stage ``name`` (one of :data:`STAGE_NAMES`) for
    work on ``device`` (a ``torch.device``): a null context while the flag
    is down, else a CUDA event pair or a host clock by the device's type.
    ``follows``: the bracket (what ``with stage(...) as b`` bound) that
    closed just before on this thread with no device work issued since;
    a CUDA bracket then starts at its end event."""
    if not _on:
        return _NULL
    i = _INDEX[name]
    if device.type == "cuda":
        return _CudaBracket(
            i, device, follows if isinstance(follows, _CudaBracket)
            else None)
    return _HostBracket(i)
