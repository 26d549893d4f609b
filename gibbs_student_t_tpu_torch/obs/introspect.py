"""What a run built and launched: the port's kernel and program records.

Counterpart of ``gibbs_student_t_tpu/obs/introspect.py`` for a package
that compiles no XLA. The JAX module wraps each jitted chunk program and
records its compile time, XLA cost and memory analyses, and the Pallas
kernels and linalg implementations its trace chose. Here nothing is
traced, so the records come from the places that decide what runs:

- :func:`register_kernel` / :func:`note_kernel`: each hand-written
  kernel's wrapper records, once per signature, which kernel it ran, on
  which implementation (``impl``: ``"cuda"``, the kernel, or ``"plain"``,
  its PyTorch version on the CPU), in which launch form (``ops/chol.py
  launch_form``: a warp of two or three rows a lane, or a block;
  ``ops/white_mh.py white_form``: a warp or a cluster a chain; the hyper
  kernel's warp or block) and at which shapes. After the first time, a
  call costs one set lookup. The kernel's launch is never wrapped.
- :func:`register_linalg_impl`: the preconditioned algebra of
  ``ops/linalg.py`` records which implementation each operation took.
- A program record for the first chunk of each signature of each
  sampler or pool (:func:`program_begin` at the chunk's start,
  :func:`program_end` at its flush, which already waits for it), as the
  JAX package compiles each sampler's chunk program once a signature.
  The labels are the JAX package's with ``torchgibbs`` for ``jaxgibbs``:
  ``torchgibbs_chunk_c{C}``, ``ensemble_grouped_chunk_p{P}_c{C}`` and
  ``serve_pool_chunk_l{L}``. A record holds the seconds of building or
  loading ``libgst_cuda.so`` the chunk triggered (``build_s``; of them,
  compiling, ``compile_s``), the chunk's wall up to its flush
  (``first_chunk_s``; with deferred flushes the next chunk's issue is in
  it), ``peak_bytes`` (``torch.cuda.max_memory_allocated`` at the flush:
  the process's peak so far, not the program's own; None on the CPU),
  ``platform`` and the kernels and linalg implementations first seen
  while it ran. Each record is also one ``compile`` event and
  ``compiles_total`` / ``compile_seconds`` in an attached metrics
  registry.
- :func:`build_record`: how this process got the kernels' library
  (``ops/_cuda.last_build``, seconds, the sources' hash) and, per entry
  function, the registers, spill bytes and shared memory of its ptxas
  report.

:func:`compile_summary` folds them into the ``cuda`` block of the run
ledger (obs/ledger.py) and of ``manifest.json`` (obs/metrics.py), with the
JAX block's keys where they mean the same; ``kernels`` takes the place of
``pallas_kernels``, ``build`` is added, and ``flops``,
``bytes_accessed`` and ``custom_calls``, which nothing here measures, are
the explicit ``"unavailable"``. :func:`format_summary` gives the
drivers' ``--introspect`` lines.

``GST_INTROSPECT=0`` (``false`` or empty too; the JAX off switch) skips
the whole layer; any other value than those and ``1``, ``true`` or
``auto`` raises. Bookkeeping never raises into the sampler. Only the
standard library is imported at module scope.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from gibbs_student_t_tpu_torch.utils.env import env_offswitch

UNAVAILABLE = "unavailable"

_LOCK = threading.Lock()
# append-only, deduplicated on the way in, so that a program's record can
# slice off what was first seen while it ran
_KERNEL_LOG: List[Dict[str, Any]] = []
_KERNEL_SEEN: set = set()
_NOTED: set = set()
_LINALG_LOG: List[Dict[str, Any]] = []
_LINALG_SEEN: set = set()
_PROGRAM_LOG: List[Dict[str, Any]] = []
_PROGRAM_SEEN: set = set()
# a number for each object that runs programs (a sampler, a pool)
_OWNER_IDS = itertools.count()


def enabled() -> bool:
    """Whether ``GST_INTROSPECT`` leaves the layer on (a typo raises)."""
    return env_offswitch("GST_INTROSPECT")


def _plain(meta: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-native values, sorted by key: tuples become lists, anything
    else that is not a scalar its repr."""
    out = {}
    for k, v in sorted(meta.items()):
        if isinstance(v, tuple):
            v = list(v)
        if isinstance(v, list):
            v = [x if isinstance(x, (int, float, bool, str, type(None)))
                 else repr(x) for x in v]
        elif not isinstance(v, (int, float, bool, str, type(None))):
            v = repr(v)
        out[str(k)] = v
    return out


def _freeze(rec: Dict[str, Any]):
    return tuple((k, tuple(v) if isinstance(v, list) else v)
                 for k, v in rec.items())


def register_kernel(name: str, **meta) -> None:
    """Record one hand-written kernel's run (deduplicated by content)."""
    if not enabled():
        return
    try:
        rec = {"kernel": str(name), **_plain(meta)}
        key = _freeze(rec)
        with _LOCK:
            if key not in _KERNEL_SEEN:
                _KERNEL_SEEN.add(key)
                _KERNEL_LOG.append(rec)
    except Exception:  # noqa: BLE001 - bookkeeping never fails a launch
        pass


def note_kernel(name: str, impl: str, shape,
                form: Optional[Callable[[], Dict[str, Any]]] = None) -> None:
    """A wrapper's call: :func:`register_kernel` ``(name, impl=impl,
    shape=shape, **form())`` the first time ``(name, impl, shape)`` is
    seen, one set lookup after that. ``form`` (called once) gives the
    launch form's fields."""
    key = (name, impl, tuple(shape))
    if key in _NOTED or not enabled():
        return
    try:
        meta = dict(form()) if form is not None else {}
    except Exception:  # noqa: BLE001
        meta = {"form": UNAVAILABLE}
    register_kernel(name, impl=impl, shape=list(shape), **meta)
    with _LOCK:
        _NOTED.add(key)


def register_linalg_impl(op: str, impl: str, **meta) -> None:
    """Record one operation's implementation (``ops/linalg.py``): ``op``
    the operation (``factor``, ``factor_robust``, ``bwd_vec``,
    ``schur_solves``), ``impl`` what ran it."""
    try:
        key = (op, impl, tuple(sorted(meta.items())))
        if key in _LINALG_SEEN:
            return
    except TypeError:       # an unhashable value: no fast path
        key = None
    if not enabled():
        return
    try:
        rec = {"op": str(op), "impl": str(impl), **_plain(meta)}
        key = key if key is not None else _freeze(rec)
        with _LOCK:
            if key not in _LINALG_SEEN:
                _LINALG_SEEN.add(key)
                _LINALG_LOG.append(rec)
    except Exception:  # noqa: BLE001
        pass


def linalg_impls() -> List[Dict[str, Any]]:
    """Every distinct ``(op, impl, meta)`` seen so far."""
    with _LOCK:
        return [dict(r) for r in _LINALG_LOG]


def kernel_builds() -> List[Dict[str, Any]]:
    """Every distinct kernel record seen so far."""
    with _LOCK:
        return [dict(r) for r in _KERNEL_LOG]


def compile_records() -> List[Dict[str, Any]]:
    """The program records, in the order their first chunks flushed."""
    with _LOCK:
        return [dict(r) for r in _PROGRAM_LOG]


def _cuda_mod():
    from gibbs_student_t_tpu_torch.ops import _cuda

    return _cuda


def program_begin(label: str, owner, *key) -> Optional[dict]:
    """A token for the first chunk of ``(label, *key)`` that ``owner`` (a
    sampler or a pool) runs (None after the first, or with the layer
    off): pass it to :func:`program_end` at that chunk's flush."""
    if not enabled():
        return None
    try:
        oid = owner.__dict__.get("_introspect_id")
        if oid is None:
            oid = owner.__dict__.setdefault("_introspect_id",
                                            next(_OWNER_IDS))
        sig = (label, oid) + tuple(key)
        with _LOCK:
            if sig in _PROGRAM_SEEN:
                return None
            _PROGRAM_SEEN.add(sig)
            marks = (len(_KERNEL_LOG), len(_LINALG_LOG))
        cu = _cuda_mod()
        return {"label": label, "t0": time.perf_counter(), "marks": marks,
                "build": (cu.build_seconds, cu.compile_seconds)}
    except Exception:  # noqa: BLE001
        return None


def program_end(token: Optional[dict], device=None,
                registry=None) -> None:
    """Close ``token``'s record at its chunk's flush (the records are on
    the host, so the chunk is done) and emit it to ``registry``."""
    if token is None:
        return
    try:
        wall = time.perf_counter() - token["t0"]
        cu = _cuda_mod()
        platform = getattr(device, "type", None)
        peak = None
        if platform == "cuda":
            import torch

            peak = int(torch.cuda.max_memory_allocated(device))
        k0, l0 = token["marks"]
        with _LOCK:
            kernels = [dict(r) for r in _KERNEL_LOG[k0:]]
            impls = [dict(r) for r in _LINALG_LOG[l0:]]
        b0, c0 = token["build"]
        rec = {"label": token["label"], "t": round(time.time(), 3),
               "build_s": round(cu.build_seconds - b0, 4),
               "compile_s": round(cu.compile_seconds - c0, 4),
               "first_chunk_s": round(wall, 4), "peak_bytes": peak,
               "platform": platform, "kernels": kernels}
        if impls:
            rec["linalg_impls"] = impls
        with _LOCK:
            _PROGRAM_LOG.append(rec)
    except Exception:  # noqa: BLE001
        return
    if registry is not None:
        try:
            registry.emit("compile", **rec)
            registry.counter("compiles_total").inc()
            registry.histogram("compile_seconds").observe(rec["compile_s"])
        except Exception:  # noqa: BLE001 - sink errors stay local
            pass


def build_record() -> Dict[str, Any]:
    """How this process got ``libgst_cuda.so`` and the ptxas resources of
    its entry functions: the report of this process's build, else the one
    ``_build/ptxas.txt`` kept from the build it loaded (none before the
    library was first needed)."""
    import os

    cu = _cuda_mod()
    rec: Dict[str, Any] = {"library": cu.LIB_NAME,
                           "last_build": cu.last_build,
                           "seconds": round(cu.build_seconds, 4),
                           "compile_s": round(cu.compile_seconds, 4),
                           "source_hash": None, "ptxas_from": None,
                           "kernels": []}
    try:
        rec["source_hash"] = cu._hash()
        report = cu.ptxas_report
        if report:
            rec["ptxas_from"] = "build"
        elif cu.last_build is not None:
            path = os.path.join(cu.BUILD, "ptxas.txt")
            if os.path.exists(path):
                with open(path) as fh:
                    report = fh.read()
                rec["ptxas_from"] = "_build/ptxas.txt"
        rec["kernels"] = cu.parse_ptxas(report)
    except Exception:  # noqa: BLE001
        pass
    return rec


def clear_introspection() -> None:
    """Drop every record of this process (tests, and a driver between
    runs)."""
    with _LOCK:
        for log in (_KERNEL_LOG, _KERNEL_SEEN, _NOTED, _LINALG_LOG,
                    _LINALG_SEEN, _PROGRAM_LOG, _PROGRAM_SEEN):
            log.clear()


def compile_summary() -> Dict[str, Any]:
    """The ``cuda`` block of ledger records and run manifests (see the
    module docstring); a metric nothing reports is ``"unavailable"``."""
    recs = compile_records()
    peaks = [r["peak_bytes"] for r in recs if r.get("peak_bytes") is not None]
    cu = _cuda_mod()
    return {
        "n_programs": len(recs),
        "compile_s": round(cu.compile_seconds, 3),
        "flops": UNAVAILABLE,
        "bytes_accessed": UNAVAILABLE,
        "peak_bytes": max(peaks) if peaks else UNAVAILABLE,
        "custom_calls": UNAVAILABLE,
        "programs": recs,
        "kernels": kernel_builds(),
        "linalg_impls": linalg_impls(),
        "build": build_record(),
    }


def _form_of(k: Dict[str, Any]) -> str:
    form = k.get("form")
    if form is None:
        return "-"
    if form == "warp" and "rows_per_lane" in k:
        return f"warp/{k['rows_per_lane']}"
    if "per_block" in k:
        return f"{form}/{k['per_block']}"
    return str(form)


def format_summary(prefix: str = "# ") -> List[str]:
    """The drivers' ``--introspect`` lines: one a program, the build, one
    a kernel (its implementations, launch forms and shapes) and the linalg
    implementations."""
    lines = []
    for r in compile_records():
        peak = ("?" if r.get("peak_bytes") is None
                else f"{r['peak_bytes'] / 1e6:.1f}MB")
        lines.append(
            f"{prefix}program[{r['label']}] platform={r.get('platform')} "
            f"build={r['build_s']:.2f}s compile={r['compile_s']:.2f}s "
            f"first_chunk={r['first_chunk_s']:.2f}s peak={peak} "
            f"kernels={len(r['kernels'])}")
    b = build_record()
    lines.append(
        f"{prefix}build {b['library']}: {b['last_build'] or 'not loaded'} "
        f"({b['seconds']:.2f}s, compiling {b['compile_s']:.2f}s) "
        f"sources {b['source_hash']}, {len(b['kernels'])} entry functions"
        + (f" (ptxas from {b['ptxas_from']})" if b["ptxas_from"] else ""))
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for k in kernel_builds():
        by_name.setdefault(k["kernel"], []).append(k)
    for name, ks in sorted(by_name.items()):
        impls = ",".join(sorted({str(k.get("impl")) for k in ks}))
        forms = ",".join(sorted({_form_of(k) for k in ks}))
        shapes = "; ".join(
            "x".join(map(str, k["shape"])) for k in ks if "shape" in k)
        lines.append(f"{prefix}kernel {name} impl={impls} form={forms} "
                     f"shapes={shapes}")
    impls = linalg_impls()
    if impls:
        pairs = ", ".join(sorted({f"{r['op']}={r['impl']}" for r in impls}))
        lines.append(f"{prefix}linalg impls: {pairs}")
    return lines
