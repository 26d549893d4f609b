"""Build and load ``libgst_cuda.so``, the port's hand-written CUDA kernels.

The sources are ``gibbs_student_t_tpu_torch/csrc/*.cu`` (plus the shared
``*.cuh``). They are compiled with ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface and loaded with ``ctypes``:
no PyTorch headers are involved, so a build takes seconds, not minutes.
The build happens at first use, in ``_build/`` inside the package (listed
in ``.gitignore``), and again whenever the hash of the sources and flags
changes. Each ``.cu`` is compiled by its own ``nvcc`` process, all started
together, then linked once.

The build is safe across processes (a serving worker loads the library
beside the process that spawned it): the check of the stamp and the build
run under an ``fcntl.flock`` on ``_build/build.lock``, a process that
waited re-reads the stamp and loads what the other one built, the objects
and the linked library are written under names of the building process's
own, and the library and its stamp land by ``os.replace``.

``--use_fast_math`` is deliberately absent: the MH kernels' reject
semantics (a non-PD pivot gives NaN, NaN never accepts, an out-of-bounds
prior is -inf) rest on IEEE ``logf``/``expf``/``rsqrtf`` behaviour.
``SOURCE_FLAGS`` adds a file's own flags: ``draws.cu`` is built with
``-fmad=false``, so that its float64 arithmetic rounds each operation as
the plain PyTorch version on the CPU does.

An entry's float64 form is the same name with ``_f64``, the same kernels
instantiated on double in the same source (``chol.cu``, ``hyper_mh.cu``,
``white_mh.cu``, ``draws.cu``; :func:`entry_of` picks it by the operands'
dtype); the wrappers check their operands'
one dtype with :func:`check_float_dtype` and raise through
:func:`refuse_float64` for a kernel with no float64 form yet.

The run's introspection (obs/introspect.py) reads :data:`last_build`,
:data:`build_seconds`, :data:`compile_seconds` and the ptxas report
(:data:`ptxas_report` when this process compiled, else
``_build/ptxas.txt``), parsed by :func:`parse_ptxas`.

Every kernel wrapper launches through :func:`launch`, which enters
:func:`guard` for the device of the wrapper's tensors, passes that
device's current stream and raises (:func:`check`) when the C entry's
``cudaGetLastError()`` after its launch is non-zero; :func:`use_kernel`
is the wrappers' one test of a tensor's device. Nothing here is built on a
host without CUDA: the CPU tests never reach :func:`lib` (obs/introspect.py
only reads this module's records there).
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
LIB_NAME = "libgst_cuda.so"
LOCK_NAME = "build.lock"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: extra nvcc flags of one source file, by its name
SOURCE_FLAGS = {"draws.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_Z = ctypes.c_size_t
_L = ctypes.c_longlong
_D = ctypes.c_double
# name -> (argtypes, restype); an entry's float64 form is the same name
# with ``_f64`` (double pointers, and a double where the float entry takes
# a float)
_HYPER_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I,
               _I, _I, _I, _I]
_SIGNATURES = {
    "gst_chol_fused": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "gst_chol_fused_f64": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "gst_tri_solve_T": ([_P, _P, _P, _I, _I, _P], _I),
    "gst_tri_solve_T_f64": ([_P, _P, _P, _I, _I, _P], _I),
    "gst_white_mh": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                      _I, _I, _I, _I, _I, _I, _P], _I),
    "gst_white_mh_f64": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                          _I, _I, _I, _I, _I, _I, _P], _I),
    "gst_hyper_mh": (_HYPER_ARGS + [_F, _I, _P], _I),
    "gst_hyper_mh_f64": (_HYPER_ARGS + [_D, _I, _P], _I),
    "gst_white_mtm": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "gst_white_form": ([_I, _I, _P], _I),
    "gst_white_check": ([_P, _P, _P, _I, _P], _I),
    "gst_tnt_batched": ([_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P],
                        _I),
    "gst_tnt_workspace": ([_I, _I, _I], _Z),
    "gst_tnt_lanes": ([_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _L, _L,
                       _I, _P], _I),
    "gst_sweep_draws": ([_P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _L, _P],
                        _I),
    "gst_sweep_draws_f64": ([_P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _L,
                             _P], _I),
    "gst_draw_geometry": ([_P], _I),
}

_lock = threading.Lock()
_lib = None
#: the ptxas resource report of the last build in this process
ptxas_report = ""
#: how this process's last :func:`build` got the library: ``"built"``
#: (compiled it), ``"loaded"`` (the stamp matched) or None (no call yet)
last_build = None
#: seconds this process spent getting the library: every :func:`build`
#: (compiling, or checking the stamp) and the load in :func:`lib`
build_seconds = 0.0
#: of those, the seconds of compiling and linking (0.0 when only loaded)
compile_seconds = 0.0
#: the sources' hash of the library this process last built or loaded
built_hash = None


def library_record() -> str:
    """The kernels' library as one line for a status record: its name,
    how this process got it (:data:`last_build`) and the sources' hash
    its stamp holds, or that this process has not loaded it yet."""
    if last_build is None:
        return f"{LIB_NAME} not loaded"
    return f"{LIB_NAME} {last_build} {built_hash}"


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built on this host")


def _stamp_matches(lib_path: str, stamp: str, want: str) -> bool:
    if not (os.path.exists(lib_path) and os.path.exists(stamp)):
        return False
    with open(stamp) as fh:
        return fh.read().strip() == want


def build(force: bool = False) -> str:
    """Compile the sources into ``_build/libgst_cuda.so`` unless the
    library there matches the current sources' hash. Returns its path.
    Another process's build in flight is waited for, then loaded."""
    global build_seconds
    t0 = time.perf_counter()
    try:
        return _build(force)
    finally:
        build_seconds += time.perf_counter() - t0


def _build(force: bool) -> str:
    global ptxas_report, last_build, compile_seconds, built_hash
    os.makedirs(BUILD, exist_ok=True)
    lib_path = os.path.join(BUILD, LIB_NAME)
    stamp = os.path.join(BUILD, LIB_NAME + ".hash")
    want = _hash()
    with open(os.path.join(BUILD, LOCK_NAME), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not force and _stamp_matches(lib_path, stamp, want):
                last_build, built_hash = "loaded", want
                return lib_path
            t0 = time.perf_counter()
            report = _compile_and_link(lib_path, stamp, want)
            compile_seconds += time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    ptxas_report = report
    with open(os.path.join(BUILD, "ptxas.txt"), "w") as fh:
        fh.write(ptxas_report)
    last_build, built_hash = "built", want
    return lib_path


def _compile_and_link(lib_path: str, stamp: str, want: str) -> str:
    """The build itself (the caller holds the lock): objects and the
    linked library under this process's own names, then the library and
    its stamp by ``os.replace``. Returns the ptxas report."""
    nvcc = _nvcc()
    tag = f".{os.getpid()}"
    objs = [os.path.join(BUILD, os.path.basename(src)[:-3] + tag + ".o")
            for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(os.path.basename(src), ()),
             "-c", src, "-o", obj]
            for src, obj in zip(_sources(), objs)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        reports = [proc.communicate()[0] for proc in procs]
        for cmd, proc, out in zip(cmds, procs, reports):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{out}")
        tmp = lib_path + tag + ".tmp"
        link = [nvcc, "-shared", "-o", tmp, *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed: {' '.join(link)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)
        with open(stamp + tag + ".tmp", "w") as fh:
            fh.write(want)
        os.replace(stamp + tag + ".tmp", stamp)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(reports)


def lib():
    """The loaded library (built first if needed), argtypes set."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            path = build()
            t0 = time.perf_counter()
            handle = ctypes.CDLL(path)
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = res
            _lib = handle
            build_seconds += time.perf_counter() - t0
        return _lib


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def _base_name(mangled: str) -> str:
    """The function's name of an Itanium-mangled symbol
    (``_Z11chol_kernelILi2EEv...`` -> ``chol_kernel``; nested names joined
    by ``::``, an anonymous namespace left out, as the profiler's kernel
    names show it only as ``(anonymous namespace)``); the symbol itself
    when it is not one."""
    s = mangled
    if not s.startswith("_Z"):
        return s
    s = s[2:].lstrip("L")
    nested = s.startswith("N")
    if nested:
        s = s[1:]
    parts = []
    while s and s[0].isdigit():
        k = 0
        while s[k].isdigit():
            k += 1
        n = int(s[:k])
        if not s[k:k + n].startswith("_GLOBAL__N"):
            parts.append(s[k:k + n])
        s = s[k + n:]
        if not nested:
            break
    return "::".join(parts) or mangled


def parse_ptxas(report: str) -> list:
    """The entry functions of an ``nvcc -Xptxas -v`` report, in its order:
    ``[{"function", "symbol", "registers", "spill_stores", "spill_loads",
    "stack_bytes", "smem_bytes"}, ...]`` (a field the report does not give
    for a function is None)."""
    out = []
    cur = None
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"function": _base_name(m.group(1)), "symbol": m.group(1),
                   "registers": None, "spill_stores": None,
                   "spill_loads": None, "stack_bytes": None,
                   "smem_bytes": None}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _PROPS.search(line)
        if m:
            cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = (
                int(g) for g in m.groups())
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = _SMEM.search(line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def use_kernel(t, what: str) -> bool:
    """Whether a wrapper given ``t`` launches its kernel: True on a CUDA
    device, False on the CPU (it runs its plain version there); any other
    device raises. Every wrapper decides by this test of its tensor's
    device, never by a probe of the host."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {t.device}")
    return True


def guard(device):
    """The context in which work for ``device`` is issued:
    ``torch.cuda.device(device)``, so that the runtime works in that
    device's context whatever device is current."""
    import torch

    return torch.cuda.device(device)


def launch(entry: str, device, *args, what: str = "") -> None:
    """One launch of the C entry ``gst_<entry>`` for tensors on ``device``,
    the one path of every kernel wrapper: under :func:`guard` (a ctypes
    entry launches in the current device's context, which would read a
    ``cuda:1`` tensor's pointers as ``cuda:0``'s), on ``device``'s current
    stream, passed after ``args``; raises when the entry reports an
    error (named ``what``, default ``entry``)."""
    with guard(device):
        check(getattr(lib(), "gst_" + entry)(*args, stream(device)),
              what or entry)


def ptr(t) -> int:
    """Device pointer of a tensor, as ctypes wants it."""
    return t.data_ptr()


def header_int(name: str) -> int:
    """The integer ``#define name value`` of ``csrc/gst_common.cuh``: the
    one place a constant that the kernels and the wrappers share is
    written (the header is read, nothing is built)."""
    with open(os.path.join(CSRC, "gst_common.cuh")) as f:
        m = re.search(rf"^#define {name} (\d+)$", f.read(), re.M)
    if m is None:
        raise KeyError(f"gst_common.cuh defines no integer {name}")
    return int(m.group(1))


def entry_of(entry: str, dtype) -> str:
    """The C entry of ``entry`` for operands of ``dtype``: the float32
    entry itself, ``<entry>_f64`` for float64 (the kernels' float64
    forms)."""
    import torch

    if dtype == torch.float32:
        return entry
    if dtype == torch.float64:
        return entry + "_f64"
    raise ValueError(f"{entry}: float32 or float64 operands, got {dtype}")


def check_float_dtype(name: str, tensors) -> "object":
    """The one dtype of a wrapper's floating operands, float32 or float64;
    raises on any other dtype and on a mix."""
    import torch

    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"{name}: operands of mixed dtypes "
                         f"{sorted(map(str, dtypes))}")
    (dtype,) = dtypes
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: float32 or float64 only, got {dtype}")
    return dtype


def refuse_float64(name: str, what: str) -> None:
    """The raise of a wrapper handed float64 CUDA tensors for a kernel
    that has no float64 form yet (ROADMAP A-11b); its plain version
    runs float64 on the CPU."""
    raise NotImplementedError(
        f"{name}: {what} has no float64 kernel yet (ROADMAP A-11b); "
        "float64 runs it on the CPU only")


def stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def host_ints(values) -> ctypes.Array:
    """A small host int32 array for an entry's by-value table argument
    (keep it alive across the call; pass :func:`addr` of it)."""
    vals = [int(v) for v in values] or [0]
    return (ctypes.c_int * len(vals))(*vals)


def addr(arr) -> int:
    """Host address of a ctypes array."""
    return ctypes.addressof(arr)
