"""Build and load ``libgst_cuda.so``, the port's hand-written CUDA kernels.

The sources are ``gibbs_student_t_tpu_torch/csrc/*.cu`` (plus the shared
``*.cuh``). They are compiled with ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface and loaded with ``ctypes``:
no PyTorch headers are involved, so a build takes seconds, not minutes.
The build happens at first use, in ``_build/`` inside the package (listed
in ``.gitignore``), and again whenever the hash of the sources and flags
changes. Each ``.cu`` is compiled by its own ``nvcc`` process, all started
together, then linked once.

``--use_fast_math`` is deliberately absent: the MH kernels' reject
semantics (a non-PD pivot gives NaN, NaN never accepts, an out-of-bounds
prior is -inf) rest on IEEE ``logf``/``expf``/``rsqrtf`` behaviour.
``SOURCE_FLAGS`` adds a file's own flags: ``draws.cu`` is built with
``-fmad=false``, so that its float64 arithmetic rounds each operation as
the plain PyTorch version on the CPU does.

Every C entry returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is non-zero. Nothing here is imported or
built on a host without CUDA: the CPU tests never reach :func:`lib`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
LIB_NAME = "libgst_cuda.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: extra nvcc flags of one source file, by its name
SOURCE_FLAGS = {"draws.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_Z = ctypes.c_size_t
_L = ctypes.c_longlong
# name -> (argtypes, restype)
_SIGNATURES = {
    "gst_chol_fused": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "gst_tri_solve_T": ([_P, _P, _P, _I, _I, _P], _I),
    "gst_white_mh": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                      _I, _I, _I, _I, _I, _I, _P], _I),
    "gst_hyper_mh": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                      _P, _P, _I, _I, _I, _I, _I, _F, _I, _P], _I),
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
    "gst_draw_geometry": ([_P], _I),
}

_lock = threading.Lock()
_lib = None
#: the ptxas resource report of the last build in this process
ptxas_report = ""


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


def build(force: bool = False) -> str:
    """Compile the sources into ``_build/libgst_cuda.so`` unless the
    library there matches the current sources' hash. Returns its path."""
    global ptxas_report
    os.makedirs(BUILD, exist_ok=True)
    lib_path = os.path.join(BUILD, LIB_NAME)
    stamp = os.path.join(BUILD, LIB_NAME + ".hash")
    want = _hash()
    if not force and os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as fh:
            if fh.read().strip() == want:
                return lib_path
    nvcc = _nvcc()
    objs = [os.path.join(BUILD, os.path.basename(src)[:-3] + ".o")
            for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(os.path.basename(src), ()),
             "-c", src, "-o", obj]
            for src, obj in zip(_sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    reports = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, reports):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    link = [nvcc, "-shared", "-o", lib_path + ".tmp", *objs]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed: {' '.join(link)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(lib_path + ".tmp", lib_path)
    with open(stamp, "w") as fh:
        fh.write(want)
    ptxas_report = "".join(reports)
    with open(os.path.join(BUILD, "ptxas.txt"), "w") as fh:
        fh.write(ptxas_report)
    return lib_path


def lib():
    """The loaded library (built first if needed), argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = res
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def ptr(t) -> int:
    """Device pointer of a tensor, as ctypes wants it."""
    return t.data_ptr()


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
