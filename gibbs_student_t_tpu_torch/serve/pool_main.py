"""Subprocess pool worker: one ChainServer behind the RPC and HTTP wire.

Counterpart of ``gibbs_student_t_tpu/serve/pool_main.py``::

    python -m gibbs_student_t_tpu_torch.serve.pool_main --dir POOLDIR \\
        [--recover] [--faults JSON]

builds a :class:`~gibbs_student_t_tpu_torch.serve.server.ChainServer` from
the pool directory's pickled spec (``POOLDIR/spec.pkl``, written by
:func:`write_spec`), mounts the mutating RPC edge (serve/rpc.py) and the
read-only HTTP endpoints (obs/http.py, through ``http_port=0``), journals
to ``POOLDIR/manifest`` (the crash-recovery manifest), refreshes
``POOLDIR/obs``, and drives quanta on its main thread until a
``shutdown`` RPC or a signal.

Startup handshake: once everything is mounted the worker writes
``POOLDIR/ready.json`` atomically: ``{pid, rpc_port, http_port, obs_dir,
manifest_dir, recovered, lost, coldstart}``, which the spawner polls for.
``coldstart`` holds ``recover``, ``boot_s`` (from :func:`main`'s start,
after the package's import, to the server's construction: the spec,
CUDA's initialisation and the kernels' library), ``build_s`` (the
server's construction, and with ``--recover`` its resubmissions),
``library`` (``"built"`` when this process compiled ``libgst_cuda.so``,
``"loaded"`` when the stamp of an earlier build matched, None on the CPU)
and ``library_s``; after the first completed quantum the file is
rewritten with ``first_dispatch_t`` (wall clock, for a spawner's own
count from the spawn) and ``first_dispatch_s`` (from :func:`main`'s
start). ``--recover`` boots
through :meth:`ChainServer.recover` instead: outstanding spooled tenants
resume from their last checkpoint, bitwise their uninterrupted runs, and
``ready.json["recovered"]`` maps each job's key (its request name, else
its spool directory) to its new tenant id. The spec's constructor
arguments (``device``, ``pipeline``, ...) apply to a recovered server too.

The worker runs on the card unless the spec's ``kwargs`` say
``device="cpu"``; without CUDA it raises and exits non-zero, and nothing
carries on on the CPU.

Chaos: ``--faults`` arms a JSON list of serve/faults.py ``FaultSpec``
dicts in this process; the worker fires the ``pool_kill`` point once per
completed quantum (never on an idle poll), so ``[{"point": "pool_kill",
"after": N, "action": "kill"}]`` dies at a deterministic quantum.

When it retires (a ``shutdown`` RPC, or its run ending) the worker writes
``POOLDIR/summary.json``: its server's ``summary()``, the run-level
numbers since the last ``reset``.

The spec is ``{"template_ma", "config", "kwargs"}``: the ChainServer
constructor's arguments less the wiring this module owns (the manifest,
HTTP and ``obs_dir``).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

READY_NAME = "ready.json"
SPEC_NAME = "spec.pkl"
SUMMARY_NAME = "summary.json"


def _write_ready(pool_dir: str, doc: dict) -> None:
    tmp = os.path.join(pool_dir, READY_NAME + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, os.path.join(pool_dir, READY_NAME))


def write_spec(pool_dir: str, template_ma, config, kwargs: dict) -> None:
    """The spawner's half of the handshake."""
    os.makedirs(pool_dir, exist_ok=True)
    tmp = os.path.join(pool_dir, SPEC_NAME + ".tmp")
    with open(tmp, "wb") as fh:
        pickle.dump({"template_ma": template_ma, "config": config,
                     "kwargs": dict(kwargs)}, fh)
    os.replace(tmp, os.path.join(pool_dir, SPEC_NAME))


def main(argv=None) -> int:
    t_boot = time.monotonic()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True,
                    help="pool directory (spec.pkl in; ready.json, "
                         "manifest/, obs/ out)")
    ap.add_argument("--recover", action="store_true",
                    help="boot via ChainServer.recover() from the pool "
                         "directory's manifest instead of the spec")
    ap.add_argument("--faults", default=None,
                    help="JSON list of FaultSpec dicts to arm in this "
                         "process")
    args = ap.parse_args(argv)
    pool_dir = os.path.abspath(args.dir)
    os.makedirs(pool_dir, exist_ok=True)

    from gibbs_student_t_tpu_torch.backends.torch_backend import (
        resolve_device,
    )
    from gibbs_student_t_tpu_torch.obs.metrics import _jsonable
    from gibbs_student_t_tpu_torch.ops import _cuda
    from gibbs_student_t_tpu_torch.serve import faults as _faults
    from gibbs_student_t_tpu_torch.serve.rpc import RpcServer
    from gibbs_student_t_tpu_torch.serve.server import ChainServer

    if args.faults:
        specs = json.loads(args.faults)
        _faults.install(*[_faults.FaultSpec(**d) for d in specs])

    with open(os.path.join(pool_dir, SPEC_NAME), "rb") as fh:
        spec = pickle.load(fh)
    kwargs = dict(spec["kwargs"])
    # the card unless the spec asks for the CPU; no CUDA raises here
    device = resolve_device(kwargs.get("device"))
    library, library_s = None, None
    if device.type == "cuda":
        t_lib = time.monotonic()
        _cuda.lib()      # waits for, or makes, the build of the sources
        library, library_s = _cuda.last_build, time.monotonic() - t_lib

    manifest_dir = os.path.join(pool_dir, "manifest")
    obs_dir = os.path.join(pool_dir, "obs")
    recovered_map, lost = {}, []
    t_build = time.monotonic()
    if args.recover:
        for k in ("nlanes", "quantum", "record", "max_queue",
                  "backpressure", "telemetry", "scheduler"):
            kwargs.pop(k, None)          # the manifest's geometry holds
        srv, handles = ChainServer.recover(
            manifest_dir, http_port=0, obs_dir=obs_dir, **kwargs)
        recovered_map = {str(k): h.tenant_id for k, h in handles.items()}
        lost = [r.get("name") or r.get("spool_dir") or r.get("tenant")
                for r in srv.lost_tenants]
    else:
        srv = ChainServer(spec["template_ma"], spec["config"],
                          manifest_dir=manifest_dir, http_port=0,
                          obs_dir=obs_dir, **kwargs)
    t_ready = time.monotonic()

    def on_shutdown():
        srv._stop.set()   # run(idle_exit=False) returns at the boundary

    rpc = RpcServer(srv, on_shutdown=on_shutdown)
    ready_doc = {
        "pid": os.getpid(),
        "rpc_port": rpc.port,
        "http_port": (srv.http.port if srv.http is not None else None),
        "obs_dir": obs_dir,
        "manifest_dir": manifest_dir,
        "recovered": recovered_map,
        "lost": lost,
        "coldstart": {
            "recover": bool(args.recover),
            "boot_s": round(t_build - t_boot, 3),
            "build_s": round(t_ready - t_build, 3),
            "library": library,
            "library_s": (round(library_s, 3)
                          if library_s is not None else None),
        },
    }
    _write_ready(pool_dir, ready_doc)

    seen = {"q": 0}

    def on_quantum(server):
        # the dead-pool injection point: once per completed quantum
        # (run() calls this hook on idle polls too, which must not advance
        # a spec's count); action="kill" dies here, like a lost node
        q = server.quanta
        while seen["q"] < q:
            seen["q"] += 1
            _faults.fire("pool_kill")
        if seen["q"] > 0 and "first_dispatch_t" not in \
                ready_doc["coldstart"]:
            ready_doc["coldstart"]["first_dispatch_t"] = time.time()
            ready_doc["coldstart"]["first_dispatch_s"] = round(
                time.monotonic() - t_boot, 3)
            _write_ready(pool_dir, ready_doc)

    # drive quanta on the main thread until retired over the wire; the RPC
    # threads feed the admission queue
    try:
        srv.run(idle_exit=False, on_quantum=on_quantum)
    finally:
        rpc.close()
        srv.close()
    path = os.path.join(pool_dir, SUMMARY_NAME)
    with open(path + ".tmp", "w") as fh:
        json.dump(_jsonable(srv.summary()), fh)
    os.replace(path + ".tmp", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
