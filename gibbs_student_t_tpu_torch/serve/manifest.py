"""The crash-recovery manifest of a :class:`ChainServer`.

Counterpart of ``gibbs_student_t_tpu/serve/manifest.py``, with the same
JSONL layout. A serving process that dies (the OOM killer, a node
preemption, ``kill -9``) leaves each spooled tenant's records and rolling
state checkpoint (utils/spool.py); the manifest keeps what the server
knew: which tenants were admitted, with what budgets, seeds and policies,
and how far their checkpoints got. Each record is one compact JSON line
written by a single ``os.write`` on an ``O_APPEND`` descriptor and
fsync'd, so a crash can leave at most one torn final line, which the
reader skips (obs/ledger.read_ledger).

Record kinds (each carries ``t``, unix seconds):

- ``server``: one a server epoch, the pool geometry ``recover`` rebuilds
  (nlanes, quantum, record tier, heterogeneous, max_queue,
  backpressure, telemetry, scheduler). The template model and config
  are pickled beside the log (``server.pkl``).
- ``admit``: an admission: tenant id, name, seed, niter, nchains,
  start_sweep, spool_dir, on_divergence, priority, deadline_sweeps and,
  for a spooled tenant, its pickled model in the content-addressed store
  (``models/<sha256>.pkl``), which recovery re-reads.
- ``checkpoint``: after every spool append, the tenant's resume point
  (``next_sweep``).
- ``done``: the tenant resolved (status ``done`` or ``failed``).
- ``fault`` / ``quarantine`` / ``reinit``: the containment events, so a
  post-mortem needs only the manifest.

Epochs append to one log (a recovered server writes on where the dead
one stopped); records belong to the latest ``server`` record before them,
and recovery resolves the outstanding set per spool directory, a job's
identity across epochs. The pickles are this package's own: a pickle of
the JAX package's names its classes, so neither package reads the
other's (the JSONL reads either way).

Writes are non-fatal: one retry, then a warning. A bookkeeping write must
never take down the serving loop it describes (the tenants' records are
on the spool path, with its own fsync discipline).
"""

from __future__ import annotations

import json
import os
import pickle
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

MANIFEST_NAME = "manifest.jsonl"
SERVER_PICKLE = "server.pkl"
#: content-addressed model store subdirectory: one ``<sha256>.pkl`` per
#: distinct tenant model, referenced by digest from admit records, so a
#: resubmission does not append another copy of the same pickle
MODELS_DIR = "models"


def _append_line(path: str, record: Dict[str, Any]) -> None:
    """The ledger append discipline (single fsync'd O_APPEND write),
    made non-fatal: one retry on an OSError-class failure, then
    warn-and-continue."""
    from gibbs_student_t_tpu_torch.obs.metrics import _jsonable

    line = (json.dumps(_jsonable(record), separators=(",", ":"))
            + "\n").encode()
    for attempt in (0, 1):
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o644)
            try:
                os.write(fd, line)
                os.fsync(fd)
            finally:
                os.close(fd)
            return
        except OSError as e:  # EINTR/ENOSPC-class transients
            if attempt:
                warnings.warn(
                    f"server manifest append failed twice "
                    f"({type(e).__name__}: {e}); record dropped — "
                    f"recovery may lose this event", RuntimeWarning,
                    stacklevel=2)


def read_manifest(manifest_dir: str) -> List[Dict[str, Any]]:
    """Every parseable manifest record in file order (torn final lines
    skipped — the obs/ledger reader tolerance)."""
    from gibbs_student_t_tpu_torch.obs.ledger import read_ledger

    return read_ledger(os.path.join(manifest_dir, MANIFEST_NAME))


class ServerManifest:
    """Writer handle for one ChainServer's manifest directory."""

    def __init__(self, manifest_dir: str):
        self.dir = manifest_dir
        os.makedirs(manifest_dir, exist_ok=True)
        self.path = os.path.join(manifest_dir, MANIFEST_NAME)
        # epoch index = how many server records precede ours
        self.epoch = sum(1 for r in read_manifest(manifest_dir)
                         if r.get("kind") == "server")

    def record(self, kind: str, **fields) -> None:
        rec = {"kind": kind, "t": round(time.time(), 3)}
        rec.update(fields)
        _append_line(self.path, rec)

    # -- server epoch ---------------------------------------------------

    def record_server(self, template_ma, config,
                      pool_kwargs: Dict[str, Any]) -> None:
        """Start an epoch: pickle the template/config (pytrees, not
        JSON-able) and log the pool geometry."""
        tmp = os.path.join(self.dir, SERVER_PICKLE + ".tmp")
        with open(tmp, "wb") as fh:
            pickle.dump({"template_ma": template_ma, "config": config},
                        fh)
        os.replace(tmp, os.path.join(self.dir, SERVER_PICKLE))
        self.record("server", epoch=self.epoch, **pool_kwargs)

    # -- tenants --------------------------------------------------------

    def store_model(self, model) -> Tuple[str, str]:
        """Content-addressed model store: pickle the
        model, hash it, and persist ONE ``models/<digest>.pkl`` blob
        per distinct model — a resubmitted or failed-over tenant's
        admit references the digest instead of appending another
        pickle, so the manifest directory stops growing linearly in
        admissions of the same model. Returns ``(digest,
        relative_path)``; the write is atomic and skipped on a digest
        hit."""
        import hashlib

        blob = pickle.dumps(model, protocol=4)
        digest = hashlib.sha256(blob).hexdigest()
        rel = os.path.join(MODELS_DIR, digest + ".pkl")
        path = os.path.join(self.dir, rel)
        if not os.path.exists(path):
            os.makedirs(os.path.join(self.dir, MODELS_DIR),
                        exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, path)
        return digest, rel

    def record_admit(self, tenant_id: int, request,
                     model=None, warm=None) -> None:
        model_file = model_digest = None
        if model is not None:
            model_digest, model_file = self.store_model(model)
        mon = getattr(request, "monitor", None)
        self.record(
            "admit", tenant=tenant_id, name=request.name,
            seed=request.seed, niter=request.niter,
            nchains=request.nchains, start_sweep=request.start_sweep,
            spool_dir=request.spool_dir,
            on_divergence=request.on_divergence,
            on_converged=getattr(request, "on_converged", "none"),
            monitor=(None if mon is None else {
                "params": (None if mon.params is None
                           else [p if isinstance(p, str) else int(p)
                                 for p in mon.params]),
                "ess_target": mon.ess_target,
                "rhat_target": mon.rhat_target,
                "every": mon.every, "min_rows": mon.min_rows}),
            model_file=model_file, model_digest=model_digest,
            warm=warm, trace_id=getattr(request, "trace_id", None),
            priority=getattr(request, "priority", 1),
            deadline_sweeps=getattr(request, "deadline_sweeps", None))

    def record_checkpoint(self, tenant_id: int, next_sweep: int) -> None:
        self.record("checkpoint", tenant=tenant_id,
                    next_sweep=next_sweep)

    def record_done(self, tenant_id: int, status: str,
                    sweeps: int) -> None:
        self.record("done", tenant=tenant_id, status=status,
                    sweeps=sweeps)

    def compact(self, keep_lost: bool = True) -> int:
        """Rewrite this manifest as its compacted snapshot (see
        :func:`compact_manifest`); the writer keeps appending to the
        same path afterwards. Returns the number of records kept."""
        return compact_manifest(self.dir, keep_lost=keep_lost)


def load_server_state(manifest_dir: str) -> Tuple[object, object,
                                                  Dict[str, Any]]:
    """(template_ma, config, pool_kwargs-from-latest-server-record)."""
    with open(os.path.join(manifest_dir, SERVER_PICKLE), "rb") as fh:
        blob = pickle.load(fh)
    server_recs = [r for r in read_manifest(manifest_dir)
                   if r.get("kind") == "server"]
    if not server_recs:
        raise ValueError(
            f"manifest at {manifest_dir!r} has no server record")
    kw = {k: v for k, v in server_recs[-1].items()
          if k not in ("kind", "t", "epoch", "compacted",
                       "compacted_from")}
    return blob["template_ma"], blob["config"], kw


def outstanding_tenants(manifest_dir: str) -> Tuple[List[Dict[str, Any]],
                                                    List[Dict[str, Any]]]:
    """Resolve the recovery set: tenants admitted but never finalized.

    Returns ``(recoverable, lost)`` admit-record lists. A tenant is
    *outstanding* when its latest admit (per spool_dir for spooled
    tenants, per (epoch, tenant id) otherwise) has no matching ``done``
    in the same epoch; it is *recoverable* when it was spooled with a
    pickled model (in-memory tenants' drained records died with the
    process — they are reported as lost, not silently dropped)."""
    epoch = -1
    # keyed by logical identity; values (admit_record, done_seen)
    jobs: Dict[object, List] = {}
    for r in read_manifest(manifest_dir):
        kind = r.get("kind")
        if kind == "server":
            epoch += 1
        elif kind == "admit":
            key = r.get("spool_dir") or ("mem", epoch, r.get("tenant"))
            jobs[key] = [dict(r, epoch=epoch), False]
        elif kind == "done":
            for key, v in jobs.items():
                if (v[0].get("tenant") == r.get("tenant")
                        and v[0]["epoch"] == epoch):
                    v[1] = True
    recoverable, lost = [], []
    for v in jobs.values():
        rec, done = v
        if done:
            continue
        if rec.get("spool_dir") and rec.get("model_file"):
            recoverable.append(rec)
        else:
            lost.append(rec)
    return recoverable, lost


def load_tenant_model(manifest_dir: str, admit_record: Dict[str, Any]):
    with open(os.path.join(manifest_dir, admit_record["model_file"]),
              "rb") as fh:
        return pickle.load(fh)


def compact_manifest(manifest_dir: str, keep_lost: bool = True) -> int:
    """Rewrite ``manifest.jsonl`` as its minimal recovery-equivalent
    snapshot: ONE ``server`` record (the latest epoch's geometry,
    stamped ``compacted=true`` + the dropped-record count) followed by
    every OUTSTANDING tenant's admit and its latest checkpoint.
    Unreferenced ``model_*.pkl`` blobs are deleted.

    The journal grows without bound in steady state — every admission
    of a spooled tenant pickles its model beside the log, and a
    long-lived pool accumulates epochs of finished tenants a recovery
    must parse past — so a failed-over pool's cold start pays for dead
    history. Compaction preserves exactly the recovery-relevant
    state: ``outstanding_tenants`` + ``load_server_state`` over the
    compacted file answer identically to the full journal, so
    ``ChainServer.recover`` from either is **bitwise the same run**
    (pinned in tests/test_torch_faults.py). Containment history (fault
    / quarantine / reinit records) is postmortem evidence, not recovery
    state, and is dropped.

    ``keep_lost=False`` additionally drops LOST admits (in-memory
    tenants whose records died with a crashed process): only the
    ``recover()``-time compaction passes it — recovery has already
    surfaced those jobs on ``lost_tenants``, so keeping their admits
    would just re-report the same loss at every future recovery,
    forever.

    Atomic: written to a temp file and ``os.replace``d, so a crash
    mid-compaction leaves the full journal in place. Returns the
    number of records in the compacted file."""
    records = read_manifest(manifest_dir)
    server_recs = [r for r in records if r.get("kind") == "server"]
    if not server_recs:
        return 0   # nothing to compact (empty/foreign dir)
    recoverable, lost = outstanding_tenants(manifest_dir)
    outstanding = recoverable + (lost if keep_lost else [])
    # latest checkpoint per outstanding (epoch, tenant) pair — the
    # resume point recovery reads. Epochs are tracked the same way
    # outstanding_tenants walks them.
    latest_ckpt: Dict[Any, Dict[str, Any]] = {}
    epoch = -1
    for r in records:
        kind = r.get("kind")
        if kind == "server":
            epoch += 1
        elif kind == "checkpoint":
            latest_ckpt[(epoch, r.get("tenant"))] = r
    head = dict(server_recs[-1])
    head["compacted"] = True
    head["compacted_from"] = len(records)
    head["epoch"] = 0
    out: List[Dict[str, Any]] = [head]
    keep_models = set()
    for rec in outstanding:
        admit = {k: v for k, v in rec.items() if k != "epoch"}
        out.append(admit)
        if rec.get("model_file"):
            keep_models.add(rec["model_file"])
        ck = latest_ckpt.get((rec["epoch"], rec.get("tenant")))
        if ck is not None:
            out.append(ck)
    path = os.path.join(manifest_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    from gibbs_student_t_tpu_torch.obs.metrics import _jsonable

    with open(tmp, "w") as fh:
        for r in out:
            fh.write(json.dumps(_jsonable(r), separators=(",", ":"))
                     + "\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    for name in os.listdir(manifest_dir):
        if (name.startswith("model_") and name.endswith(".pkl")
                and name not in keep_models):
            try:
                os.unlink(os.path.join(manifest_dir, name))
            except OSError:
                pass
    # the content-addressed store: digests no
    # outstanding admit references are dead weight too
    mdir = os.path.join(manifest_dir, MODELS_DIR)
    if os.path.isdir(mdir):
        for name in os.listdir(mdir):
            if (name.endswith(".pkl")
                    and os.path.join(MODELS_DIR, name)
                    not in keep_models):
                try:
                    os.unlink(os.path.join(mdir, name))
                except OSError:
                    pass
    return len(out)
