"""Streaming chain output: spool sampler records to disk chunk by chunk.

Counterpart of ``gibbs_student_t_tpu/utils/spool.py``. A
:class:`ChainSpool` appends each chunk's decoded float32 rows to one spool
file per recorded field (utils/spoolfile.py, the JAX package's file
format) and checkpoints the chunk-end state, so host memory stays
O(chunk) and a killed run resumes from its last chunk boundary::

    state, sweep, seed = load_spool_state(spool_dir)
    sampler.sample(niter=..., seed=seed, state=state, start_sweep=sweep,
                   spool_dir=spool_dir)

The directory holds ``<field>.spool`` per recorded field, ``state.npz``
(utils/checkpoint.py), ``meta.json`` (the keys of the JAX package's:
``fields``, ``seed``, ``base``, ``record_mode``, ``record_thin``,
``recycle``, ``extra``) and, under ``reinit_diverged``,
``run_stats.json``. Either package reads a spool directory the other
wrote. With a ``fault_key`` (a serving tenant's name or id), the serving
fault harness's points (serve/faults.py) arm inside
:meth:`ChainSpool.append`: ``spool_io`` before the rows are written, and
``kill_before_checkpoint`` / ``kill_after_checkpoint`` on either side of
the state checkpoint.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from gibbs_student_t_tpu_torch.backends.base import ChainResult
from gibbs_student_t_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from gibbs_student_t_tpu_torch.utils.spoolfile import SpoolWriter, read_spool

_CHAIN_KEYS = {
    "x": "chain", "b": "bchain", "z": "zchain", "theta": "thetachain",
    "alpha": "alphachain", "df": "dfchain", "pout": "poutchain",
}


class ChainSpool:
    """Directory of per-field spool files plus a rolling state checkpoint.

    ``resume=True`` appends to an existing spool directory instead of
    truncating it; ``resume_at`` is the checkpointed sweep being resumed
    from, and rows past it (a killed run's orphans) are cut off before
    appending. ``record_mode``, ``record_thin`` and ``recycle`` are kept
    in ``meta.json``, and a resume that changes them is refused
    (``recycle=None`` skips its check, as a solo run passes it).
    ``extra_meta`` is JSON-able run metadata (the ensemble's per-pulsar
    TOA counts) that :func:`load_spool` replays into the result's
    ``stats``. ``fault_key`` is the serving fault-injection identity
    (serve/faults.py): when set, :meth:`append` fires ``spool_io``,
    ``kill_before_checkpoint`` and ``kill_after_checkpoint`` for it, the
    deterministic stand-ins for a disk-full error and a process kill on
    either side of the checkpoint write."""

    def __init__(self, path: str, seed: int, resume: bool = False,
                 resume_at: Optional[int] = None,
                 record_mode: Optional[str] = None,
                 record_thin: int = 1,
                 recycle: Optional[bool] = None,
                 extra_meta: Optional[Dict] = None,
                 fault_key=None):
        self.path = path
        self.seed = seed
        self.resume = resume
        self.resume_at = resume_at
        self.record_mode = record_mode
        self.recycle = recycle
        # spool rows are RECORDED sweeps, one per record_thin sweeps: the
        # sweep-indexed bookkeeping (base, resume_at) divides by it
        self.record_thin = int(record_thin)
        self.extra_meta = extra_meta
        self.fault_key = fault_key
        self._writers: Optional[Dict[str, SpoolWriter]] = None
        os.makedirs(path, exist_ok=True)

    def _check_resume(self, meta: Dict, fields) -> Optional[int]:
        """Refuse a resume that changes the run's recording; the rows to
        keep (``None``: all)."""
        if meta["fields"] != sorted(fields):
            raise ValueError(
                f"resume record fields {sorted(fields)} do not match the "
                f"spooled run's {meta['fields']}; use the same record= "
                "mode to resume")
        prior_mode = meta.get("record_mode")
        if (self.record_mode is not None and prior_mode is not None
                and prior_mode != self.record_mode):
            raise ValueError(
                f"resume record mode {self.record_mode!r} does not match "
                f"the spooled run's {prior_mode!r}")
        if meta.get("record_thin", 1) != self.record_thin:
            raise ValueError(
                f"resume record_thin {self.record_thin} does not match the "
                f"spooled run's {meta.get('record_thin', 1)}")
        prior_rec = meta.get("recycle")
        if (self.recycle is not None and prior_rec is not None
                and bool(prior_rec) != bool(self.recycle)):
            raise ValueError(
                f"resume recycle={bool(self.recycle)} does not match the "
                f"spooled run's {bool(prior_rec)}")
        if self.resume_at is None:
            return None
        base = meta.get("base", 0)
        if (self.resume_at - base) % self.record_thin:
            raise ValueError(
                f"resume_at={self.resume_at} is not on a recorded-sweep "
                f"boundary (base {base}, thin {self.record_thin})")
        keep_rows = (self.resume_at - base) // self.record_thin
        if keep_rows < 0:
            raise ValueError(f"resume_at={self.resume_at} predates the "
                             f"spool's first sweep ({base})")
        return keep_rows

    def append(self, records: Dict[str, np.ndarray], state, sweep: int,
               run_stats: Optional[Dict] = None) -> None:
        """``records[field]`` is ``(chunk rows, *batch, ...)``; ``sweep``
        is the index of the first sweep after this chunk (the resume
        point); ``state`` the state there (tensors or numpy arrays).
        ``run_stats`` (the running re-init count) is kept beside the
        checkpoint so a resumed run's counters stay cumulative."""
        self._fire("spool_io")
        if self._writers is None:
            meta_path = os.path.join(self.path, "meta.json")
            chunk_len = len(next(iter(records.values())))
            keep_rows = None
            if self.resume and os.path.exists(meta_path):
                with open(meta_path) as fh:
                    keep_rows = self._check_resume(json.load(fh), records)
            else:
                base = sweep - chunk_len * self.record_thin
                with open(meta_path, "w") as fh:
                    json.dump({"fields": sorted(records),
                               "seed": self.seed, "base": base,
                               "record_mode": self.record_mode,
                               "record_thin": self.record_thin,
                               "recycle": self.recycle,
                               "extra": self.extra_meta or {}}, fh)
            self._writers = {
                f: SpoolWriter(os.path.join(self.path, f + ".spool"),
                               trailing_shape=a.shape[1:], dtype=a.dtype,
                               append=self.resume, keep_rows=keep_rows)
                for f, a in records.items()}
        for f, a in records.items():
            self._writers[f].append(a)
            self._writers[f].flush()
        # a kill here leaves orphan rows past the last checkpoint, which a
        # resume cuts off; a kill after it resumes from this sweep
        self._fire("kill_before_checkpoint")
        save_checkpoint(os.path.join(self.path, "state.npz"), state, sweep,
                        self.seed)
        self._fire("kill_after_checkpoint")
        if run_stats is not None:
            tmp = os.path.join(self.path, "run_stats.json.tmp")
            with open(tmp, "w") as fh:
                json.dump(run_stats, fh)
            os.replace(tmp, os.path.join(self.path, "run_stats.json"))

    def _fire(self, point: str) -> None:
        if self.fault_key is not None:
            # imported here: the serve package imports this module
            from gibbs_student_t_tpu_torch.serve import faults

            faults.fire(point, tenant=self.fault_key)

    def close(self) -> None:
        if self._writers is not None:
            for w in self._writers.values():
                w.close()
            self._writers = None

    def load_run_stats(self) -> Dict:
        """Cumulative run counters of a prior (interrupted) run in this
        directory, or {} for a fresh one."""
        return load_run_stats(self.path)


def load_run_stats(path: str) -> Dict:
    stats_path = os.path.join(path, "run_stats.json")
    if not os.path.exists(stats_path):
        return {}
    with open(stats_path) as fh:
        return json.load(fh)


def load_spool(path: str) -> ChainResult:
    """A :class:`ChainResult` from a spool directory, including the
    readable prefix of an interrupted run."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    cols = {f: read_spool(os.path.join(path, f + ".spool"))
            for f in meta["fields"]}
    # a kill mid-append can leave fields at different lengths: trim to the
    # common prefix so every array stays sweep-aligned
    nmin = min(len(a) for a in cols.values())
    cols = {f: a[:nmin] for f, a in cols.items()}
    chains = {_CHAIN_KEYS[f]: cols.pop(f)
              for f in list(cols) if f in _CHAIN_KEYS}
    # fields not spooled (record="light" runs) come back empty
    empty = np.zeros((0,))
    for key in _CHAIN_KEYS.values():
        chains.setdefault(key, empty)
    if meta.get("record_mode") is not None:
        cols["record_mode"] = np.asarray(meta["record_mode"])
    if meta.get("record_thin", 1) != 1:
        cols["record_thin"] = np.asarray(meta["record_thin"])
    for k, v in meta.get("extra", {}).items():
        cols[k] = np.asarray(v)
    return ChainResult(**chains, stats=cols)


def load_spool_prefix(path: str, field: str, upto_sweep: int):
    """``(rows, base)`` for one spooled field: its rows strictly below
    sweep ``upto_sweep`` (a killed run's orphans excluded, as a resume cuts
    them) and the spool's first sweep; ``None`` when the field was never
    spooled (``record="light"``) or no ``meta.json`` exists yet."""
    meta_path = os.path.join(path, "meta.json")
    fpath = os.path.join(path, field + ".spool")
    if not (os.path.exists(meta_path) and os.path.exists(fpath)):
        return None
    with open(meta_path) as fh:
        meta = json.load(fh)
    if field not in meta.get("fields", []):
        return None
    base = meta.get("base", 0)
    keep = (upto_sweep - base) // meta.get("record_thin", 1)
    if keep <= 0:
        return None
    rows = read_spool(fpath)
    return rows[:min(keep, len(rows))], base


def load_spool_state(path: str, device=None):
    """``(state, next_sweep, seed)`` from a spool directory's checkpoint,
    the state on ``device`` (``None``: CUDA, raising without it)."""
    return load_checkpoint(os.path.join(path, "state.npz"), device=device)
