"""Recycling Gibbs: partial-scan states as extra posterior rows.

Counterpart of ``gibbs_student_t_tpu/parallel/recycle.py``. A
systematic-scan Gibbs sampler leaves the target invariant after every
block update, not only at scan ends (arXiv:1611.07056), so the
intermediate ("partial-scan") states a sweep computes are valid posterior
samples, and averaging an estimator over all of them can only lower its
variance.

The sweep (``TorchGibbs._sweep``: white x, hyper x, b, theta, z, alpha,
df) updates each recorded field in exactly one block, which has two
consequences:

- **The partial-scan states are free.** A mid-scan state's fields each
  equal the same field of an adjacent recorded scan-end row: the fields
  updated so far carry the next row's value, the others the previous
  row's. The recycled rows are rebuilt from the recorded chain: no kernel
  work, no bytes moved.
- **Per-parameter marginals gain no draws.** Each coordinate takes one new
  value a sweep either way, so per-parameter ESS is unchanged, and the
  streaming monitor's ESS and R-hat ignore recycled rows. The gain is on
  cross-block functionals (an outlier count times a noise amplitude, say):
  the recycled stream averages over combinations the scan-end stream
  never holds.

The serving drain tags recycled rows with a row-class array
(``ROW_SCAN_END`` / ``ROW_RECYCLED``) beside each quantum's records, so
the spool, ``on_chunk`` and result keep their scan-end contracts and a
consumer opts into the interleaved view through :func:`interleave` or
:func:`recycled_result`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from gibbs_student_t_tpu_torch.backends.torch_backend import (
    RECYCLE_EARLY_FIELDS,
    RECYCLE_LATE_FIELDS,
)
from gibbs_student_t_tpu_torch.parallel.diagnostics import ROW_SCAN_END

__all__ = ["ROW_SCAN_END", "ROW_RECYCLED", "RECYCLE_EARLY_FIELDS",
           "RECYCLE_LATE_FIELDS", "row_class_pattern", "interleave",
           "recycle_weights", "weighted_moments", "functional_ess",
           "recycled_result"]

#: the row class (uint8) of a rebuilt partial-scan state; a recorded
#: scan-end state is ``ROW_SCAN_END``
ROW_RECYCLED = 1

#: result field -> record field (utils/spool._CHAIN_KEYS, inverted)
_RESULT_KEYS = {
    "chain": "x", "bchain": "b", "zchain": "z", "thetachain": "theta",
    "alphachain": "alpha", "dfchain": "df", "poutchain": "pout",
}


def row_class_pattern(rows: int, carry_in: bool) -> np.ndarray:
    """The ``(2*rows-1 (+1),)`` uint8 row classes of one drained quantum
    of ``rows`` scan-end rows: scan-end rows with the recycled mid-scan
    rows between them. ``carry_in`` prepends the boundary mid-row between
    the previous quantum's last row and this one's first, so the recycled
    stream of a cancelled or evicted tenant is a prefix of its
    uninterrupted run's."""
    if rows < 1:
        return np.zeros(0, np.uint8)
    out = np.zeros(2 * rows - 1 + (1 if carry_in else 0), np.uint8)
    out[(1 if carry_in else 0) + 1::2] = ROW_RECYCLED
    if carry_in:
        out[0] = ROW_RECYCLED
    return out


def interleave(cols: Dict[str, np.ndarray],
               prev_tail: Optional[Dict[str, np.ndarray]] = None,
               ) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                          Dict[str, np.ndarray]]:
    """The recycled (interleaved) view of one span of records ``{field:
    (rows, nchains, ...)}``.

    Returns ``(cols_out, row_class, tail)``: ``cols_out`` has ``2*rows-1``
    rows (``+1`` with a ``prev_tail``), scan-end and recycled states in
    turn; ``row_class`` tags them; ``tail`` is each field's last scan-end
    row, to pass as the next span's ``prev_tail``. A recycled row takes
    the early fields (x, b, the acceptances) from the next scan-end row
    and the late fields (theta, z, alpha, pout, df) from the previous one;
    a field of neither group follows the late group."""
    fields = list(cols)
    rows = len(next(iter(cols.values()))) if fields else 0
    if rows == 0:
        return dict(cols), np.zeros(0, np.uint8), dict(prev_tail or {})
    carry = prev_tail is not None and bool(prev_tail)
    out = {}
    for f, a in cols.items():
        a = np.asarray(a)
        n_out = 2 * rows - 1 + (1 if carry else 0)
        buf = np.empty((n_out,) + a.shape[1:], a.dtype)
        base = 0
        if carry:
            # the boundary mid-row: early fields from this span's first
            # row, late fields from the previous span's last
            buf[0] = (a[0] if f in RECYCLE_EARLY_FIELDS
                      else prev_tail[f])
            base = 1
        buf[base::2] = a
        if rows > 1:
            if f in RECYCLE_EARLY_FIELDS:
                buf[base + 1::2] = a[1:]
            else:
                buf[base + 1::2] = a[:-1]
        out[f] = buf
    tail = {f: np.array(np.asarray(a)[-1]) for f, a in cols.items()}
    return out, row_class_pattern(rows, carry), tail


def recycle_weights(row_class: np.ndarray) -> np.ndarray:
    """Per-row weights of the recycling estimator over an interleaved
    stream: uniform over every state (the paper's equal-weight average),
    summing to 1."""
    row_class = np.asarray(row_class)
    n = row_class.shape[0]
    if n == 0:
        return np.zeros(0)
    return np.full(n, 1.0 / n)


def weighted_moments(window: np.ndarray, weights: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted (mean, variance) over the leading row axis, the recycling
    estimator's moments (weights from :func:`recycle_weights`). Uniform
    weights give ``window.mean(axis=0)`` and ``window.var(axis=0)``."""
    window = np.asarray(window, np.float64)
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    wb = w.reshape((-1,) + (1,) * (window.ndim - 1))
    mean = (wb * window).sum(axis=0)
    var = (wb * (window - mean) ** 2).sum(axis=0)
    return mean, var


def functional_ess(values: np.ndarray) -> float:
    """ESS of a scalar functional's stream ``(rows,)`` or ``(rows,
    nchains)``: evaluate a cross-block functional on the interleaved and
    on the scan-end stream to measure what recycling buys."""
    from gibbs_student_t_tpu_torch.parallel.diagnostics import (
        effective_sample_size,
    )

    return effective_sample_size(np.asarray(values, np.float64))


def recycled_result(res) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """The interleaved view of a finished ``ChainResult``: ``({field:
    (rows', nchains, ...)}, row_class)`` over every non-empty chain field.
    The result's own arrays are untouched (they are scan-end rows, bitwise
    the same with recycling off)."""
    cols = {}
    for res_key, field in _RESULT_KEYS.items():
        a = np.asarray(getattr(res, res_key))
        if a.size:
            cols[field] = a
    return interleave(cols)[:2]
