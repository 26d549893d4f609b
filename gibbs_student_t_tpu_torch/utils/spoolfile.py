"""The chain spool file: an append-only file of typed rows, in Python.

Counterpart of the JAX package's native spool writer and reader
(``gibbs_student_t_tpu/native``, format in ``native/src/gst_native.cpp``
"chain spooler"); this package does not import it, and the file format is
the same byte for byte, so a spool written by either side is read
identically by the other. Layout, little-endian::

    8 bytes   magic  b"GSTSPOOL"
    u32       version (1)
    u32       itemsize (4: float32, 8: float64)
    u32       ndim of the trailing (per-row) shape
    u64 x ndim  the trailing shape
    ...       raw row-major rows

The number of rows is implied by the file size (a partial last row is not
a row), so the writer needs no footer and a killed run leaves a readable
prefix. ``flush`` hands the rows to the operating system, as the native
writer's ``fflush`` does; neither syncs the disk.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

MAGIC = b"GSTSPOOL"
VERSION = 1
#: the most trailing dimensions a reader accepts (the native reader's
#: shape buffer)
MAX_NDIM = 8
_DTYPES = {4: np.dtype(np.float32), 8: np.dtype(np.float64)}
_ITEMSIZE = {dt: size for size, dt in _DTYPES.items()}


def _header(itemsize: int, shape: Tuple[int, ...]) -> bytes:
    return (MAGIC + struct.pack("<III", VERSION, itemsize, len(shape))
            + struct.pack(f"<{len(shape)}Q", *shape))


def spool_info(path: str) -> Tuple[np.dtype, Tuple[int, ...], int, int]:
    """``(dtype, trailing shape, header bytes, rows)`` of a spool file;
    ``OSError`` when it cannot be opened or its header is bad."""
    with open(path, "rb") as fh:
        head = fh.read(20)
        ok = (len(head) == 20 and head[:8] == MAGIC)
        if ok:
            version, itemsize, ndim = struct.unpack("<III", head[8:])
            ok = (version == VERSION and itemsize in _DTYPES
                  and ndim <= MAX_NDIM)
        if ok:
            raw = fh.read(8 * ndim)
            ok = len(raw) == 8 * ndim
        if ok:
            shape = struct.unpack(f"<{ndim}Q", raw)
            row = itemsize * int(np.prod(shape, dtype=np.int64))
            ok = row > 0
        if not ok:
            raise OSError(f"bad spool header: {path}")
        total = fh.seek(0, os.SEEK_END)
    header = 20 + 8 * ndim
    return _DTYPES[itemsize], tuple(shape), header, (total - header) // row


def read_spool(path: str) -> np.ndarray:
    """A spool file as one array, leading axis the appended rows (a
    partial last row left by a killed writer is not read)."""
    dtype, shape, header, rows = spool_info(path)
    count = rows * int(np.prod(shape, dtype=np.int64))
    data = np.fromfile(path, dtype=dtype, offset=header, count=count)
    return data.reshape((rows,) + shape)


class SpoolWriter:
    """Append-only writer of rows of one trailing shape and dtype.

    ``append=True`` keeps an existing file's rows (the resume path); its
    header must match ``dtype`` and ``trailing_shape``. ``keep_rows``
    first truncates the file to that many rows: the checkpointed count, so
    rows a killed run appended past its last checkpoint (and a torn
    partial row) are dropped instead of shifting every later row. Errors
    are ``OSError``, as the native writer's are."""

    def __init__(self, path: str, trailing_shape: Sequence[int],
                 dtype=np.float32, append: bool = False,
                 keep_rows: Optional[int] = None):
        self.dtype = np.dtype(dtype)
        if self.dtype not in _ITEMSIZE:
            raise ValueError(f"spool rows are float32 or float64, not "
                             f"{self.dtype}")
        self.trailing_shape = tuple(int(s) for s in trailing_shape)
        if len(self.trailing_shape) > MAX_NDIM:
            raise ValueError(f"a spool row has at most {MAX_NDIM} "
                             f"dimensions, got {self.trailing_shape}")
        itemsize = _ITEMSIZE[self.dtype]
        self.row_bytes = itemsize * int(np.prod(self.trailing_shape,
                                                dtype=np.int64))
        if self.row_bytes == 0:
            raise ValueError("a spool row must hold at least one value")
        self._fh = None
        if append and os.path.exists(path):
            dtype_, shape, header, rows = spool_info(path)
            if dtype_ != self.dtype or shape != self.trailing_shape:
                raise OSError("spool header mismatch: existing file has a "
                              "different dtype/shape")
            if keep_rows is not None:
                if rows < keep_rows:
                    raise OSError("spool shorter than checkpoint: file has "
                                  "fewer rows than keep_rows")
                os.truncate(path, header + int(keep_rows) * self.row_bytes)
            self._fh = open(path, "ab")
            return
        self._fh = open(path, "wb")
        self._fh.write(_header(itemsize, self.trailing_shape))

    def append(self, rows: np.ndarray) -> None:
        """Append ``rows`` (leading axis = rows, then the trailing shape)."""
        rows = np.ascontiguousarray(rows, dtype=self.dtype)
        if rows.shape[1:] != self.trailing_shape:
            raise ValueError(
                f"row shape {rows.shape[1:]} != {self.trailing_shape}")
        self._fh.write(rows.reshape(-1).data)

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
