"""Fused inner products of the marginalized likelihood, dense and blocked.

Counterpart of ``gibbs_student_t_tpu/ops/tnt.py``. Every sweep needs the
same three reductions over the TOA axis (reference gibbs.py:302-311):

    TNT = T^T N^-1 T        (m, m)
    d   = T^T N^-1 y        (m,)
    c   = -1/2 (sum log N + y^T N^-1 y)     (scalar)

with ``N = diag(nvec)``, per chain. ``T`` and ``y`` are shared by every
chain and ``nvec`` is ``(C, n)``. The dense form is one batched product;
the blocked form loops over TOA blocks so live memory per chain is
``O(block x m)`` (the 1e5-TOA stress shape). No hand-written kernel sits
here: the JAX package leaves the product to XLA on the main path, and the
port leaves it to ``torch.matmul`` at full float32 (TF32 is off, see the
package ``__init__``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def pad_rows(T: np.ndarray, y: np.ndarray,
             block_size: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Zero-pad the TOA axis to a multiple of ``block_size``.

    Returns ``(T_pad, y_pad, n_pad)``; padded rows must carry ``nvec = 1``
    so they add exactly zero to TNT, d and the white constant."""
    n = T.shape[0]
    n_pad = (-n) % block_size
    if n_pad == 0:
        return T, y, 0
    T_pad = np.concatenate([T, np.zeros((n_pad, T.shape[1]), T.dtype)])
    y_pad = np.concatenate([y, np.zeros(n_pad, y.dtype)])
    return T_pad, y_pad, n_pad


def _dense(T, y, nvec):
    w = 1.0 / nvec                                  # (C, n)
    Tw = T * w[..., :, None]                        # (C, n, m)
    TNT = torch.matmul(T.transpose(-1, -2), Tw)     # (C, m, m)
    d = torch.matmul(y * w, T)                      # (C, m)
    const = -0.5 * (torch.log(nvec).sum(-1) + (y * y * w).sum(-1))
    return TNT, d, const


def tnt_products(T, y, nvec, block_size: Optional[int] = None):
    """``(TNT, d, const_white)`` for every chain: ``T (n, m)``, ``y (n,)``,
    ``nvec (C, n)`` -> ``(C, m, m)``, ``(C, m)``, ``(C,)``.

    ``block_size=None`` is the dense path; with a block size the TOA axis
    (an exact multiple, see :func:`pad_rows`) is reduced block by block,
    equal to the dense result up to float reassociation."""
    if block_size is None:
        return _dense(T, y, nvec)
    n, m = T.shape
    if n % block_size != 0:
        raise ValueError(
            f"blocked tnt_products needs n ({n}) to be a multiple of "
            f"block_size ({block_size}); use pad_rows first")
    TNT = d = const = None
    for k in range(0, n, block_size):
        sl = slice(k, k + block_size)
        t, dd, c = _dense(T[sl], y[sl], nvec[..., sl])
        if TNT is None:
            TNT, d, const = t, dd, c
        else:
            TNT, d, const = TNT + t, d + dd, const + c
    return TNT, d, const


def matvec_blocked(T, b, block_size: Optional[int] = None):
    """``T @ b`` for batched ``b (C, m)`` -> ``(C, n)``, optionally row-blocked
    (same padding contract as :func:`tnt_products`)."""
    if block_size is None:
        return torch.matmul(b, T.transpose(0, 1))
    n = T.shape[0]
    return torch.cat([torch.matmul(b, T[k:k + block_size].transpose(0, 1))
                      for k in range(0, n, block_size)], dim=-1)


def auto_block_size(n: int, threshold: int = 16384,
                    block: int = 4096) -> Optional[int]:
    """Default policy: dense below ``threshold`` TOAs, blocked above."""
    return None if n < threshold else block
