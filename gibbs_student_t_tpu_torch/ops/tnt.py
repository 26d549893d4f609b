"""Fused inner products of the marginalized likelihood, dense and blocked.

Counterpart of ``gibbs_student_t_tpu/ops/tnt.py``. Every sweep needs the
same three reductions over the TOA axis (reference gibbs.py:302-311):

    TNT = T^T N^-1 T        (m, m)
    d   = T^T N^-1 y        (m,)
    c   = -1/2 (sum log N + y^T N^-1 y)     (scalar)

with ``N = diag(nvec)``, per chain. ``T`` and ``y`` are shared by every
chain and ``nvec`` is ``(C, n)``. The dense form (:func:`tnt_products`
without a block size, the flagship's n = 130) is one batched product,
left to ``torch.matmul`` at full float32 (TF32 is off, see the package
``__init__``) as the JAX package leaves it to XLA. The TOA-blocked form
(the 1e5-TOA stress path) is :func:`tnt_batched`: one launch of
``csrc/tnt.cu`` on a CUDA device (replacing
``gibbs_student_t_tpu/ops/pallas_tnt.py::_tnt_kernel``), and the blocked
loop of :func:`tnt_products`, its plain version, on the CPU. The kernel
computes the lower triangle of the weighted Gram of ``[T | y]`` as one
product of the chains' weights with the pairs' basis products; the pair
table is :func:`pair_index`. :func:`tnt_lanes` is the serving slot pool's
reduction, one basis per 16-lane group and one launch of a kernel of its
own for every group (replacing ``pallas_tnt.py::tnt_lanes_pallas``): it
cuts the Gram into the 16 x 16 tiles of :func:`lanes_tiles` and writes
TNT, d and the constant straight from the sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gibbs_student_t_tpu_torch.ops.chol import SM_COUNT
from gibbs_student_t_tpu_torch.ops.lanes import (
    check_lanes_gid,
    flat_lanes,
    lane_tiles,
    lead_dims,
)


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


#: pairs per tile of the Gram kernel (``TNT_BN`` in csrc/tnt.cu)
PAIR_TILE = 128
_DEVICE_PAIRS = {}


def pair_index(m: int) -> np.ndarray:
    """The pairs ``(i, j)``, ``i >= j``, of the lower triangle of the
    ``(m + 1) x (m + 1)`` Gram of ``[T | y]``, row by row (pair
    ``q = i (i + 1) / 2 + j``), as an int32 ``(2, Qpad)`` table: row 0 the
    ``i``, row 1 the ``j``. ``Q = (m + 1)(m + 2) / 2`` is padded to a whole
    number of tiles with ``(m, m)``, the ``y w y`` slot, which is in range
    and whose sums the kernel drops, as it drops the padding's."""
    i, j = np.tril_indices(m + 1)
    pad = -len(i) % PAIR_TILE
    return np.stack([np.concatenate([i, np.full(pad, m)]),
                     np.concatenate([j, np.full(pad, m)])]).astype(np.int32)


def _device_pair_index(m: int, device) -> torch.Tensor:
    """:func:`pair_index` on ``device``, made once per ``(m, device)``."""
    key = (m, str(device))
    if key not in _DEVICE_PAIRS:
        _DEVICE_PAIRS[key] = torch.from_numpy(pair_index(m)).to(device)
    return _DEVICE_PAIRS[key]


#: rows and columns of a Gram tile of the lanes kernel (``TNT_LT``)
LANES_TILE = 16
#: most tiles a block of the lanes kernel takes (``TNT_LANES_MAX_PER_BLOCK``)
LANES_MAX_PER_BLOCK = 4
_DEVICE_TILES = {}


def lanes_tiles(m: int) -> np.ndarray:
    """The 16 x 16 tiles ``(I0, J0)``, ``I0 >= J0``, that cover the lower
    triangle of the ``(m + 1) x (m + 1)`` Gram of ``[T | y]``, row by row,
    as an int32 ``(2, R (R + 1) / 2)`` table of their first row and column,
    ``R = ceil((m + 1) / 16)``. Each pair ``(i, j)``, ``i >= j``, lies in
    exactly one tile; the lanes kernel writes it to TNT (and its mirror,
    the same float) or, for ``i = m``, to d, and drops ``(m, m)`` and the
    padding (tests/test_torch_tnt.py)."""
    R = -(-(m + 1) // LANES_TILE)
    I, J = np.tril_indices(R)
    return (np.stack([I, J]) * LANES_TILE).astype(np.int32)


def lanes_form(G: int, m: int) -> int:
    """Tiles per block of the lanes kernel for ``G`` groups at size ``m``:
    the most (up to :data:`LANES_MAX_PER_BLOCK` and the group's tile
    count; fewer restagings of each group's basis) that still gives every
    SM of the card a block. At the pool's shape on an H100, one tile a
    block takes 1.8x the time of four (PERF.md)."""
    if m < 1:
        raise ValueError(f"tnt_lanes: m = {m} < 1")
    ntiles = lanes_tiles(m).shape[1]
    for per_block in (4, 2):
        if (per_block <= ntiles
                and G * -(-ntiles // per_block) >= SM_COUNT):
            return per_block
    return 1


def _device_lanes_tiles(m: int, device) -> torch.Tensor:
    """:func:`lanes_tiles` on ``device``, made once per ``(m, device)``."""
    key = (m, str(device))
    if key not in _DEVICE_TILES:
        _DEVICE_TILES[key] = torch.from_numpy(lanes_tiles(m)).to(device)
    return _DEVICE_TILES[key]


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data on a 16-byte boundary (the kernel
    copies T and y in 16-byte pieces)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _dense(T, y, nvec):
    w = 1.0 / nvec                                  # (C, n)
    if T.dim() == 3:
        # one basis per pulsar, T (P, n, m), y (P, 1, n), nvec (P, C, n):
        # the weighted basis is built transposed, (P, C, m, n), so that
        # its chains fold into the rows of one product per pulsar with T
        # (a broadcast batch would copy T once per chain). That product is
        # (T w)^T T, whose transpose (a view) is T^T (T w) with the same
        # products as the single-model form below
        P, C, n = nvec.shape
        m = T.shape[-1]
        TwT = T.transpose(-1, -2)[:, None] * w[..., None, :]
        TNT = torch.matmul(TwT.reshape(P, C * m, n), T).reshape(
            P, C, m, m).transpose(-1, -2)
    else:
        Tw = T * w[..., :, None]                    # (C, n, m)
        TNT = torch.matmul(T.transpose(-1, -2), Tw)  # (C, m, m)
    d = torch.matmul(y * w, T)                      # (C, m)
    const = -0.5 * (torch.log(nvec).sum(-1) + (y * y * w).sum(-1))
    return TNT, d, const


def tnt_products(T, y, nvec, block_size: Optional[int] = None):
    """``(TNT, d, const_white)`` for every chain: ``T (n, m)``, ``y (n,)``,
    ``nvec (C, n)`` -> ``(C, m, m)``, ``(C, m)``, ``(C,)``; or, dense, one
    basis per pulsar of an ensemble: ``T (P, n, m)``, ``y (P, 1, n)``,
    ``nvec (P, C, n)`` -> ``(P, C, m, m)``, ``(P, C, m)``, ``(P, C)``.

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


def tnt_batched(T, y, nvec, block_size: int):
    """``(TNT, d, const_white)`` of the TOA-blocked reduction, shapes as in
    :func:`tnt_products`, float32: one launch of the Gram kernel covering
    every TOA block on a CUDA device (``w = 1/nvec`` on the way in, the
    constant in PyTorch), the blocked :func:`tnt_products` on the CPU.
    ``n`` must be a multiple of ``block_size`` (:func:`pad_rows`); padded
    rows carry ``T = 0``, ``y = 0``, ``nvec = 1`` and add exactly zero."""
    for t in (T, y, nvec):
        if t.dtype != torch.float32:
            raise ValueError(f"tnt_batched: float32 only, got {t.dtype}")
        if t.device != nvec.device:
            raise ValueError("tnt_batched: operands on different devices")
    n, m = T.shape
    C = nvec.shape[0]
    if y.shape != (n,) or nvec.shape != (C, n):
        raise ValueError("tnt_batched: inconsistent operand shapes")
    if n % block_size != 0:
        raise ValueError(
            f"tnt_batched needs n ({n}) to be a multiple of block_size "
            f"({block_size}); use pad_rows first")
    if nvec.device.type == "cpu":
        return tnt_products(T, y, nvec, block_size)
    if nvec.device.type != "cuda":
        raise RuntimeError(f"tnt_batched: no kernel for device {nvec.device}")
    from gibbs_student_t_tpu_torch.ops import _cuda

    w = 1.0 / nvec
    # y^T N^-1 y as one matrix-vector product: a pass less over (C, n)
    # than the plain version's elementwise product and sum
    const = -0.5 * (torch.log(nvec).sum(-1) + torch.mv(w, y * y))
    TNT = torch.empty((C, m, m), dtype=T.dtype, device=T.device)
    d = torch.empty((C, m), dtype=T.dtype, device=T.device)
    if C:
        lib = _cuda.lib()
        pairs = _device_pair_index(m, T.device)
        work = torch.empty((lib.gst_tnt_workspace(C, n, m),), dtype=T.dtype,
                           device=T.device)
        Tc, yc = _aligned16(T), _aligned16(y)
        _cuda.check(lib.gst_tnt_batched(
            _cuda.ptr(Tc), _cuda.ptr(yc), _cuda.ptr(w), _cuda.ptr(pairs),
            pairs.shape[1], _cuda.ptr(work), _cuda.ptr(TNT), _cuda.ptr(d),
            C, n, m, _cuda.stream(T.device)), "tnt_batched")
        tnt_batched.launches += 1
    return TNT, d, const


tnt_batched.launches = 0


def _tnt_lanes_operands(T, y, nvec, gid):
    """``(T_g (G, nT, m), y_g (G, nT), nvec (G, 16, n), lead)``: the basis
    of each tile's first lane and the lanes as tiles."""
    lead = lead_dims(nvec, 1, "tnt_lanes")
    check_lanes_gid(flat_lanes(nvec, lead), gid, "tnt_lanes")
    for t in (T, y, nvec):
        if t.dtype != torch.float32:
            raise ValueError(f"tnt_lanes: float32 only, got {t.dtype}")
        if t.device != nvec.device:
            raise ValueError("tnt_lanes: operands on different devices")
    nv = lane_tiles(nvec, lead)
    Tg = lane_tiles(T, lead)[:, 0]
    yg = lane_tiles(y, lead)[:, 0]
    G, _, n = nv.shape
    nT = Tg.shape[-2]
    if Tg.shape[0] != G or yg.shape != (G, nT) or n > nT:
        raise ValueError("tnt_lanes: inconsistent operand shapes")
    return Tg, yg, nv


def tnt_lanes_plain(T, y, nvec, gid):
    """The plain version of :func:`tnt_lanes`: the dense per-basis product
    of :func:`tnt_products` (the ensemble's) on the first ``n`` rows of
    each tile's basis, which on the CPU gives each group the solo
    sampler's products bit for bit (tests/test_torch_lanes.py)."""
    Tg, yg, nv = _tnt_lanes_operands(T, y, nvec, gid)
    n, m = nv.shape[-1], Tg.shape[-1]
    TNT, d, const = tnt_products(Tg[:, :n], yg[:, None, :n], nv)
    lanes = nvec.shape[:-1]
    return (TNT.reshape(*lanes, m, m), d.reshape(*lanes, m),
            const.reshape(lanes))


def tnt_lanes(T, y, nvec, gid):
    """``(TNT, d, const_white)`` for the serving slot pool's lanes, one
    basis per 16-lane group (the JAX package's ``pallas_tnt.py::
    tnt_lanes_pallas``): per-lane ``T (B, nT, m)``, ``y (B, nT)`` and
    ``nvec (B, n)``, ``n <= nT``, each with its lanes flat or as
    ``(B/16, 16, ...)`` tiles, under the tile-uniform ``gid (B,)``
    contract (``ops/lanes.py``), so the basis of a tile's first lane is
    the tile's. The first ``n`` rows of the basis are reduced; the pool
    stores each group's basis at ``n`` rows, once, at admission. Returns
    ``(B, m, m)``, ``(B, m)``, ``(B,)`` in ``nvec``'s lane layout.

    On a CUDA device: one launch of the lanes kernel for every group
    (``csrc/tnt.cu gst_tnt_lanes``; the JAX entry launches once per
    group), which forms ``w = 1/nvec`` and writes TNT (both triangles, the
    same float in each), d and the constant; counted on
    ``tnt_lanes.launches``. On the CPU, :func:`tnt_lanes_plain`."""
    if nvec.device.type == "cpu":
        return tnt_lanes_plain(T, y, nvec, gid)
    Tg, yg, nv = _tnt_lanes_operands(T, y, nvec, gid)
    if nvec.device.type != "cuda":
        raise RuntimeError(f"tnt_lanes: no kernel for device {nvec.device}")
    from gibbs_student_t_tpu_torch.ops import _cuda

    G, C, n = nv.shape
    m = Tg.shape[-1]
    # each basis is read as rows of m floats from its group's offset: a
    # broadcast or strided group axis needs no copy
    if Tg.stride()[1:] != (m, 1):
        Tg = Tg.contiguous()
    if yg.stride(1) != 1:
        yg = yg.contiguous()
    nv = nv.contiguous()
    B = G * C
    TNT = torch.empty((B, m, m), dtype=T.dtype, device=T.device)
    d = torch.empty((B, m), dtype=T.dtype, device=T.device)
    const = torch.empty((B,), dtype=T.dtype, device=T.device)
    if B:
        tiles = _device_lanes_tiles(m, T.device)
        _cuda.check(_cuda.lib().gst_tnt_lanes(
            _cuda.ptr(Tg), _cuda.ptr(yg), _cuda.ptr(nv), _cuda.ptr(tiles),
            tiles.shape[1], _cuda.ptr(TNT), _cuda.ptr(d), _cuda.ptr(const),
            B, n, m, Tg.stride(0), yg.stride(0), lanes_form(G, m),
            _cuda.stream(T.device)), "tnt_lanes")
        tnt_lanes.launches += 1
    lanes = nvec.shape[:-1]
    return (TNT.reshape(*lanes, m, m), d.reshape(*lanes, m),
            const.reshape(lanes))


tnt_lanes.launches = 0


def matvec_blocked(T, b, block_size: Optional[int] = None):
    """``T @ b`` for batched ``b (C, m)`` -> ``(C, n)``, optionally row-blocked
    (same padding contract as :func:`tnt_products`); with one basis per
    pulsar, ``T (P, n, m)`` and ``b (P, C, m)`` -> ``(P, C, n)``, one
    product per pulsar."""
    if block_size is None:
        return torch.matmul(b, T.transpose(-1, -2))
    n = T.shape[-2]
    return torch.cat([torch.matmul(b, T[..., k:k + block_size, :]
                                   .transpose(-1, -2))
                      for k in range(0, n, block_size)], dim=-1)


def auto_block_size(n: int, threshold: int = 16384,
                    block: int = 4096) -> Optional[int]:
    """Default policy: dense below ``threshold`` TOAs, blocked above."""
    return None if n < threshold else block
