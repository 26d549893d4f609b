"""Counter-based Philox-4x32-10 draws, keyed per chain: the sweep's
randomness as a function of (seed, chain, sweep, stream tag, element).

Counterpart of ``gibbs_student_t_tpu/ops/rng.py`` (the jnp twin of the
native kernels' Philox stream) and of the JAX backend's per-chain keying
(``jax_backend.py``: ``random.split(PRNGKey(seed), nchains)[k]`` for chain
k, the sweep index folded in each sweep, the sweep vmapped over chains).
The JAX module's pieces are ported as they are: ``PHILOX_*``, the domain
tags ``TAG_GAMMA`` / ``TAG_BETA_A`` / ``TAG_BETA_B``, :func:`philox_4x32`,
the exact bits -> uniform map :func:`uniform_of_bits`, the per-chain
uniform pool :func:`philox_uniform_pool` and :func:`gamma_halfint_v2`.
Words are int64 tensors holding 32-bit values; a 32 x 32-bit product goes
through 16-bit limbs of the multiplier, so every partial product stays
below 2^49 and nothing relies on overflow.

The sweep's draws (the port's own layout; ``jax.random``'s threefry
streams are not reproduced):

- a chain's key is :func:`chain_key` ``(seed, chain)``: the two packed
  into 64 bits and passed through the splitmix64 finalizer, a bijection,
  split into two 32-bit words. ``TorchGibbs`` numbers its chains 0..C-1,
  the ensemble pulsar p's chain c as ``p * C + c`` (pulsar-major, as the
  JAX ensemble splits its keys), and the serving pool gives each lane its
  tenant chain's key;
- every random number is one Philox block under that key, at counters
  ``(ctr0, ctr1, ctr2, ctr3) = (element, attempt, tag, sweep)``: the
  element's index within its field (per chain), the Marsaglia-Tsang
  attempt (0 for every other draw), the field's tag (``SWEEP_TAGS``) and
  the sweep index. A gamma field holds one run of elements per shape
  column (theta's two shapes, alpha's two of n TOAs each): column c
  draws under tag + c, its elements numbered from 0, so TOA j's alpha
  gammas do not depend on the TOA padding. So chain k's numbers depend
  only on (seed, k, sweep): not on its position in the batch, nor on
  the number of chains;
- a uniform is word 0 through :func:`uniform_of_bits` (``(bits >> 9)
  2^-23 + 2^-24``, in (0, 1), exact in float32); a log-uniform is its
  log; Gumbel noise ``-log(-log u)``; a standard normal Box-Muller of
  words 0 and 1, ``sqrt(-2 log u0) cos(2 pi u1)``; a gamma Marsaglia-Tsang
  with one block an attempt (the native ``gamma_mt_scalar``,
  native/src/gst_kernels.h): the normal from words 0-1, the squeeze
  uniform word 2, and for a shape below 1 the boost uniform word 3 of
  attempt 0, ``Gamma(a) = Gamma(a + 1) U^(1/a)`` with ``U^(1/a)`` as
  ``exp(log U / a)``. Every transcendental is taken in float64 and the
  result rounded once to float32, here and in the kernel alike, so the
  card's draws equal these bit for bit except where a float64 ulp of
  libm's result straddles a float32 rounding boundary (and the uniforms
  are exact everywhere). A gamma that has not accepted after
  ``MT_MAX_ATTEMPTS`` attempts (a non-finite shape, or odds below
  1e-300) is NaN, which makes its chain a dead one.

:func:`sweep_draws` writes one sweep's raw fields for a batch of chains
(a :class:`DrawTable` lists them): one launch of the CUDA kernel
``csrc/draws.cu`` (D1) on a CUDA tensor, :func:`sweep_draws_plain` (the
plain PyTorch version, built from the primitives below) on a CPU tensor.
D1 replaces no Pallas kernel: on the TPU, XLA fuses the jnp draws into
the sweep's program; on the card the same work was ~40 separate launches
a sweep.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from gibbs_student_t_tpu_torch.obs.introspect import note_kernel

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85

#: ctr2 domain tags of the JAX package's native kernels
TAG_GAMMA = 0x67616D00
TAG_BETA_A = 0x62657400
TAG_BETA_B = 0x62657401

#: ctr2 tags of the sweep's fields ("sw" + field): each MH block's scale
#: mixture uniforms, coordinate-pick uniforms, jump normals, log-uniforms
#: and (MTM) Gumbel noise, with the MTM reference jumps' own streams; the b
#: draw's normals, the theta gammas, the z uniforms, the alpha gammas and
#: the df Gumbel noise
_TAG_SWEEP = 0x73770000
_MH_STREAMS = ("scale", "pick", "jump", "logu", "gumbel", "scale_ref",
               "pick_ref", "jump_ref")
SWEEP_TAGS: Dict[str, int] = {
    **{f"{blk}_{s}": _TAG_SWEEP | (0x10 * b + i)
       for b, blk in enumerate(("white", "hyper"))
       for i, s in enumerate(_MH_STREAMS)},
    "xi": _TAG_SWEEP | 0x20, "u_z": _TAG_SWEEP | 0x21,
    "gumbel_df": _TAG_SWEEP | 0x22,
    # a gamma field's shape column c draws under tag + c
    "g_theta": _TAG_SWEEP | 0x30, "g_alpha": _TAG_SWEEP | 0x40}

#: field kinds of a DrawTable (the kernel's switch uses the same numbers)
UNIFORM, NORMAL, LOG_UNIFORM, GUMBEL, GAMMA = range(5)
#: Marsaglia-Tsang attempts before a gamma gives up as NaN (the kernel's
#: GST_MT_MAX_ATTEMPTS); the first attempt accepts > 95 % of the time
MT_MAX_ATTEMPTS = 256

M32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
TWO_PI = 6.283185307179586476925286766559
_U_SCALE = 2.0 ** -23
_U_HALF = 2.0 ** -24


def _words(x, device=None) -> torch.Tensor:
    """``x`` (an int, array or tensor of 32-bit values) as int64."""
    if torch.is_tensor(x):
        return x.to(torch.int64)
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _mulhilo(a, m: int):
    """(hi, lo) words of ``a * m`` for int64 words ``a`` and a 32-bit
    constant ``m``, through m's 16-bit limbs: ``a * ml`` and ``a * mh``
    stay below 2^48, so nothing overflows."""
    ml, mh = m & 0xFFFF, m >> 16
    p0 = a * ml
    p1 = a * mh
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (t >> 32), t & M32


def philox_4x32(k0, k1, c0, c1, c2, c3):
    """One Philox-4x32-10 block per counter element. Key words and
    counters are ints or int64 tensors of 32-bit values, broadcast
    together; returns the four output words (int64 tensors), bit for bit
    the JAX package's ``philox_4x32``."""
    dev = next((t.device for t in (k0, k1, c0, c1, c2, c3)
                if torch.is_tensor(t)), None)
    k0, k1, c0, c1, c2, c3 = (_words(t, dev) for t in (k0, k1, c0, c1, c2,
                                                         c3))
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & M32
        k1 = (k1 + PHILOX_W1) & M32
    return c0, c1, c2, c3


def uniform_of_bits(bits, dtype=torch.float32):
    """The exact bits -> (0, 1) map: ``(bits >> 9) * 2^-23 + 2^-24``, every
    step representable in float32 (23 bits of entropy)."""
    b = (_words(bits) >> 9).to(dtype)
    return b * _U_SCALE + _U_HALF


def philox_uniform_pool(key2, rows: int, width: int, tag: int,
                        dtype=torch.float32):
    """(rows, width) uniforms for ONE chain: uniform ``i`` of row ``r`` is
    word ``i % 4`` of block (ctr0 = r, ctr1 = i // 4, ctr2 = tag) under
    the chain's key words ``key2`` (2,) (the JAX package's layout)."""
    key2 = _words(key2)
    nblk = (width + 3) // 4
    c0 = torch.arange(rows, dtype=torch.int64, device=key2.device)[:, None]
    c1 = torch.arange(nblk, dtype=torch.int64, device=key2.device)[None, :]
    w = philox_4x32(key2[0], key2[1], c0.expand(rows, nblk),
                    c1.expand(rows, nblk), tag, 0)
    bits = torch.stack(w, dim=-1).reshape(rows, nblk * 4)[:, :width]
    return uniform_of_bits(bits, dtype)


def gamma_halfint_v2(key2, counts, jmax: int):
    """``Gamma(k/2)`` for integer ``k = counts`` (float-encoded), the JAX
    package's GST_FAST_GAMMA v2 construction: the sum of ``k // 2``
    exponentials from a product of uniforms (chunked before each log, 4
    a chunk in float32 and 8 in float64, so no product underflows) plus,
    for odd k, half a squared Box-Muller normal. One chain: ``counts
    (n,)`` -> draws ``(n,)``."""
    dtype = counts.dtype
    n = counts.shape[-1]
    u = philox_uniform_pool(key2, n, jmax + 2, TAG_GAMMA, dtype)
    k = torch.floor(counts + 0.5).to(torch.int32).clamp(min=0)
    j = torch.clamp(k >> 1, max=jmax)
    odd = (k & 1).to(dtype)
    live = torch.arange(jmax, device=counts.device)[None, :] < j[:, None]
    up = torch.where(live, u[:, :jmax], torch.ones((), dtype=dtype))
    chunk = 4 if dtype == torch.float32 else 8
    pad = (-jmax) % chunk
    if pad:
        up = torch.cat([up, torch.ones(up.shape[:-1] + (pad,), dtype=dtype)],
                       dim=-1)
    pc = torch.prod(up.reshape(up.shape[:-1] + (-1, chunk)), dim=-1)
    g = -torch.sum(torch.log(pc), dim=-1)
    nrm = torch.sqrt(-2.0 * torch.log(u[:, jmax])) * torch.cos(
        TWO_PI * u[:, jmax + 1])
    return g + odd * 0.5 * nrm * nrm


# ---------------------------------------------------------------------------
# the port's per-chain draw primitives (the plain version of D1)
# ---------------------------------------------------------------------------


def chain_key(seed: int, chain: int):
    """The key words ``(k0, k1)`` of chain ``chain`` of the run ``seed``:
    the two packed into 64 bits and passed through the splitmix64
    finalizer, a bijection, so distinct ``(seed, chain)`` pairs give
    distinct keys (both must lie in ``[0, 2**32)``)."""
    seed, chain = int(seed), int(chain)
    check_counter("seed", seed)
    check_counter("chain", chain)
    z = (seed << 32) | chain
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    z ^= z >> 31
    return z & M32, z >> 32


def chain_keys(seed: int, chains, device=None) -> torch.Tensor:
    """``(*chains.shape, 2)`` int64 key words of the chains numbered
    ``chains`` (ints) in the run ``seed``."""
    idx = np.asarray(chains, np.int64)
    keys = np.array([chain_key(seed, c) for c in idx.reshape(-1)],
                    np.int64).reshape(idx.shape + (2,))
    return torch.as_tensor(keys, device=device)


def check_counter(name: str, value: int) -> None:
    """Raise unless ``value`` fits a 32-bit key or counter word."""
    if not 0 <= int(value) < 1 << 32:
        raise ValueError(f"{name} ({value}) must lie in [0, 2**32)")


def _blocks(keys, sweep, tag: int, n: int, attempt=0):
    """The four words of the blocks ``(element, attempt, tag, sweep)``,
    elements 0..n-1, under each chain's key: ``keys (B, 2)``, ``sweep
    (B,)`` -> four ``(B, n)`` word tensors."""
    e = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    return philox_4x32(keys[:, :1], keys[:, 1:], e, attempt, tag,
                       sweep[:, None] & M32)


def _u64(bits):
    """Uniforms of ``bits`` in float64 (exactly the float32 values)."""
    return uniform_of_bits(bits, torch.float64)


def _box_muller(w0, w1):
    """Standard normals from two words, float64."""
    return torch.sqrt(-2.0 * torch.log(_u64(w0))) * torch.cos(
        TWO_PI * _u64(w1))


def uniforms(keys, sweep, tag: int, n: int):
    """``(B, n)`` float32 uniforms in (0, 1) of the chains ``keys (B, 2)``
    at ``sweep (B,)`` in field ``tag``."""
    return uniform_of_bits(_blocks(keys, sweep, tag, n)[0])


def log_uniforms(keys, sweep, tag: int, n: int):
    """``log`` of :func:`uniforms` (taken in float64)."""
    return torch.log(_u64(_blocks(keys, sweep, tag, n)[0])).float()


def gumbel(keys, sweep, tag: int, n: int):
    """Gumbel noise ``-log(-log u)`` (float64, rounded to float32)."""
    u = _u64(_blocks(keys, sweep, tag, n)[0])
    return (-torch.log(-torch.log(u))).float()


def normals(keys, sweep, tag: int, n: int):
    """Standard normals, Box-Muller of words 0 and 1 (float64, rounded
    to float32)."""
    w = _blocks(keys, sweep, tag, n)
    return _box_muller(w[0], w[1]).float()


def _gamma_mt(keys, sweep, tag: int, shape):
    """:func:`gamma_mt`'s draws and the attempts each took (int64: k + 1
    for a gamma accepted at attempt k, 0 for an invalid shape,
    ``MT_MAX_ATTEMPTS`` for one that gave up)."""
    B, n = shape.shape
    dev = shape.device
    a = shape.double().reshape(-1)
    out = torch.full_like(a, math.nan)
    tries = torch.zeros(a.shape, dtype=torch.int64, device=dev)
    boost = a < 1.0
    d = torch.where(boost, a + 1.0, a) - 1.0 / 3.0
    cc = 1.0 / (3.0 * torch.sqrt(d))
    ub = torch.ones_like(a)
    elem = torch.arange(n, dtype=torch.int64, device=dev).repeat(B)
    chain = torch.arange(B, dtype=torch.int64, device=dev).repeat_interleave(n)
    k0, k1, sw = keys[chain, 0], keys[chain, 1], sweep[chain] & M32
    pend = torch.nonzero((a > 0.0) & torch.isfinite(a)).reshape(-1)
    for attempt in range(MT_MAX_ATTEMPTS):
        if not len(pend):
            break
        tries[pend] += 1
        w = philox_4x32(k0[pend], k1[pend], elem[pend], attempt, tag,
                        sw[pend])
        if attempt == 0:
            ub[pend] = _u64(w[3])
        x = _box_muller(w[0], w[1])
        v = 1.0 + cc[pend] * x
        pos = v > 0.0
        v = v * v * v
        dp = d[pend]
        lhs = torch.log(_u64(w[2]))
        rhs = 0.5 * x * x + dp - dp * v + dp * torch.log(v)
        acc = pos & (lhs < rhs)
        out[pend[acc]] = dp[acc] * v[acc]
        pend = pend[~acc]
    bi = torch.nonzero(boost & torch.isfinite(out)).reshape(-1)
    out[bi] = out[bi] * torch.exp(torch.log(ub[bi]) / a[bi])
    return out.float().reshape(B, n), tries.reshape(B, n)


def gamma_mt(keys, sweep, tag: int, shape):
    """``Gamma(shape)`` draws by Marsaglia-Tsang with the a < 1 boost:
    ``shape (B, n)`` float32 (each element its own), element e of chain b
    at counters ``(e, attempt, tag, sweep[b])``. Attempts run over the
    elements not yet accepted; see the module docstring."""
    return _gamma_mt(keys, sweep, tag, shape)[0]


def gamma_attempts(keys, sweep, shapes, table) -> int:
    """The Marsaglia-Tsang attempts every gamma of one sweep's ``table``
    takes for the chains ``keys (*batch, 2)`` at ``sweep`` with ``shapes
    (*batch, k)`` (the work D1 does on these inputs; a boosted shape's
    attempt 0 included)."""
    keys, sweep, shapes, _ = _flat_operands("gamma_attempts", keys, sweep,
                                            shapes)
    sweep = sweep.expand(keys.shape[0])
    return sum(int(_gamma_mt(keys, sweep, SWEEP_TAGS[f.name] + c,
                             shapes[:, f.col + c, None].expand(
                                 -1, f.per))[1].sum())
               for f in (f for f in table.fields if f.kind == GAMMA)
               for c in range(f.count // f.per))


# ---------------------------------------------------------------------------
# one sweep's fields: the table, the plain version and the kernel
# ---------------------------------------------------------------------------


class DrawField(NamedTuple):
    """One field of a sweep's draws: ``shape`` per chain (its elements
    are the field's element indices, row-major) and its kind. A gamma
    field's element e reads shape column ``col + e // per`` and draws as
    element ``e % per`` under tag ``tag + e // per``."""

    name: str
    kind: int
    shape: tuple
    col: int = 0
    per: int = 1

    @property
    def count(self) -> int:
        return math.prod(self.shape)


#: D1's geometry (``csrc/draws.cu``; :func:`draw_geometry` asks the built
#: kernel): threads a block, chains a tile may span, the longest tile
DRAW_THREADS, DRAW_MAX_CHAINS, DRAW_MAX_TILE = 128, 256, 65535
#: segments a launch may have (a gamma field counts once a shape column)
MAX_SEGMENTS = 64
_DIV_BITS = 31


def draw_elems(gammas: int, threads: int, sms: int):
    """``(other, gamma)``: the values a thread takes in a tile of a
    non-gamma field (8) and of a gamma field: the largest power of two up
    to 16 that leaves two gamma tiles an SM (on an H100's 132 SMs at 128
    threads: 4 at the flagship's and the pool's 268,288 gammas, 16 at
    ens32's 2.1 M and the stress path's 13.1 M)."""
    g = gammas // (2 * sms * threads)
    return 8, min(16, 1 << (g.bit_length() - 1)) if g else 1


def div_magic(n: int):
    """``(magic, shift)`` with ``p // n == (p * magic) >> shift`` for every
    ``0 <= p < 2**31`` (Granlund and Montgomery 1994, Thm 4.2: with
    ``l = ceil(log2 n)``, ``magic = ceil(2**(31 + l) / n) < 2**32``), so
    D1 finds a value's chain by one 32 x 32 -> 64-bit multiply."""
    n = int(n)
    if not 1 <= n < 1 << _DIV_BITS:
        raise ValueError(f"div_magic: divisor {n} outside [1, 2**31)")
    shift = _DIV_BITS + (n - 1).bit_length()
    return -(-(1 << shift) // n), shift


class DrawTable:
    """The fields one sweep draws, laid out field-major: field f of a
    batch of B chains occupies ``[B * off_f, B * (off_f + count_f))`` of
    the flat output, as a contiguous ``(B, count_f)`` block.

    D1 draws it by segments, a field or one shape column of a gamma field
    (:attr:`segments`), each cut into tiles of consecutive values
    (:meth:`tiles`), one thread block a tile."""

    def __init__(self, fields: Sequence[DrawField]):
        self.fields = tuple(fields)
        offs, off = [], 0
        for f in self.fields:
            offs.append(off)
            off += f.count
        self.offsets = tuple(offs)
        self.width = off
        #: D1's segments: (kind, tag, n, stride, offset, column start,
        #: shape column, magic, shift); segment s writes chain b's element
        #: e < n at ``B * offset + column start + b * stride + e``
        self.segments = tuple(
            (f.kind, SWEEP_TAGS[f.name] + c, n, f.count, o, c * n,
             f.col + c, *div_magic(n))
            for f, o in zip(self.fields, self.offsets)
            for c, n in ([(c, f.per) for c in range(f.count // f.per)]
                         if f.kind == GAMMA else [(0, f.count)])
            if n)
        self._launch = {}

    def views(self, raw, batch) -> Dict[str, torch.Tensor]:
        """``{name: (*batch, *shape) view}`` of a flat output ``raw``."""
        Bn = math.prod(batch)
        return {f.name: raw[Bn * o:Bn * (o + f.count)].view(*batch,
                                                              *f.shape)
                for f, o in zip(self.fields, self.offsets)}

    @property
    def gammas(self) -> int:
        """Gamma values a chain."""
        return sum(f.count for f in self.fields if f.kind == GAMMA)

    def tiles(self, B: int, threads: int, max_chains: int, elems):
        """D1's tiles for B chains, ``(ntiles, 4)`` int32 rows (segment,
        first chain, first element, length), and the longest tile.

        Segment s's ``B * n`` values are cut in order into tiles of
        ``threads * elems`` (``elems[1]`` for a gamma segment, ``elems[0]``
        otherwise), fewer where that would span more than ``max_chains``
        chains: then into runs of whole chains. Every value of every
        segment lies in exactly one tile."""
        rows, longest = [], 0
        for s, seg in enumerate(self.segments):
            kind, n = seg[0], seg[2]
            L = threads * elems[kind == GAMMA]
            if n + L >= 1 << _DIV_BITS:
                raise ValueError(f"tiles: {n} values a chain and tiles of "
                                 f"{L} pass the kernel's 2**31 index")
            step = (L if L <= (max_chains - 1) * n + 1
                    else n * min(max_chains, L // n))
            start = np.arange(0, B * n, step, dtype=np.int64)
            if not len(start):
                continue
            ln = np.minimum(step, B * n - start)
            rows.append(np.stack([np.full_like(start, s), start // n,
                                  start % n, ln], -1))
            longest = max(longest, int(ln.max()))
        tiles = (np.concatenate(rows) if rows
                 else np.zeros((0, 4), np.int64)).astype(np.int32)
        return tiles, longest

    def launch(self, B: int, device, elems=None):
        """D1's launch operands for B chains on ``device``: the tile rows
        (:meth:`tiles` at the built kernel's geometry, at ``elems`` or else
        :func:`draw_elems` on the device's SMs) on the device, and the
        segment rows as a host int32 array; made once per (B, elems,
        device) and kept."""
        key = (B, elems, str(device))
        if key not in self._launch:
            from gibbs_student_t_tpu_torch.ops import _cuda

            threads, max_chains, max_tile = draw_geometry()
            if elems is None:
                elems = draw_elems(
                    B * self.gammas, threads,
                    torch.cuda.get_device_properties(
                        device).multi_processor_count)
            tiles, longest = self.tiles(B, threads, max_chains, elems)
            if longest > max_tile:
                raise ValueError(f"sweep_draws: tiles of {longest} values, "
                                 f"the kernel takes {max_tile}")
            segs = _cuda.host_ints([v - (1 << 32) if v >= 1 << 31 else v
                                    for row in self.segments for v in row])
            self._launch[key] = (torch.from_numpy(tiles).to(device), segs)
        return self._launch[key]


def draw_geometry():
    """``(threads, max chains, longest tile)`` of the built D1 (builds the
    kernels)."""
    if not hasattr(draw_geometry, "cached"):
        from gibbs_student_t_tpu_torch.ops import _cuda

        out = _cuda.host_ints([0] * 3)
        _cuda.check(_cuda.lib().gst_draw_geometry(_cuda.addr(out)),
                    "draw_geometry")
        draw_geometry.cached = tuple(out)
    return draw_geometry.cached


def _flat_operands(name, keys, sweep, shapes):
    """``(keys (B, 2), sweep (B,) or (1,), shapes (B, k), batch)`` after
    the checks the kernel and the plain version share."""
    if keys.dtype != torch.int64 or keys.shape[-1] != 2:
        raise ValueError(f"{name}: keys must be (..., 2) int64, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    batch = tuple(keys.shape[:-1])
    if sweep.dtype != torch.int64 or (sweep.numel() != 1
                                      and tuple(sweep.shape) != batch):
        raise ValueError(f"{name}: sweep must be one int64 index or one a "
                         f"chain {batch}, got {tuple(sweep.shape)} "
                         f"{sweep.dtype}")
    if shapes.dtype != torch.float32 or tuple(shapes.shape[:-1]) != batch:
        raise ValueError(f"{name}: shapes must be (*batch, k) float32, "
                         f"got {tuple(shapes.shape)} {shapes.dtype}")
    if not keys.device == sweep.device == shapes.device:
        raise ValueError(f"{name}: operands on {keys.device}, "
                         f"{sweep.device} and {shapes.device}")
    B = math.prod(batch)
    return (keys.reshape(B, 2), sweep.reshape(-1), shapes.reshape(B, -1),
            batch)


def sweep_draws_plain(keys, sweep, shapes, table: DrawTable, out=None):
    """D1's function in PyTorch: every field of ``table`` for the chains
    ``keys (*batch, 2)`` at ``sweep`` (one int64 index, or one a chain),
    the gamma fields' shapes read from ``shapes (*batch, k)``; returns
    the flat float32 output (``DrawTable.views`` cuts it)."""
    keys, sweep, shapes, batch = _flat_operands("sweep_draws", keys, sweep,
                                                shapes)
    B = keys.shape[0]
    sweep = sweep.expand(B)
    if out is None:
        out = torch.empty(B * table.width, dtype=torch.float32,
                          device=keys.device)
    for f, o in zip(table.fields, table.offsets):
        tag, n = SWEEP_TAGS[f.name], f.count
        if f.kind == UNIFORM:
            v = uniforms(keys, sweep, tag, n)
        elif f.kind == NORMAL:
            v = normals(keys, sweep, tag, n)
        elif f.kind == LOG_UNIFORM:
            v = log_uniforms(keys, sweep, tag, n)
        elif f.kind == GUMBEL:
            v = gumbel(keys, sweep, tag, n)
        else:
            v = torch.cat([gamma_mt(keys, sweep, tag + c,
                                    shapes[:, f.col + c, None].expand(
                                        B, f.per))
                           for c in range(n // f.per)], dim=-1)
        out[B * o:B * (o + n)].view(B, n).copy_(v)
    return out


def sweep_draws(keys, sweep, shapes, table: DrawTable, out=None,
                elems=None):
    """One sweep's raw draws for a batch of chains (see
    :func:`sweep_draws_plain`): the plain version on the CPU, one launch
    of D1 (``csrc/draws.cu``) on a CUDA device, counted in
    ``sweep_draws.launches``. ``out``, when given, is the flat float32
    output to write (reused from sweep to sweep by the serving pool).
    ``elems`` (values a thread, other and gamma fields; default
    :func:`draw_elems`) sets the tiles' length, for measurements; it does
    not change the values."""
    from gibbs_student_t_tpu_torch.ops import _cuda

    if not _cuda.use_kernel(keys, "sweep_draws"):
        note_kernel("sweep_draws", "plain",
                    (math.prod(keys.shape[:-1]), table.width))
        return sweep_draws_plain(keys, sweep, shapes, table, out=out)

    kf, sw, sh, batch = _flat_operands("sweep_draws", keys, sweep, shapes)
    if len(table.segments) > MAX_SEGMENTS:
        raise ValueError(f"sweep_draws: {len(table.segments)} segments, the "
                         f"kernel takes {MAX_SEGMENTS}")
    B = kf.shape[0]
    kf, sw, sh = kf.contiguous(), sw.contiguous(), sh.contiguous()
    if out is None:
        out = torch.empty(B * table.width, dtype=torch.float32,
                          device=keys.device)
    elif (out.dtype != torch.float32 or out.numel() != B * table.width
          or not out.is_contiguous() or out.device != keys.device):
        raise ValueError("sweep_draws: out must be a contiguous float32 "
                         f"tensor of {B * table.width} on {keys.device}")
    if B and table.width:
        note_kernel("sweep_draws", "cuda", (B, table.width))
        tiles, segs = table.launch(B, keys.device, elems)
        _cuda.launch("sweep_draws", keys.device, _cuda.ptr(kf),
                     _cuda.ptr(sw), int(sw.numel() > 1), _cuda.ptr(sh),
                     sh.shape[-1], _cuda.ptr(out), _cuda.addr(segs),
                     len(table.segments), _cuda.ptr(tiles), tiles.shape[0],
                     B)
        sweep_draws.launches += 1
    return out


sweep_draws.launches = 0
