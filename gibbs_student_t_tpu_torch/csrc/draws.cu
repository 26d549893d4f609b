// D1, sweep_draws: every random number of one Gibbs sweep for a batch of
// chains, in one launch, from counter-based Philox-4x32-10 keyed per chain.
//
// It replaces no Pallas kernel. On the TPU the JAX package draws with
// jax.random inside the sweep's XLA program, which fuses the draws into
// it; on this card the same work was ~40 separate PyTorch launches a
// sweep (torch.rand, randn, randint, _standard_gamma from one generator
// re-seeded each sweep), and the serving pool repeated them for each
// resident tenant. The stream layout follows the JAX package's native
// Philox kernels (native/src/gst_kernels.h, gamma_mt_scalar): chain keys
// (k0, k1), counters (element, attempt, tag, sweep). The plain PyTorch
// version, and the layout in full, is ops/rng.py sweep_draws_plain; the
// arithmetic of one value is gst_draws.cuh.
//
// What bounds it: the bytes are small (4 bytes a value written; the
// flagship's 646 values a chain are 2.65 MB a sweep at 1024 chains,
// 0.79 us at 3.35 TB/s); the work is float64 transcendentals (log, cos,
// sqrt, exp), most of it the alpha gammas' Marsaglia-Tsang attempts (2 x n
// a chain: 13.1 M at the stress shape). One attempt is ~390 instructions
// on sm_90a, 130 of them on the FP64 pipe (tools/torch_kernel_ab.py
// draw_instructions counts them in the SASS of probe kernels built from
// gst_draws.cuh), so D1 is bound by issue slots, then by the FP64 pipe.
// The first design ran one thread a value, each gamma looping until it
// accepted, so a warp ran as long as its slowest lane (at 4 % rejections
// 1 - 0.96^32 = 73 % of warps paid a second attempt for a lane or two),
// and every thread recomputed its chain's constants (a float64 sqrt and
// divide) and its (chain, element) by a 64-bit division.
//
// Design:
// - Tiles. ops/rng.py DrawTable.tiles cuts each segment (a field, or one
//   shape column of a gamma field) into tiles of consecutive values of
//   its (B, n) block, uploaded once per batch size: a tile is (segment,
//   first chain, first element, length), one block a tile, at most
//   GST_DRAW_MAX_CHAINS chains; a thread takes 8 values of another field
//   and 1-16 of a gamma field (ops/rng.py draw_elems: the most that leaves
//   two gamma tiles an SM). The block stages each of its chains' key
//   words, sweep index and (gamma) shape a with its constants d and
//   c = 1 / (3 sqrt d) in shared memory once, by the plain version's
//   expressions. A value's (chain, element) is one 32 x 32 -> 64-bit
//   multiply and shift by the segment's magic number (no division);
//   neighbouring lanes take neighbouring values, so stores coalesce.
// - The retry queue, a warp's own. A warp walks its run of the gamma tile
//   32 values a round; a rejected value goes into the warp's queue in
//   shared memory (__ballot_sync / __popc offsets), and the next round's
//   first lanes take the queued retries, each one attempt at its own
//   counters (e, attempt, tag, sweep), while the other lanes take fresh
//   values. Every round runs full until the fresh values run out; only
//   the last retries run in rounds with idle lanes. A queue entry is the
//   value's index in the tile, its next attempt and word 3 of its attempt
//   0 block (the boost uniform of a shape below 1), carried rather than
//   re-derived. An invalid shape (!(a > 0) or infinite) writes NaN with
//   no attempt, a value still rejected at attempt GST_MT_MAX_ATTEMPTS - 1
//   NaN. Which lane and round take a retry depends on its neighbours, but
//   each value is written once, from its own counters, so the output does
//   not. (A block-wide queue drained by the whole block between barriers
//   timed the same within 2 %, and needs the barriers; a warp's queue
//   needs none after the staging.)
//
// Numerics: every transcendental is taken in float64 and rounded once to
// float32, as the plain version does, so the two agree bit for bit except
// where a float64 ulp of the two libms straddles a float32 rounding
// boundary; uniforms are exact. This file is built with -fmad=false
// (ops/_cuda.py SOURCE_FLAGS): nvcc would otherwise contract 1 + cc * x,
// 0.5 * x * x + d and d * v into FMAs, which the CPU's separate PyTorch
// operations round twice. No other kernel shares the flag.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gst_draws.cuh"

// threads a block; at 128, 8 blocks an SM at the 60 registers a thread
// ptxas gives (capping them at 48 or 40 timed no faster)
#define GST_DRAW_THREADS 128
#define GST_DRAW_MIN_BLOCKS 4
// chains a tile may span (ops/rng.py tiles() keeps to it)
#define GST_DRAW_MAX_CHAINS 256
// segments a launch may have (fields, a gamma field counting once per
// shape column)
#define GST_DRAW_MAX_SEGMENTS 64
// longest tile: a queue entry keeps a value's index in 16 bits
#define GST_DRAW_MAX_TILE 65535
// Marsaglia-Tsang attempts before a gamma gives up as NaN (ops/rng.py
// MT_MAX_ATTEMPTS): a safeguard; the worst finite shapes measured (1e20
// to 1e30, where float64 rounding leaves the squeeze test a coin toss)
// take up to 17
#define GST_MT_MAX_ATTEMPTS 256

struct DrawSegments {
  int nseg;
  int kind[GST_DRAW_MAX_SEGMENTS];
  unsigned int tag[GST_DRAW_MAX_SEGMENTS];
  int n[GST_DRAW_MAX_SEGMENTS];       // values a chain
  int stride[GST_DRAW_MAX_SEGMENTS];  // a chain's row in the field's block
  int col[GST_DRAW_MAX_SEGMENTS];     // shape column (gamma)
  unsigned int magic[GST_DRAW_MAX_SEGMENTS];  // p / n = p magic >> shift
  int shift[GST_DRAW_MAX_SEGMENTS];
  long long base[GST_DRAW_MAX_SEGMENTS];      // B * offset + column start
};

// a chain's values a tile stages once: key words, sweep index and (gamma
// fields) the shape a and its constants d and c
struct DrawChain {
  uint4 key;  // (k0, k1, sweep, unused)
  double2 ad;
  double cc, unused;
};

// floor(p / n) for p < 2^31 by the segment's magic number
// (ops/rng.py div_magic)
__device__ __forceinline__ uint32_t gst_div(uint32_t p, uint32_t magic,
                                            int shift) {
  return (uint32_t)(((unsigned long long)p * magic) >> shift);
}

__global__ void __launch_bounds__(GST_DRAW_THREADS, GST_DRAW_MIN_BLOCKS)
sweep_draws_kernel(const long long* __restrict__ keys,
                   const long long* __restrict__ sweep, int sweep_stride,
                   const float* __restrict__ shapes, int nshape,
                   float* __restrict__ out, const int4* __restrict__ tiles,
                   DrawSegments S) {
  __shared__ DrawChain s_chain[GST_DRAW_MAX_CHAINS];
  __shared__ uint2 s_queue[GST_DRAW_THREADS];

  const int4 tile = tiles[blockIdx.x];
  const int sg = tile.x;
  const uint32_t e0 = (uint32_t)tile.z;
  const int len = tile.w;
  const int kind = S.kind[sg];
  const uint32_t n = (uint32_t)S.n[sg];
  const uint32_t magic = S.magic[sg];
  const int shift = S.shift[sg];
  const uint32_t tag = S.tag[sg];
  const long long stride = S.stride[sg];
  const long long b0 = tile.y;
  const int nch = (int)gst_div(e0 + (uint32_t)len - 1u, magic, shift) + 1;
  for (int c = threadIdx.x; c < nch; c += GST_DRAW_THREADS) {
    const long long chain = b0 + c;
    DrawChain ch;
    ch.key = make_uint4((uint32_t)keys[2 * chain],
                        (uint32_t)keys[2 * chain + 1],
                        (uint32_t)sweep[chain * sweep_stride], 0u);
    if (kind == GST_GAMMA) {
      const double a = (double)shapes[chain * nshape + S.col[sg]];
      double d, cc;
      gst_mt_consts(a, d, cc);
      ch.ad = make_double2(a, d);
      ch.cc = cc;
    }
    s_chain[c] = ch;
  }
  __syncthreads();
  float* o = out + S.base[sg] + b0 * stride;

  if (kind != GST_GAMMA) {
    const int rounds = (len + GST_DRAW_THREADS - 1) / GST_DRAW_THREADS;
    for (int r = 0; r < rounds; ++r) {
      const int j = threadIdx.x + r * GST_DRAW_THREADS;
      if (j >= len) break;
      const uint32_t p = e0 + (uint32_t)j;
      const uint32_t lc = gst_div(p, magic, shift);
      const uint32_t e = p - lc * n;
      const uint4 key = s_chain[lc].key;
      o[lc * stride + e] =
          (float)gst_plain_value(kind, key.x, key.y, e, tag, key.z);
    }
    return;
  }

  // the warp's run of the tile: [next, hi), 32 values a round
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = 32 * ((len + GST_DRAW_THREADS - 1) / GST_DRAW_THREADS);
  const int hi = min(len, (warp + 1) * chunk);
  int next = warp * chunk;
  uint2* const wq = s_queue + 32 * warp;
  const float nanf_ = __int_as_float(0x7fc00000);
  int q = 0;  // retries queued, the first lanes' items of the next round
  while (next < hi || q > 0) {
    uint32_t j, attempt = 0u, w3 = 0u;
    bool live = true;
    if (lane < q) {
      const uint2 ent = wq[lane];
      j = ent.x & 0xffffu;
      attempt = ent.x >> 16;
      w3 = ent.y;
    } else {
      j = (uint32_t)(next + lane - q);
      live = (int)j < hi;
    }
    next += 32 - q;
    __syncwarp();
    bool pend = false;
    if (live) {
      const uint32_t p = e0 + j;
      const uint32_t lc = gst_div(p, magic, shift);
      const uint32_t e = p - lc * n;
      const uint4 key = s_chain[lc].key;
      const double2 ad = s_chain[lc].ad;
      const double a = ad.x;
      float* const dst = o + (lc * stride + e);
      if (a > 0.0 && !isinf(a)) {
        double g;
        uint32_t w;
        if (gst_mt_attempt(key.x, key.y, e, attempt, tag, key.z, ad.y,
                           s_chain[lc].cc, g, w)) {
          if (a < 1.0) g = gst_mt_boost(g, attempt ? w3 : w, a);
          *dst = (float)g;
        } else if (attempt + 1u < GST_MT_MAX_ATTEMPTS) {
          pend = true;
          if (attempt == 0u) w3 = w;
        } else {
          *dst = nanf_;
        }
      } else {
        *dst = nanf_;
      }
    }
    const unsigned int m = __ballot_sync(0xffffffffu, pend);
    if (pend)
      wq[__popc(m & ((1u << lane) - 1u))] =
          make_uint2(j | ((attempt + 1u) << 16), w3);
    q = __popc(m);
    __syncwarp();
  }
}

extern "C" {

// The kernel's geometry: threads a block, chains a tile may span, the
// longest tile (ops/rng.py draw_geometry).
int gst_draw_geometry(int* out) {
  out[0] = GST_DRAW_THREADS;
  out[1] = GST_DRAW_MAX_CHAINS;
  out[2] = GST_DRAW_MAX_TILE;
  return 0;
}

// segs: (kind, tag, n, stride, offset, column start, shape column, magic,
// shift) for each of nseg segments (ops/rng.py DrawTable.segments):
// segment s writes out[B * offset + column start + b * stride + e] for
// chain b, element e < n. tiles: ntiles device int4 (segment, first
// chain, first element, length) (DrawTable.tiles), each at most
// GST_DRAW_MAX_TILE values. sweep_stride 0: one sweep index for every
// chain; 1: one a chain.
int gst_sweep_draws(const long long* keys, const long long* sweep,
                    int sweep_stride, const float* shapes, int nshape,
                    float* out, const int* segs, int nseg, const int* tiles,
                    int ntiles, long long B, void* stream) {
  if (nseg < 0 || nseg > GST_DRAW_MAX_SEGMENTS || B < 0 || ntiles < 0
      || (sweep_stride != 0 && sweep_stride != 1))
    return (int)cudaErrorInvalidValue;
  DrawSegments S;
  S.nseg = nseg;
  for (int s = 0; s < nseg; ++s) {
    const int* row = segs + 9 * s;
    if (row[0] < GST_UNIFORM || row[0] > GST_GAMMA || row[2] < 1
        || row[3] < row[2] || row[8] < 31 || row[8] > 62)
      return (int)cudaErrorInvalidValue;
    S.kind[s] = row[0];
    S.tag[s] = (unsigned int)row[1];
    S.n[s] = row[2];
    S.stride[s] = row[3];
    S.base[s] = B * (long long)row[4] + row[5];
    S.col[s] = row[6];
    S.magic[s] = (unsigned int)row[7];
    S.shift[s] = row[8];
  }
  if (ntiles == 0) return (int)cudaSuccess;
  sweep_draws_kernel<<<(unsigned int)ntiles, GST_DRAW_THREADS, 0,
                       (cudaStream_t)stream>>>(
      keys, sweep, sweep_stride, shapes, nshape, out,
      (const int4*)tiles, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
