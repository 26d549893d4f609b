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
// version, and the layout in full, is ops/rng.py sweep_draws_plain.
//
// Design: one thread per (chain, element) of a field, 256 threads a
// block, a contiguous range of blocks per field (the field table rides
// in the launch parameters; a block finds its field by a scan of at most
// 32 entries). Each thread makes one Philox block (the gammas one an
// attempt) and writes one float: neighbouring threads write neighbouring
// floats of the field's (B, count) block, so the stores coalesce.
//
// What bounds it: the bytes are small (4 bytes a value written; the
// flagship's 646 values a chain are 2.65 MB a sweep at 1024 chains,
// 0.79 us at 3.35 TB/s); the work is float64 transcendentals (log, cos,
// sqrt, exp) on the card's FP64 units, most of it the alpha gammas'
// Marsaglia-Tsang attempts (2 x n a chain). A Marsaglia-Tsang thread
// loops until it accepts, so a warp runs as long as its slowest lane;
// for a shape >= 1 the first attempt accepts > 95 % of the time, so the
// divergence costs little.
//
// Numerics: every transcendental is taken in float64 and rounded once to
// float32, as the plain version does, so the two agree bit for bit except
// where a float64 ulp of the two libms straddles a float32 rounding
// boundary; uniforms are exact. This file is built with -fmad=false
// (ops/_cuda.py SOURCE_FLAGS): nvcc would otherwise contract 1 + cc * x,
// 0.5 * x * x + d and d * v into FMAs, which the CPU's separate PyTorch
// operations round twice. No other kernel shares the flag.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define GST_DRAW_THREADS 256
#define GST_DRAW_MAX_FIELDS 32
// Marsaglia-Tsang attempts before a gamma gives up as NaN (ops/rng.py
// MT_MAX_ATTEMPTS): reached only by a non-finite shape's arithmetic
#define GST_MT_MAX_ATTEMPTS 256

// field kinds (ops/rng.py UNIFORM .. GAMMA)
enum { GST_UNIFORM = 0, GST_NORMAL = 1, GST_LOG_UNIFORM = 2, GST_GUMBEL = 3,
       GST_GAMMA = 4 };

#define GST_PHILOX_M0 0xD2511F53u
#define GST_PHILOX_M1 0xCD9E8D57u
#define GST_PHILOX_W0 0x9E3779B9u
#define GST_PHILOX_W1 0xBB67AE85u
#define GST_TWO_PI 6.283185307179586476925286766559

struct DrawFields {
  int nfields;
  int kind[GST_DRAW_MAX_FIELDS];
  unsigned int tag[GST_DRAW_MAX_FIELDS];
  int count[GST_DRAW_MAX_FIELDS];
  int col[GST_DRAW_MAX_FIELDS];
  int per[GST_DRAW_MAX_FIELDS];
  long long base[GST_DRAW_MAX_FIELDS];            // B * offset
  long long first_block[GST_DRAW_MAX_FIELDS + 1];  // block ranges
};

// Philox-4x32-10 on counters c under key (k0, k1), in place.
__device__ __forceinline__ void gst_philox(uint32_t k0, uint32_t k1,
                                           uint32_t c[4]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(c[0], GST_PHILOX_M0);
    const uint32_t lo0 = c[0] * GST_PHILOX_M0;
    const uint32_t hi1 = __umulhi(c[2], GST_PHILOX_M1);
    const uint32_t lo1 = c[2] * GST_PHILOX_M1;
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += GST_PHILOX_W0;
    k1 += GST_PHILOX_W1;
  }
}

// (bits >> 9) 2^-23 + 2^-24, exact in float32 and float64
__device__ __forceinline__ double gst_u01(uint32_t w) {
  return (double)(w >> 9) * 1.1920928955078125e-07 + 5.9604644775390625e-08;
}

__device__ __forceinline__ double gst_box_muller(uint32_t w0, uint32_t w1) {
  return sqrt(-2.0 * log(gst_u01(w0))) * cos(GST_TWO_PI * gst_u01(w1));
}

// Marsaglia-Tsang (2000) with the a < 1 boost Gamma(a) = Gamma(a + 1)
// U^(1/a), U^(1/a) as exp(log U / a); one Philox block an attempt at
// counters (e, attempt, tag, sweep): the normal from words 0-1, the
// squeeze uniform word 2, the boost uniform word 3 of attempt 0.
__device__ double gst_gamma_mt(uint32_t k0, uint32_t k1, uint32_t e,
                               uint32_t tag, uint32_t sweep, double a) {
  const double nan_ = __longlong_as_double(0x7ff8000000000000LL);
  if (!(a > 0.0) || isinf(a)) return nan_;
  const bool boost = a < 1.0;
  double ub = 1.0;
  const double d = (boost ? a + 1.0 : a) - 1.0 / 3.0;
  const double cc = 1.0 / (3.0 * sqrt(d));
  for (uint32_t attempt = 0; attempt < GST_MT_MAX_ATTEMPTS; ++attempt) {
    uint32_t c[4] = {e, attempt, tag, sweep};
    gst_philox(k0, k1, c);
    if (attempt == 0 && boost) ub = gst_u01(c[3]);
    const double x = gst_box_muller(c[0], c[1]);
    double v = 1.0 + cc * x;
    if (v <= 0.0) continue;
    v = v * v * v;
    const double lhs = log(gst_u01(c[2]));
    if (lhs < 0.5 * x * x + d - d * v + d * log(v)) {
      double g = d * v;
      if (boost) g = g * exp(log(ub) / a);
      return g;
    }
  }
  return nan_;
}

__global__ void __launch_bounds__(GST_DRAW_THREADS)
sweep_draws_kernel(const long long* __restrict__ keys,
                   const long long* __restrict__ sweep, int sweep_stride,
                   const float* __restrict__ shapes, int nshape,
                   float* __restrict__ out, long long B, DrawFields F) {
  const long long blk = blockIdx.x;
  int f = 0;
  while (f + 1 < F.nfields && blk >= F.first_block[f + 1]) ++f;
  const long long n = F.count[f];
  const long long t = (blk - F.first_block[f]) * GST_DRAW_THREADS
                      + threadIdx.x;
  if (t >= B * n) return;
  const long long chain = t / n;
  const uint32_t e = (uint32_t)(t - chain * n);
  const uint32_t k0 = (uint32_t)keys[2 * chain];
  const uint32_t k1 = (uint32_t)keys[2 * chain + 1];
  const uint32_t sw = (uint32_t)sweep[chain * sweep_stride];
  const uint32_t tag = F.tag[f];
  const int kind = F.kind[f];
  double v;
  if (kind == GST_GAMMA) {
    // shape column c of the field: its elements draw as e % per under
    // tag + c
    const uint32_t c = e / (uint32_t)F.per[f];
    v = gst_gamma_mt(k0, k1, e - c * (uint32_t)F.per[f], tag + c, sw,
                     (double)shapes[chain * nshape + F.col[f] + (int)c]);
  } else {
    uint32_t c[4] = {e, 0u, tag, sw};
    gst_philox(k0, k1, c);
    const double u = gst_u01(c[0]);
    if (kind == GST_UNIFORM) {
      v = u;
    } else if (kind == GST_LOG_UNIFORM) {
      v = log(u);
    } else if (kind == GST_GUMBEL) {
      v = -log(-log(u));
    } else {
      v = gst_box_muller(c[0], c[1]);
    }
  }
  out[F.base[f] + t] = (float)v;
}

extern "C" {

// table: (kind, tag, count, offset, col, per) for each of nfields fields;
// field f writes out[B * offset + b * count + e] for chain b, element e;
// a gamma field's count is a multiple of per.
// sweep_stride 0: one sweep index for every chain; 1: one a chain.
int gst_sweep_draws(const long long* keys, const long long* sweep,
                    int sweep_stride, const float* shapes, int nshape,
                    float* out, const int* table, int nfields, long long B,
                    void* stream) {
  if (nfields < 0 || nfields > GST_DRAW_MAX_FIELDS || B < 0
      || (sweep_stride != 0 && sweep_stride != 1))
    return (int)cudaErrorInvalidValue;
  DrawFields F;
  F.nfields = nfields;
  long long blocks = 0;
  for (int f = 0; f < nfields; ++f) {
    const int* row = table + 6 * f;
    if (row[2] < 0 || row[5] < 1) return (int)cudaErrorInvalidValue;
    F.kind[f] = row[0];
    F.tag[f] = (unsigned int)row[1];
    F.count[f] = row[2];
    F.col[f] = row[4];
    F.per[f] = row[5];
    F.base[f] = B * (long long)row[3];
    F.first_block[f] = blocks;
    blocks += (B * (long long)row[2] + GST_DRAW_THREADS - 1)
              / GST_DRAW_THREADS;
  }
  F.first_block[nfields] = blocks;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  sweep_draws_kernel<<<(unsigned int)blocks, GST_DRAW_THREADS, 0,
                       (cudaStream_t)stream>>>(
      keys, sweep, sweep_stride, shapes, nshape, out, B, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
