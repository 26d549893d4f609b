// The per-chain draw arithmetic shared by D1 (draws.cu) and the probe
// kernels that count its instructions (tools/torch_kernel_ab.py): the
// Philox-4x32-10 block, the exact bits -> uniform map, Box-Muller and one
// Marsaglia-Tsang attempt. Each expression is the plain version's
// (ops/rng.py) in the same order; a file that includes this header is
// built with -fmad=false (ops/_cuda.py SOURCE_FLAGS), so that nvcc
// contracts no multiply and add into an FMA that the CPU's separate
// PyTorch operations round twice.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// field kinds (ops/rng.py UNIFORM .. GAMMA)
enum { GST_UNIFORM = 0, GST_NORMAL = 1, GST_LOG_UNIFORM = 2, GST_GUMBEL = 3,
       GST_GAMMA = 4 };

#define GST_PHILOX_M0 0xD2511F53u
#define GST_PHILOX_M1 0xCD9E8D57u
#define GST_PHILOX_W0 0x9E3779B9u
#define GST_PHILOX_W1 0xBB67AE85u
#define GST_TWO_PI 6.283185307179586476925286766559

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

// A non-uniform, non-gamma value of element e: its block at (e, 0, tag,
// sweep) mapped by the field's kind.
__device__ __forceinline__ double gst_plain_value(int kind, uint32_t k0,
                                                  uint32_t k1, uint32_t e,
                                                  uint32_t tag,
                                                  uint32_t sweep) {
  uint32_t c[4] = {e, 0u, tag, sweep};
  gst_philox(k0, k1, c);
  const double u = gst_u01(c[0]);
  if (kind == GST_UNIFORM) return u;
  if (kind == GST_LOG_UNIFORM) return log(u);
  if (kind == GST_GUMBEL) return -log(-log(u));
  return gst_box_muller(c[0], c[1]);
}

// The constants of a Marsaglia-Tsang shape a: d and c = 1 / (3 sqrt d), of
// a + 1 for a boosted shape (a < 1).
__device__ __forceinline__ void gst_mt_consts(double a, double& d,
                                              double& cc) {
  d = (a < 1.0 ? a + 1.0 : a) - 1.0 / 3.0;
  cc = 1.0 / (3.0 * sqrt(d));
}

// One Marsaglia-Tsang (2000) attempt at counters (e, attempt, tag,
// sweep): the normal from words 0-1, the squeeze uniform word 2. True
// and g = d v when it accepts; w3 is the block's word 3 (attempt 0's is
// the boost uniform).
__device__ __forceinline__ bool gst_mt_attempt(uint32_t k0, uint32_t k1,
                                               uint32_t e, uint32_t attempt,
                                               uint32_t tag, uint32_t sweep,
                                               double d, double cc,
                                               double& g, uint32_t& w3) {
  uint32_t c[4] = {e, attempt, tag, sweep};
  gst_philox(k0, k1, c);
  w3 = c[3];
  const double x = gst_box_muller(c[0], c[1]);
  double v = 1.0 + cc * x;
  if (v <= 0.0) return false;
  v = v * v * v;
  const double lhs = log(gst_u01(c[2]));
  if (lhs < 0.5 * x * x + d - d * v + d * log(v)) {
    g = d * v;
    return true;
  }
  return false;
}

// The boost Gamma(a) = Gamma(a + 1) U^(1/a) of an accepted g, U^(1/a) as
// exp(log U / a) with U the uniform of attempt 0's word 3.
__device__ __forceinline__ double gst_mt_boost(double g, uint32_t w3,
                                               double a) {
  return g * exp(log(gst_u01(w3)) / a);
}
