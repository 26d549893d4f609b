// Device helpers shared by the port's kernels (chol.cu, white_mh.cu,
// hyper_mh.cu, tnt.cu): the Cholesky recurrence in its two forms, the
// triangle layouts and their staging, asynchronous copies, warp and block
// sums and the prior table. Built with IEEE logf/expf/rsqrtf semantics (no
// --use_fast_math): a non-PD pivot must give NaN, an out-of-bounds prior
// -inf, and an MH accept compares `delta > logu` so NaN rejects.
//
// The factor code. A factorization of an m x m float32 matrix is m^3/6
// multiply-adds (36,000 at m = 60, ~1,100 warp-wide FMAs), so what a
// small factor costs on an H100 is not arithmetic but everything around
// it. The first version ran one thread block per matrix through a
// right-looking recurrence and was bound by issue slots: its
// trailing update walked the full (m-j-1)^2 square with an integer
// division and a modulo per element and discarded the upper half, took
// two block barriers per column, and left the per-column scalar work
// (log, forward-solve entry, running sums) to thread 0 while the others
// waited. Two forms replace it:
//
// - gst_chol_fwd_warp (m <= 95): one warp owns one matrix; lane l owns
//   rows l, l + 32 and l + 64 (NR = 1, 2 or 3 of them: the rows 0..m,
//   the right-hand side being row m). The matrix lives in shared memory
//   as its packed lower triangle (row i at offset i(i+1)/2: triangular
//   numbers are a complete residue system modulo 32, and tri(i + 32) -
//   tri(i) = 32 i + 528 and tri(i + 64) - tri(i) = 64 i + 2,080 are
//   constant modulo 32, so the 32 lanes' rows of each slot fall on 32
//   distinct banks without padding, and a matrix takes half the shared
//   memory of a square, which doubles the warps an SM holds). The
//   recurrence is left-looking over panels of four columns: each lane
//   accumulates its rows' entries of columns j .. j + 3 over k < j with
//   plain counters (one load per row and four broadcast loads for four
//   FMAs per row), the panel's 4 x 4 diagonal block travels by ten
//   shuffles in flight together and every lane factors it for itself, so
//   no thread waits on another's scalar work, and the only
//   synchronisation is one __syncwarp() per panel.
//   The code does not branch on the lane anywhere. The right-hand side
//   rides along as row m of the matrix, so the forward solve u = L^-1 r
//   is that row of the factor; the pivots' logs are taken once, after the
//   last column, a row's by its lane. A panel skips the row slots whose
//   rows are all finished (slot r once the panel's first column reaches
//   32 (r + 1)), so a lane's work falls as the factor advances.
// - gst_chol_fwd_block (m <= 160; the factor takes it above m = 95, the
//   hyper kernel above v = 64): one block per matrix, as before, but a
//   warp owns a row of the trailing update and its lanes that row's
//   columns up to the diagonal (no division, no modulo, no discarded
//   half); the column is scaled on the fly from the unscaled entries and
//   the pivot's rsqrt, which leaves one barrier per column; every thread
//   keeps logdet and the quadratic form itself.
//
// Both forms subtract the products of an entry in ascending column order
// with the FMA shape a[i][k] = fma(-l[i][j], l[k][j], a[i][k]), j = 0, 1,
// ..., the rounding sequence of the right-looking plain version
// (ops/chol.py chol_fused_plain); the forward solve accumulates
// racc = sum_j l[i][j] u[j] from zero and forms (r - racc) * inv, as the
// plain version does, and logdet and sum u^2 are summed in ascending j.
// A pivot <= 0 gives NaN (rsqrt of a negative) that poisons every later
// column, logdet and u of its own matrix only — the branchless failure
// callers rely on.
//
// The scalar type. Every helper below is a template on T, float or double:
// the float instantiations serve the float32 kernels (chol.cu,
// white_mh.cu, hyper_mh.cu, tnt.cu), the double ones the float64 forms of
// the kernels of chol.cu, hyper_mh.cu and white_mh.cu (templates on the
// scalar type too; the sampler's dtype=float64): the same recurrences,
// staging and sums with log, exp, rsqrt and fma of double (gst_log,
// gst_exp, gst_rsqrt, gst_fma pick the function of T; the float
// instantiations call logf, expf, rsqrtf and fmaf as before, so the
// float32 kernels' PTX is what it was before the template). A 16-byte
// access carries GstVec<T>::N elements (four floats, two doubles), and the
// layouts count elements, not bytes: a packed triangle of m rows takes
// gst_warp_floats(m) elements of T.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <math.h>
#include <stdint.h>

#define GST_LN10 2.302585092994046f
#define GST_LOG_2PI 1.8378770664093453f
#define GST_FULL_MASK 0xffffffffu
// largest m of the hyper kernel's warp form (its proposals' v), of
// gst_chol_fwd_warp (rows 0..m, three a lane), and of the block form
// (5 x 32 columns a lane)
#define GST_WARP_MAX_M 64
#define GST_WARP3_MAX_M 95
#define GST_BLOCK_MAX_M 160
#define GST_BLOCK_COLS 5
// shared memory a block may use on an H100 (227 KB)
#define GST_SMEM_OPTIN 232448
// white_mh.cu: n above which the cluster form runs (ops/white_mh.py reads
// it from here)
#define GST_WHITE_CROSSOVER 1024

// The functions of the scalar type: logf / log, expf / exp, rsqrtf /
// rsqrt, fmaf / fma, powf / pow.
__device__ __forceinline__ float gst_log(float x) { return logf(x); }
__device__ __forceinline__ double gst_log(double x) { return log(x); }
__device__ __forceinline__ float gst_exp(float x) { return expf(x); }
__device__ __forceinline__ double gst_exp(double x) { return exp(x); }
__device__ __forceinline__ float gst_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double gst_rsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float gst_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double gst_fma(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float gst_pow(float a, float b) {
  return powf(a, b);
}
__device__ __forceinline__ double gst_pow(double a, double b) {
  return pow(a, b);
}

// The constants in T: the float ones are the float literals the float32
// kernels always used.
template <typename T>
struct GstK;
template <>
struct GstK<float> {
  static constexpr float ln10 = GST_LN10;
  static constexpr float log_2pi = GST_LOG_2PI;
};
template <>
struct GstK<double> {
  static constexpr double ln10 = 2.302585092994046;
  static constexpr double log_2pi = 1.8378770664093453;
};

// A 16-byte vector of T: four floats or two doubles.
template <typename T>
struct GstVec;
template <>
struct GstVec<float> {
  static constexpr int N = 4;
};
template <>
struct GstVec<double> {
  static constexpr int N = 2;
};

// 16-byte load and store of N = GstVec<T>::N elements (src, dst 16-byte
// aligned).
__device__ __forceinline__ void gst_ld16(const float* src, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void gst_ld16(const double* src, double* v) {
  const double2 t = *reinterpret_cast<const double2*>(src);
  v[0] = t.x;
  v[1] = t.y;
}
__device__ __forceinline__ void gst_st16(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void gst_st16(double* dst, const double* v) {
  *reinterpret_cast<double2*>(dst) = make_double2(v[0], v[1]);
}

// `T* sm`, the block's dynamic shared memory as T, declared in a kernel
// templated on T (float or double): as an array of float (16-byte aligned
// with GST_DYN_SMEM16), the float32 kernels' own declaration, or an array
// of double of its own; every extern __shared__ array starts at the
// block's dynamic shared memory. It is declared in the kernel itself: the
// same pointer returned by an accessor function changes the float32
// kernels' code (their PTX; the form below leaves it as it was).
#define GST_DYN_SMEM_AS(T, sm, f32, F32_DECL)                                \
  T* sm;                                                                      \
  if constexpr (std::is_same<T, float>::value) {                              \
    extern __shared__ F32_DECL;                                               \
    sm = f32;                                                                 \
  } else {                                                                    \
    extern __shared__ __align__(16) double gst_smem_f64[];                    \
    sm = gst_smem_f64;                                                        \
  }
#define GST_DYN_SMEM(T, sm)                                                   \
  GST_DYN_SMEM_AS(T, sm, gst_smem_f32, float gst_smem_f32[])
#define GST_DYN_SMEM16(T, sm)                                                 \
  GST_DYN_SMEM_AS(T, sm, gst_smem_f32a, __align__(16) float gst_smem_f32a[])

// Offset of row i in a packed lower triangle.
__device__ __host__ __forceinline__ int gst_tri(int i) {
  return (i * (i + 1)) >> 1;
}

// Elements of shared memory one matrix of the warp form takes: rows 0..m
// of the packed triangle (row m is the right-hand side), rounded up to 4.
__device__ __host__ __forceinline__ int gst_warp_floats(int m) {
  return (gst_tri(m + 1) + 3) & ~3;
}

// Offset of row i in a lower triangle whose rows start on 16-byte
// boundaries (row r takes r + 1 floats rounded up to 4); gst_ptri(m) is the
// floats of the whole m x m triangle.
__device__ __host__ __forceinline__ constexpr int gst_ptri(int i) {
  const int q = i >> 2;
  return 8 * q * (q + 1) + (i & 3) * 4 * (q + 1);
}

// Asynchronous 16-byte and one-element (4- or 8-byte) copies from device
// to shared memory (the 16-byte form zero-fills past `bytes`), their commit
// and their wait.
template <typename T>
__device__ __forceinline__ void gst_cp16(T* dst, const T* src,
                                         int bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void gst_cp4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void gst_cp4(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void gst_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void gst_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum of `v` over the warp, the same bits on every lane.
template <typename T>
__device__ __forceinline__ T gst_warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(GST_FULL_MASK, v, off);
  return v;
}

template <int NR, typename T>
__device__ __forceinline__ T gst_pick(const T (&v)[NR], int r) {
  T out = v[0];
#pragma unroll
  for (int t = 1; t < NR; ++t) out = (r == t) ? v[t] : out;
  return out;
}

// Entry source of the in-place factor: the packed triangle itself.
template <typename T>
struct GstInPlace {
  const T* P;
  __device__ __forceinline__ T operator()(int, int base, int j) const {
    return P[base + j];
  }
};
template <typename T>
GstInPlace(T*) -> GstInPlace<T>;

// Columns j .. j + 3 (j a multiple of 4; those below m) of the warp
// recurrence below, one panel. R0 is the first of a lane's NR rows that is
// still in play (rows 32 r + 31 < j are finished for every lane), a
// compile-time bound so that the k loop holds no branch and its loads can
// be batched. Nothing here branches on the lane: a row that is finished,
// or past the matrix, loads from a valid address and stores to `dump`, a
// slot of the triangle that nothing reads; a column at or past m is
// computed from valid garbage and dropped. `piv` collects the pivots of a
// lane's own rows (their logs are taken once, after the last column).
template <int NR, int R0, typename T, typename Init>
__device__ __forceinline__ void gst_chol_panel(T* P, int m, int j, int bj,
                                               int dump, const Init& init,
                                               const int (&row)[NR],
                                               const int (&base)[NR],
                                               T (&piv)[NR], T& q) {
  const int lane = threadIdx.x & 31;
  // rows j .. j + 3 as broadcast operands, and the columns' own indices,
  // held at m where the panel runs past the matrix
  int col[4];
  const T* pc[4];
  {
    int off = bj;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      col[c] = min(j + c, m);
      pc[c] = P + off;
      off += (j + c < m) ? j + c + 1 : 0;
    }
  }
  T acc[NR][4], ex[NR][4];
#pragma unroll
  for (int r = R0; r < NR; ++r) {
    // the right-hand-side row accumulates -racc from zero and adds r_j at
    // the end; a matrix row starts from its entry
    const bool rhs = lane + 32 * r == m;  // row[r] is the row, or 0 past m
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T v = init(row[r], base[r], col[c]);
      acc[r][c] = rhs ? T(0) : v;
      ex[r][c] = rhs ? v : T(0);
    }
  }
  const T* pr[NR];
#pragma unroll
  for (int r = R0; r < NR; ++r) pr[r] = P + base[r];
#pragma unroll 4
  for (int k = 0; k < j; ++k) {
    T b[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = pc[c][k];      // broadcast loads
#pragma unroll
    for (int r = R0; r < NR; ++r) {
      const T a = pr[r][k];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = gst_fma(-a, b[c], acc[r][c]);
    }
  }
  // The owners of rows j .. j + 3 (four neighbouring lanes, one row slot)
  // hold the panel's 4 x 4 diagonal block. Its ten entries travel by
  // shuffles that are all in flight together, and every lane factors the
  // block itself, with the operations the owners apply to their own rows.
  T own[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    T slot[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) slot[r] = r < R0 ? T(0) : acc[r][c];
    own[c] = gst_pick<NR>(slot, j >> 5);
  }
  const int l0 = j & 31;
  const T d00 = __shfl_sync(GST_FULL_MASK, own[0], l0);
  const T d10 = __shfl_sync(GST_FULL_MASK, own[0], l0 + 1);
  const T d20 = __shfl_sync(GST_FULL_MASK, own[0], l0 + 2);
  const T d30 = __shfl_sync(GST_FULL_MASK, own[0], l0 + 3);
  const T d11 = __shfl_sync(GST_FULL_MASK, own[1], l0 + 1);
  const T d21 = __shfl_sync(GST_FULL_MASK, own[1], l0 + 2);
  const T d31 = __shfl_sync(GST_FULL_MASK, own[1], l0 + 3);
  const T d22 = __shfl_sync(GST_FULL_MASK, own[2], l0 + 2);
  const T d32 = __shfl_sync(GST_FULL_MASK, own[2], l0 + 3);
  const T d33 = __shfl_sync(GST_FULL_MASK, own[3], l0 + 3);
  T pv[4], iv[4];
  pv[0] = d00;
  iv[0] = gst_rsqrt(pv[0]);
  const T l10 = d10 * iv[0], l20 = d20 * iv[0], l30 = d30 * iv[0];
  pv[1] = gst_fma(-l10, l10, d11);
  iv[1] = gst_rsqrt(pv[1]);
  const T l21 = gst_fma(-l20, l10, d21) * iv[1];
  const T l31 = gst_fma(-l30, l10, d31) * iv[1];
  pv[2] = gst_fma(-l21, l21, gst_fma(-l20, l20, d22));
  iv[2] = gst_rsqrt(pv[2]);
  const T l32 = gst_fma(-l31, l21, gst_fma(-l30, l20, d32)) * iv[2];
  pv[3] = gst_fma(-l32, l32, gst_fma(-l31, l31, gst_fma(-l30, l30, d33)));
  iv[3] = gst_rsqrt(pv[3]);
#pragma unroll
  for (int r = R0; r < NR; ++r) {
    const int i = lane + 32 * r;
    T cv[4];
    cv[0] = (acc[r][0] + ex[r][0]) * iv[0];
    cv[1] = (gst_fma(-cv[0], l10, acc[r][1]) + ex[r][1]) * iv[1];
    cv[2] = (gst_fma(-cv[1], l21, gst_fma(-cv[0], l20, acc[r][2])) +
             ex[r][2]) * iv[2];
    cv[3] = (gst_fma(-cv[2], l32,
                     gst_fma(-cv[1], l31, gst_fma(-cv[0], l30, acc[r][3]))) +
             ex[r][3]) * iv[3];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = j + c < m;          // warp-uniform
      P[(in && i >= j + c && i <= m) ? base[r] + j + c : dump] = cv[c];
      piv[r] = (in && i == j + c) ? pv[c] : piv[r];
      q = (in && i == m) ? gst_fma(cv[c], cv[c], q) : q;
    }
  }
  __syncwarp();
}

// Warp-level Cholesky with the forward solve fused. P is one warp's packed
// lower triangle in shared memory, gst_warp_floats(m) elements,
// m <= GST_WARP3_MAX_M;
// `init(i, base_i, j)` gives entry (i, j) of the matrix to factor for
// j <= i < m and entry j of the right-hand side for i = m (it may read P
// itself: an entry is read before its column is written); it is also
// called for i < j and for j = m, where it must return without a fault
// and its value is dropped. On return rows 0..m-1 of P hold L and row m
// holds u = L^-1 r (its last slot, P[tri(m) + m], is scratch); `logdet` =
// sum log pivot and `quad` = sum u_j^2 are valid on every lane, logdet
// summed per lane and over the warp by shuffles, quad in ascending j. NR
// is the number of rows a lane owns: 1 for m < 32, 2 for m < 64, 3 for
// 64 <= m <= 95. All 32 lanes of the warp must call it, after a
// __syncwarp() that makes the staged data visible; it ends with one.
template <int NR, typename T, typename Init>
__device__ __forceinline__ void gst_chol_fwd_warp(T* P, int m,
                                                  const Init& init,
                                                  T& logdet, T& quad) {
  const int lane = threadIdx.x & 31;
  int row[NR], base[NR];
  T piv[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int i = lane + 32 * r;
    row[r] = i <= m ? i : 0;
    base[r] = gst_tri(row[r]);
    piv[r] = T(1);                    // log 1 = 0 for rows past the matrix
  }
  const int dump = gst_tri(m) + m;
  T q = T(0);
  int bj = 0;                         // offset of row j
  int j = 0;
  for (; j < m && j < 32; j += 4) {
    gst_chol_panel<NR, 0>(P, m, j, bj, dump, init, row, base, piv, q);
    bj += 4 * j + 10;                 // rows j .. j + 3 hold 4 j + 10 floats
  }
  if (NR > 1) {
    for (; j < m && j < 64; j += 4) {  // a lane's first row is done
      gst_chol_panel<NR, (NR > 1 ? 1 : 0)>(P, m, j, bj, dump, init, row, base,
                                           piv, q);
      bj += 4 * j + 10;
    }
  }
  if (NR > 2) {
    for (; j < m; j += 4) {           // 64 <= j: its second row is done too
      gst_chol_panel<NR, (NR > 2 ? 2 : 0)>(P, m, j, bj, dump, init, row, base,
                                           piv, q);
      bj += 4 * j + 10;
    }
  }
  T ld = T(0);
#pragma unroll
  for (int r = 0; r < NR; ++r) ld += gst_log(piv[r]);
  logdet = gst_warp_sum(ld);
  quad = __shfl_sync(GST_FULL_MASK, q, m & 31);
}

// (row, column) of flat position e of a dense row-major m x m matrix,
// m <= 160, without an integer division: the float product is exact
// enough for e < 25,600, since (e + 0.5) / m is never within 1 / (2 m) of
// an integer (checked on the host for every m). `inv_m` is 1.0f / m, taken
// once by the caller.
__device__ __forceinline__ void gst_flat_pos(int e, int m, float inv_m,
                                             int& i, int& k) {
  i = __float2int_rd(((float)e + 0.5f) * inv_m);
  k = e - i * m;
}

// Copy the lower triangle of a dense row-major m x m matrix S (device
// memory) into the packed triangle P (shared memory), one warp, m <= 160.
// The walk is flat over the matrix, VW elements a lane (VW = GstVec<T>::N:
// 16-byte loads, needs m * m a multiple of VW and S 16-byte aligned; VW = 1
// otherwise), eight independent loads in flight per lane; a load whose
// elements all lie above the diagonal is skipped.
template <int VW, typename T>
__device__ __forceinline__ void gst_stage_tri(const T* __restrict__ S,
                                              int m, T* P) {
  constexpr int U = 8;
  const int lane = threadIdx.x & 31;
  const int nel = m * m;
  const float inv_m = 1.0f / (float)m;
  for (int e0 = VW * lane; e0 < nel; e0 += 32 * VW * U) {
    int wi[U], wk[U];
    bool need[U];
    T vals[U][4];
#pragma unroll
    for (int t = 0; t < U; ++t) {
      const int e = e0 + 32 * VW * t;
      gst_flat_pos(e, m, inv_m, wi[t], wk[t]);
      // some float on or below the diagonal: the position's own, or the
      // start of the next row
      need[t] = e < nel && (wk[t] <= wi[t] || wk[t] + VW > m);
    }
#pragma unroll
    for (int t = 0; t < U; ++t) {
      if (need[t]) {
        const T* src = S + e0 + 32 * VW * t;
        if (VW > 1) {
          gst_ld16(src, vals[t]);
        } else {
          vals[t][0] = src[0];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < U; ++t) {
      if (need[t]) {
        int ii = wi[t], kk = wk[t], bb = gst_tri(ii);
#pragma unroll
        for (int c = 0; c < VW; ++c) {
          if (kk <= ii) P[bb + kk] = vals[t][c];
          if (++kk == m) {
            kk = 0;
            ++ii;
            bb += ii;
          }
        }
      }
    }
  }
}

// The reverse: write the packed triangle P out as a dense row-major m x m
// matrix with zeros above the diagonal, one warp, VW elements a lane.
template <int VW, typename T>
__device__ __forceinline__ void gst_unstage_tri(const T* P, int m,
                                                T* __restrict__ L) {
  const int lane = threadIdx.x & 31;
  const int nel = m * m;
  const float inv_m = 1.0f / (float)m;
#pragma unroll 4
  for (int e = VW * lane; e < nel; e += 32 * VW) {
    T vals[4];
    int ii, kk;
    gst_flat_pos(e, m, inv_m, ii, kk);
    int bb = gst_tri(ii);
#pragma unroll
    for (int c = 0; c < VW; ++c) {
      vals[c] = (kk <= ii) ? P[bb + kk] : T(0);
      if (++kk == m) {
        kk = 0;
        ++ii;
        bb += ii;
      }
    }
    if (VW > 1)
      gst_st16(L + e, vals);
    else
      L[e] = vals[0];
  }
}

// Block-cooperative Cholesky of the lower triangle of A (m x m, odd row
// stride lda, shared memory), m <= GST_BLOCK_MAX_M, with the forward solve
// fused. The columns stay UNSCALED in A: on return L[i][j] = A[i][j] *
// dinv[j] for j <= i (the upper triangle is untouched), u[0:m] = L^-1 r,
// and `logdet` = sum log pivot, `quad` = sum u_j^2 on every thread. `r`,
// `u`, `racc`, `dinv` are shared m-vectors. Every thread of the block
// must call it (blockDim.x a multiple of 32); it starts by zeroing racc
// and a barrier, which also publishes what the caller wrote to A and r,
// and ends with a barrier.
template <typename T>
__device__ __forceinline__ void gst_chol_fwd_block(T* A, int m, int lda,
                                                   const T* r, T* u, T* racc,
                                                   T* dinv, T& logdet,
                                                   T& quad) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  for (int i = tid; i < m; i += nt) racc[i] = T(0);
  __syncthreads();
  T ld = T(0), q = T(0);
  for (int j = 0; j < m; ++j) {
    const T piv = A[j * lda + j];
    const T inv = gst_rsqrt(piv);
    ld += gst_log(piv);
    const T uj = (r[j] - racc[j]) * inv;
    q += uj * uj;
    if (tid == 0) {
      u[j] = uj;
      dinv[j] = inv;
    }
    // this lane's columns of the trailing block, scaled once a step
    T ck[GST_BLOCK_COLS];
#pragma unroll
    for (int t = 0; t < GST_BLOCK_COLS; ++t) {
      const int k = j + 1 + lane + 32 * t;
      ck[t] = k < m ? A[k * lda + j] * inv : T(0);
    }
    for (int i = j + 1 + warp; i < m; i += nw) {
      T* row = A + i * lda;
      const T ci = row[j] * inv;
#pragma unroll
      for (int t = 0; t < GST_BLOCK_COLS; ++t) {
        const int k = j + 1 + lane + 32 * t;
        if (k <= i) row[k] = gst_fma(-ci, ck[t], row[k]);
      }
      if (lane == 0) racc[i] += ci * uj;
    }
    __syncthreads();
  }
  logdet = ld;
  quad = q;
}

// Sum of `v` over the block, valid on thread 0 only. `red` is a shared
// buffer of at least 32 elements; the call ends with a barrier so `red`
// can be reused at once.
template <typename T>
__device__ __forceinline__ T gst_block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = gst_warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = T(0);
  if (threadIdx.x == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    for (int w = 0; w < nw; ++w) s += red[w];
  }
  __syncthreads();
  return s;
}

// One parameter's log-prior from the (kind, a, b) table of
// models/parameter.lnprior_specs: 0 uniform on [a, b], 1 normal(a, b),
// 2 log-uniform-amplitude (LinearExp) on [a, b]; -inf out of bounds.
template <typename T>
__device__ __forceinline__ T gst_lnprior_col(T q, T kind, T a, T b) {
  const bool inb = (q >= a) && (q <= b);
  if (kind == T(0)) return inb ? -gst_log(b - a) : -INFINITY;
  if (kind == T(1)) {
    const T z = (q - a) / b;
    return T(-0.5) * z * z - gst_log(b) - T(0.5) * GstK<T>::log_2pi;
  }
  if (kind == T(2))
    return inb ? q * GstK<T>::ln10 +
                     gst_log(GstK<T>::ln10 /
                             (gst_pow(T(10), b) - gst_pow(T(10), a)))
               : -INFINITY;
  return -INFINITY;
}

// Sum of the log-priors of q[0:p]; `specs` is the (3, p) table, row-major.
template <typename T>
__device__ __forceinline__ T gst_lnprior_sum(const T* q, const T* specs,
                                             int p) {
  T s = T(0);
  for (int k = 0; k < p; ++k)
    s += gst_lnprior_col(q[k], specs[k], specs[p + k], specs[2 * p + k]);
  return s;
}

// Raise the dynamic shared-memory ceiling of `kernel` when a launch needs
// more than the default 48 KB.
template <typename K>
static cudaError_t gst_smem_optin(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Whether every pointer given is 16-byte aligned.
static inline bool gst_aligned16(const void* a, const void* b = nullptr) {
  return (((uintptr_t)a | (uintptr_t)b) & 15u) == 0;
}
