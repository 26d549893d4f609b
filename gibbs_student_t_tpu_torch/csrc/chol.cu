// Batched small Cholesky with fused forward solve, and the backward solve,
// in float32 (entries gst_chol_fused, gst_tri_solve_T) and float64 (the
// sampler's dtype=float64: gst_chol_fused_f64, gst_tri_solve_T_f64).
//
// Replaces gibbs_student_t_tpu/ops/pallas_chol.py::_chol_kernel (entry
// chol_fused_lane) and ::_backsolve_kernel (entry tri_solve_T_lane). The
// JAX float64 path runs XLA's factorization and triangular solves instead;
// on this card float64 is native, so the port's float64 path launches the
// same kernels instantiated on double (the template parameter T).
//
// What bounds them on an H100: bytes. A factorization of an m x m matrix
// is ~m^3/3 flops against 4 m^2 bytes in and 4 m^2 bytes out, under 3
// flops per byte at m = 60, far below the ~20 FP32 flops per byte where
// the 67 TFLOP/s FP32 rate would take over from the 3.35 TB/s memory
// rate. So S is read once and L written once, and the recurrence stays in
// shared memory.
//
// What held the first factor kernel back was neither: one 128-thread
// block per matrix spent ~10^5 issue slots a matrix on the index
// arithmetic of its trailing update (a division and a modulo per element
// of the full square, half of it discarded), two block barriers per
// column, and scalar 4-byte copies; it ran 18x over its byte bound and
// behind the library factorization. Now (gst_common.cuh has the
// recurrences):
//
// - m <= 95: one warp per matrix, up to eight matrices per block (the
//   wrapper picks: four at the (4 x 1024, 60, 60) launch, whose 4,096
//   warps the card holds almost all at once), a lane owning one, two or
//   three of the rows 0..m (m < 32, m < 64, m <= 95). The matrix is
//   staged into its packed lower triangle with 16-byte loads (when m * m is a
//   multiple of 4 and the tensors are 16-byte aligned, 4-byte otherwise),
//   eight in flight per lane, that skip the quads above the diagonal (a
//   quad's row and column come from one float multiply, not from a
//   division: the copies were half the kernel's time while a chain of
//   counters found them), factored by
//   gst_chol_fwd_warp with the right-hand side as row m, and written back
//   dense, zeros above the diagonal, with 16-byte stores. A matrix that
//   fails (pivot <= 0) turns NaN in its own warp's triangle only; its
//   block-mates share nothing with it.
// - 95 < m <= 160: one block per matrix in a square with an odd row
//   stride, gst_chol_fwd_block (a warp per row of the update, one barrier
//   per column), rows copied with 16-byte accesses when m is a multiple
//   of 4. Below that it is a launch for measurements only (per_block =
//   0): at (1024, 74), the sampler's chunk-end log-posterior, its 74
//   barrier-separated columns lose to the library factorization, and
//   three rows a lane of the warp form beat both.
//
// The back-solve L^T x = r reads 2 m (m + 1) bytes of L for m^2 flops:
// bytes again. Its first kernel (one 32-thread block per system, the full
// square staged by 4-byte loads with a division each, then a shuffle-tree
// dot product, a lane-0 divide that read r from device memory and a
// __syncwarp per step) ran 9-11x over that bound and lost to
// solve_triangular at 8,192 systems. Now it is B1's warp form turned
// around: a warp per system, kSolvePerBlock a block, the triangle
// staged by asynchronous copies that are all in flight at once, and the
// substitution in its column form with r in registers
// (tri_solve_T_kernel). The systems a block change its time little (2 %
// at most from 1 to 8 at every shape the sampler gives it, on an H100), so
// the count is fixed.
//
// Float64 (T = double), what changes with 8-byte elements:
// - shared memory: a matrix of the warp form takes 37 KB at m = 95, so a
//   block holds at most 6 of them within 227 KB (ops/chol.py launch_form
//   and check_per_block cap the count; the launch refuses more); the
//   block form still fits m = 160 (206 KB of square at the odd stride,
//   plus the vectors); the back-solve puts two systems in a block, 210 KB
//   at m = 160;
// - 16-byte copies carry two doubles (VW = 2 when m, or m * m, is even),
//   one-element copies are 8 bytes;
// - rsqrt of a double is not correctly rounded, so the float64 kernels
//   and the plain version (ops/chol.py) part by ulps.
// What bounds them: bytes again (8 an element: m^3/3 flops against 16 m^2
// bytes is under 1.5 flops a byte at m = 60), far below the FP64 ridge.
#include "gst_common.cuh"

namespace {

template <int NR, int VW, typename T>
__global__ void __launch_bounds__(256)
chol_fused_warp_kernel(const T* __restrict__ S, const T* __restrict__ r,
                       T* __restrict__ L, T* __restrict__ u,
                       T* __restrict__ logdet, int B, int m) {
  GST_DYN_SMEM(T, sm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t b = (size_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= (size_t)B) return;        // no block barrier anywhere below
  T* P = sm + warp * gst_warp_floats(m);
  T* rrow = P + gst_tri(m);
  gst_stage_tri<VW>(S + b * m * m, m, P);
  for (int k = lane; k < m; k += 32) rrow[k] = r[b * m + k];
  __syncwarp();
  T ld, quad;
  gst_chol_fwd_warp<NR>(P, m, GstInPlace{P}, ld, quad);
  gst_unstage_tri<VW>(P, m, L + b * m * m);
  for (int k = lane; k < m; k += 32) u[b * m + k] = rrow[k];
  if (lane == 0) logdet[b] = ld;
}

template <int VW, typename T>
__global__ void __launch_bounds__(256)
chol_fused_block_kernel(const T* __restrict__ S, const T* __restrict__ r,
                        T* __restrict__ L, T* __restrict__ u,
                        T* __restrict__ logdet, int m, int lda) {
  GST_DYN_SMEM(T, sm);
  T* A = sm;                     // m * lda
  T* rs = A + m * lda;           // m
  T* us = rs + m;                // m
  T* racc = us + m;              // m
  T* dinv = racc + m;            // m
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const size_t b = blockIdx.x;
  const T* Sb = S + b * m * m;
  for (int i = warp; i < m; i += nw) {
    const T* src = Sb + i * m;
    T* dst = A + i * lda;
    if constexpr (VW == 4) {       // four floats a 16-byte load
      for (int k = 4 * lane; k <= i; k += 128) {
        const float4 v = *reinterpret_cast<const float4*>(src + k);
        dst[k] = v.x;
        dst[k + 1] = v.y;
        dst[k + 2] = v.z;
        dst[k + 3] = v.w;
      }
    } else if constexpr (VW == 2) {  // two doubles
      for (int k = 2 * lane; k <= i; k += 64) {
        const double2 v = *reinterpret_cast<const double2*>(src + k);
        dst[k] = v.x;
        dst[k + 1] = v.y;
      }
    } else {
      for (int k = lane; k <= i; k += 32) dst[k] = src[k];
    }
  }
  for (int i = tid; i < m; i += nt) rs[i] = r[b * m + i];
  T ld, quad;
  gst_chol_fwd_block(A, m, lda, rs, us, racc, dinv, ld, quad);
  T* Lb = L + b * m * m;
  for (int i = warp; i < m; i += nw) {
    const T* src = A + i * lda;
    T* dst = Lb + i * m;
    if constexpr (VW == 4) {
      for (int k = 4 * lane; k < m; k += 128) {
        float4 o;
        o.x = k <= i ? src[k] * dinv[k] : 0.f;
        o.y = k + 1 <= i ? src[k + 1] * dinv[k + 1] : 0.f;
        o.z = k + 2 <= i ? src[k + 2] * dinv[k + 2] : 0.f;
        o.w = k + 3 <= i ? src[k + 3] * dinv[k + 3] : 0.f;
        *reinterpret_cast<float4*>(dst + k) = o;
      }
    } else if constexpr (VW == 2) {
      for (int k = 2 * lane; k < m; k += 64) {
        double2 o;
        o.x = k <= i ? src[k] * dinv[k] : 0.0;
        o.y = k + 1 <= i ? src[k + 1] * dinv[k + 1] : 0.0;
        *reinterpret_cast<double2*>(dst + k) = o;
      }
    } else {
      for (int k = lane; k < m; k += 32)
        dst[k] = k <= i ? src[k] * dinv[k] : T(0);
    }
  }
  for (int i = tid; i < m; i += nt) u[b * m + i] = us[i];
  if (tid == 0) logdet[b] = ld;
}

// L^T x = r, one warp per system, several systems a block: the column
// (axpy) form of the descending substitution, with the right-hand side in
// registers. Lane l owns r[l], r[l + 32], ... (NS = ceil(m / 32) of them,
// five at m = 160), those diagonal entries and their reciprocals. Step j
// (descending): the owner of r[j] forms x_j = r_j / L_jj (correctly
// rounded, as the plain version divides, from the reciprocal and one
// correction: no divide on the chain), one shuffle gives it to the warp,
// and every lane subtracts L[j, k] x_j from its r_k, k < j, reading row j
// of L from shared memory (contiguous, so the lanes' loads hit 32 banks);
// x_j takes r_j's register. No reduction and no barrier sit in the chain:
// a multiply, two FMAs, a shuffle and an FMA a step. L is staged as its
// lower triangle with each row on a 16-byte boundary (gst_ptri: a row's
// slot is rounded to 4 elements), by asynchronous copies that are all in
// flight at once: 16 bytes a lane where the rows of L are 16-byte aligned
// (VW = 4 floats or 2 doubles), else one element; a row's last copy may
// carry up to three floats (one double) past the diagonal, which nothing
// reads. The warps of a block share nothing, so a NaN factor gives a NaN
// x in its own system only.
template <int NS, int VW, typename T>
__global__ void __launch_bounds__(256)
tri_solve_T_kernel(const T* __restrict__ L, const T* __restrict__ r,
                   T* __restrict__ x, int B, int m) {
  GST_DYN_SMEM16(T, sm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t b = (size_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= (size_t)B) return;        // no block barrier anywhere below
  T* P = sm + warp * gst_ptri(m);
  const T* Lb = L + b * m * m;
  for (int i = 0, off = 0; i < m; off += (i + 4) & ~3, ++i) {
    for (int k = VW * lane; k <= i; k += 32 * VW) {
      if (VW > 1)
        gst_cp16(P + off + k, Lb + i * m + k);
      else
        gst_cp4(P + off + k, Lb + i * m + k);
    }
  }
  gst_cp_commit();
  T rr[NS], dg[NS], inv[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int k = lane + 32 * s;
    rr[s] = k < m ? r[b * m + k] : T(0);
  }
  gst_cp_wait<0>();
  __syncwarp();
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int k = lane + 32 * s;
    dg[s] = k < m ? P[gst_ptri(k) + k] : T(1);
    inv[s] = T(1) / dg[s];
  }
  int off = gst_ptri(m - 1);         // offset of row j
#pragma unroll
  for (int sj = NS - 1; sj >= 0; --sj) {
    const int base = 32 * sj;
    if (base >= m) continue;         // warp-uniform
    for (int jj = min(31, m - 1 - base); jj >= 0; --jj) {
      const int j = base + jj;
      const T* row = P + off;
      // r_j / L_jj, the correctly rounded quotient: the product with the
      // reciprocal and one correction by its residual (two FMAs)
      const T q = rr[sj] * inv[sj];
      const T xo = gst_fma(gst_fma(-q, dg[sj], rr[sj]), inv[sj], q);
      const T xj = __shfl_sync(GST_FULL_MASK, xo, jj);
#pragma unroll
      for (int s = 0; s < sj; ++s)
        rr[s] = gst_fma(-row[lane + 32 * s], xj, rr[s]);
      const T a = row[min(lane + base, j)];
      rr[sj] = lane < jj ? gst_fma(-a, xj, rr[sj])
                         : (lane == jj ? xj : rr[sj]);
      off -= (j + 3) & ~3;           // row j - 1 takes j elements, rounded
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int k = lane + 32 * s;
    if (k < m) x[b * m + k] = rr[s];
  }
}

template <int NR, int VW, typename T>
cudaError_t launch_warp(const T* S, const T* r, T* L, T* u, T* logdet, int B,
                        int m, int per_block, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)per_block * gst_warp_floats(m);
  if (smem > GST_SMEM_OPTIN) return cudaErrorInvalidValue;
  cudaError_t e = gst_smem_optin(chol_fused_warp_kernel<NR, VW, T>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (B + per_block - 1) / per_block;
  chol_fused_warp_kernel<NR, VW, T><<<blocks, 32 * per_block, smem, stream>>>(
      S, r, L, u, logdet, B, m);
  return cudaGetLastError();
}

template <int VW, typename T>
cudaError_t launch_warp_rows(const T* S, const T* r, T* L, T* u, T* logdet,
                             int B, int m, int per_block,
                             cudaStream_t stream) {
  // rows 0..m over 32 lanes, at most three a lane: the right-hand side is
  // row m
  if (m < 32)
    return launch_warp<1, VW>(S, r, L, u, logdet, B, m, per_block, stream);
  if (m < 64)
    return launch_warp<2, VW>(S, r, L, u, logdet, B, m, per_block, stream);
  return launch_warp<3, VW>(S, r, L, u, logdet, B, m, per_block, stream);
}

template <int VW, typename T>
cudaError_t launch_block(const T* S, const T* r, T* L, T* u, T* logdet,
                         int B, int m, cudaStream_t stream) {
  const int lda = m | 1;
  const size_t smem = sizeof(T) * ((size_t)m * lda + 4 * m);
  if (smem > GST_SMEM_OPTIN) return cudaErrorInvalidValue;
  cudaError_t e = gst_smem_optin(chol_fused_block_kernel<VW, T>, smem);
  if (e != cudaSuccess) return e;
  chol_fused_block_kernel<VW, T><<<B, 256, smem, stream>>>(S, r, L, u,
                                                           logdet, m, lda);
  return cudaGetLastError();
}

// per_block > 0: the warp form with that many matrices (warps) per block,
// 1 <= per_block <= 8, m <= 95, the matrices within 227 KB of shared
// memory (8 floats or 6 doubles at m = 95). per_block == 0: the block
// form, one 256-thread block per matrix, m <= 160.
template <typename T>
int chol_fused_entry(const T* S, const T* r, T* L, T* u, T* logdet, int B,
                     int m, int per_block, cudaStream_t st) {
  constexpr int V = GstVec<T>::N;
  if (m < 1 || per_block < 0 || per_block > 8)
    return (int)cudaErrorInvalidValue;
  if (per_block > 0) {
    if (m > GST_WARP3_MAX_M) return (int)cudaErrorInvalidValue;
    const bool vec = ((m * m) % V) == 0 && gst_aligned16(S, L);
    return (int)(vec ? launch_warp_rows<V>(S, r, L, u, logdet, B, m,
                                           per_block, st)
                     : launch_warp_rows<1>(S, r, L, u, logdet, B, m,
                                           per_block, st));
  }
  if (m > GST_BLOCK_MAX_M) return (int)cudaErrorInvalidValue;
  const bool vec = (m % V) == 0 && gst_aligned16(S, L);
  return (int)(vec ? launch_block<V>(S, r, L, u, logdet, B, m, st)
                   : launch_block<1>(S, r, L, u, logdet, B, m, st));
}

// systems (warps) a back-solve block: four float triangles of m = 160
// take 205 KB, two double ones 210 KB, inside the 227 KB a block may opt
// into
template <typename T>
constexpr int kSolvePerBlock = 16 / sizeof(T);
static_assert(sizeof(float) * kSolvePerBlock<float> *
                      gst_ptri(GST_BLOCK_MAX_M) <= GST_SMEM_OPTIN &&
                  sizeof(double) * kSolvePerBlock<double> *
                          gst_ptri(GST_BLOCK_MAX_M) <= GST_SMEM_OPTIN,
              "a back-solve block's triangles must fit in shared memory");

template <int NS, int VW, typename T>
cudaError_t launch_solve_vw(const T* L, const T* r, T* x, int B, int m,
                            cudaStream_t stream) {
  constexpr int PB = kSolvePerBlock<T>;
  const size_t smem = sizeof(T) * (size_t)PB * gst_ptri(m);
  cudaError_t e = gst_smem_optin(tri_solve_T_kernel<NS, VW, T>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (B + PB - 1) / PB;
  tri_solve_T_kernel<NS, VW, T><<<blocks, 32 * PB, smem, stream>>>(L, r, x,
                                                                   B, m);
  return cudaGetLastError();
}

template <int NS, typename T>
cudaError_t launch_solve(bool vec, const T* L, const T* r, T* x, int B,
                         int m, cudaStream_t stream) {
  return vec ? launch_solve_vw<NS, GstVec<T>::N>(L, r, x, B, m, stream)
             : launch_solve_vw<NS, 1>(L, r, x, B, m, stream);
}

// m <= 160.
template <typename T>
int tri_solve_T_entry(const T* L, const T* r, T* x, int B, int m,
                      cudaStream_t st) {
  if (m < 1 || m > GST_BLOCK_MAX_M) return (int)cudaErrorInvalidValue;
  if (!B) return (int)cudaSuccess;
  const bool vec = (m % GstVec<T>::N) == 0 && gst_aligned16(L);
  const int ns = (m + 31) / 32;
  switch (ns) {
    case 1: return (int)launch_solve<1>(vec, L, r, x, B, m, st);
    case 2: return (int)launch_solve<2>(vec, L, r, x, B, m, st);
    case 3: return (int)launch_solve<3>(vec, L, r, x, B, m, st);
    case 4: return (int)launch_solve<4>(vec, L, r, x, B, m, st);
    default: return (int)launch_solve<5>(vec, L, r, x, B, m, st);
  }
}

}  // namespace

extern "C" {

int gst_chol_fused(const float* S, const float* r, float* L, float* u,
                   float* logdet, int B, int m, int per_block, void* stream) {
  return chol_fused_entry(S, r, L, u, logdet, B, m, per_block,
                          (cudaStream_t)stream);
}

int gst_chol_fused_f64(const double* S, const double* r, double* L,
                       double* u, double* logdet, int B, int m,
                       int per_block, void* stream) {
  return chol_fused_entry(S, r, L, u, logdet, B, m, per_block,
                          (cudaStream_t)stream);
}

int gst_tri_solve_T(const float* L, const float* r, float* x, int B, int m,
                    void* stream) {
  return tri_solve_T_entry(L, r, x, B, m, (cudaStream_t)stream);
}

int gst_tri_solve_T_f64(const double* L, const double* r, double* x, int B,
                        int m, void* stream) {
  return tri_solve_T_entry(L, r, x, B, m, (cudaStream_t)stream);
}

}  // extern "C"
