// Device helpers shared by the port's kernels (chol.cu, white_mh.cu,
// hyper_mh.cu): the block-cooperative Cholesky recurrence, block sums and
// the prior table. Built with IEEE logf/expf/rsqrtf semantics (no
// --use_fast_math): a non-PD pivot must give NaN, an out-of-bounds prior
// -inf, and an MH accept compares `delta > logu` so NaN rejects.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define GST_LN10 2.302585092994046f
#define GST_LOG_2PI 1.8378770664093453f

// Right-looking Cholesky of the lower triangle of A (m x m, row stride
// lda, in shared memory), in place, with the forward solve u = L^-1 r
// fused — the recurrence of gibbs_student_t_tpu/ops/pallas_chol.py
// _chol_kernel: per column j the pivot's rsqrt scales the column, the
// forward-solve entry u_j = (r_j - racc_j) * inv rides along, and a
// rank-1 update refreshes the trailing lower triangle. On return the
// lower triangle of A holds L (the upper triangle is untouched), u[0:m]
// holds L^-1 r, out2[0] = sum log pivot = logdet A and
// out2[1] = sum u_j^2. `r`, `u`, `col`, `racc` are shared m-vectors,
// `out2` two shared floats. Every thread of the block must call it.
// A pivot <= 0 gives NaN (rsqrt of a negative) that poisons every later
// column, logdet and u — the branchless failure callers rely on.
__device__ __forceinline__ void gst_chol_fwd(float* A, int m, int lda,
                                             const float* r, float* u,
                                             float* col, float* racc,
                                             float* out2) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < m; i += nt) racc[i] = 0.f;
  if (tid == 0) {
    out2[0] = 0.f;
    out2[1] = 0.f;
  }
  __syncthreads();
  for (int j = 0; j < m; ++j) {
    const float piv = A[j * lda + j];
    const float inv = rsqrtf(piv);
    for (int i = j + tid; i < m; i += nt) col[i] = A[i * lda + j] * inv;
    if (tid == 0) {
      const float uj = (r[j] - racc[j]) * inv;
      u[j] = uj;
      out2[0] += logf(piv);
      out2[1] += uj * uj;
    }
    __syncthreads();
    const float uj = u[j];
    const int mt = m - j - 1;
    for (int idx = tid; idx < mt * mt; idx += nt) {
      const int i = j + 1 + idx / mt;
      const int k = j + 1 + idx % mt;
      if (k <= i) A[i * lda + k] -= col[i] * col[k];
    }
    for (int i = j + tid; i < m; i += nt) {
      A[i * lda + j] = col[i];
      if (i > j) racc[i] += col[i] * uj;
    }
    __syncthreads();
  }
}

// Sum of `v` over the block, valid on thread 0 only. `red` is a shared
// buffer of at least 32 floats; the call ends with a barrier so `red`
// can be reused at once.
__device__ __forceinline__ float gst_block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
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
__device__ __forceinline__ float gst_lnprior_col(float q, float kind,
                                                 float a, float b) {
  const bool inb = (q >= a) && (q <= b);
  if (kind == 0.f) return inb ? -logf(b - a) : -INFINITY;
  if (kind == 1.f) {
    const float z = (q - a) / b;
    return -0.5f * z * z - logf(b) - 0.5f * GST_LOG_2PI;
  }
  if (kind == 2.f)
    return inb ? q * GST_LN10 + logf(GST_LN10 / (powf(10.f, b) - powf(10.f, a)))
               : -INFINITY;
  return -INFINITY;
}

// Sum of the log-priors of q[0:p]; `specs` is the (3, p) table, row-major.
__device__ __forceinline__ float gst_lnprior_sum(const float* q,
                                                 const float* specs, int p) {
  float s = 0.f;
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
