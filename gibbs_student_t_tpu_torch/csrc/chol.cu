// Batched small Cholesky with fused forward solve, and the backward solve.
//
// Replaces gibbs_student_t_tpu/ops/pallas_chol.py::_chol_kernel (entry
// chol_fused_lane) and ::_backsolve_kernel (entry tri_solve_T_lane).
//
// What bounds them on an H100: bytes. A factorization of an m x m matrix
// is ~m^3/3 flops against 4 m^2 bytes in and 4 m^2 bytes out, under 3
// flops per byte at m = 60, far below the ~20 FP32 flops per byte where
// the 67 TFLOP/s FP32 rate would take over from the 3.35 TB/s memory
// rate. The design therefore reads S once and writes L once, coalesced,
// and keeps the whole recurrence in shared memory: one thread block per
// matrix (the TPU kernel's chains-on-lanes layout is a VPU artefact; on
// Hopper a block per matrix gives many independent blocks per SM). What
// it pays instead is a barrier per column (2m per matrix), which is the
// latency the first version accepts; batching several matrices per block
// is the later optimisation.
#include "gst_common.cuh"

namespace {

__global__ void chol_fused_kernel(const float* __restrict__ S,
                                  const float* __restrict__ r,
                                  float* __restrict__ L,
                                  float* __restrict__ u,
                                  float* __restrict__ logdet, int m) {
  extern __shared__ float sm[];
  float* A = sm;                 // m * m
  float* rs = A + m * m;         // m
  float* us = rs + m;            // m
  float* col = us + m;           // m
  float* racc = col + m;         // m
  float* out2 = racc + m;        // 2
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;
  const float* Sb = S + b * m * m;
  for (int idx = tid; idx < m * m; idx += nt) A[idx] = Sb[idx];
  for (int i = tid; i < m; i += nt) rs[i] = r[b * m + i];
  __syncthreads();
  gst_chol_fwd(A, m, m, rs, us, col, racc, out2);
  float* Lb = L + b * m * m;
  for (int idx = tid; idx < m * m; idx += nt) {
    const int i = idx / m, k = idx % m;
    Lb[idx] = (k <= i) ? A[idx] : 0.f;
  }
  for (int i = tid; i < m; i += nt) u[b * m + i] = us[i];
  if (tid == 0) logdet[b] = out2[0];
}

// L^T x = r, one warp per system: descending substitution with the
// column dot product of each step reduced by warp shuffles. L is staged
// in shared memory with an odd row stride so the column walk of a step
// hits 32 distinct banks.
__global__ void tri_solve_T_kernel(const float* __restrict__ L,
                                   const float* __restrict__ r,
                                   float* __restrict__ x, int m, int lda) {
  extern __shared__ float sm[];
  float* Ls = sm;                // m * lda
  float* xs = Ls + m * lda;      // m
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* Lb = L + b * m * m;
  for (int idx = lane; idx < m * m; idx += 32) {
    const int i = idx / m, k = idx % m;
    if (k <= i) Ls[i * lda + k] = Lb[idx];
  }
  __syncwarp();
  for (int j = m - 1; j >= 0; --j) {
    float part = 0.f;
    for (int i = j + 1 + lane; i < m; i += 32) part += Ls[i * lda + j] * xs[i];
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) xs[j] = (r[b * m + j] - part) / Ls[j * lda + j];
    __syncwarp();
  }
  for (int i = lane; i < m; i += 32) x[b * m + i] = xs[i];
}

}  // namespace

extern "C" {

// Shared memory the factor kernel needs for an m x m system (bytes).
size_t gst_chol_smem(int m) { return sizeof(float) * ((size_t)m * m + 4 * m + 2); }

int gst_chol_fused(const float* S, const float* r, float* L, float* u,
                   float* logdet, int B, int m, void* stream) {
  const size_t smem = gst_chol_smem(m);
  cudaError_t e = gst_smem_optin(chol_fused_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = m <= 64 ? 128 : 256;
  chol_fused_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(S, r, L, u,
                                                                logdet, m);
  return (int)cudaGetLastError();
}

int gst_tri_solve_T(const float* L, const float* r, float* x, int B, int m,
                    void* stream) {
  const int lda = (m % 2) ? m : m + 1;
  const size_t smem = sizeof(float) * ((size_t)m * lda + m);
  cudaError_t e = gst_smem_optin(tri_solve_T_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  tri_solve_T_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(L, r, x, m, lda);
  return (int)cudaGetLastError();
}

}  // extern "C"
