// The whole hyper-parameter Metropolis-Hastings block in one launch.
//
// Replaces gibbs_student_t_tpu/ops/pallas_hyper.py::_hyper_kernel (entry
// hyper_mh_fused). Per chain, on the sweep's Schur block S0 (v x v), for
// the current point and each of S proposals q = x + dx[j]:
//   log phi  = K[0] + sum_k K[1+k] * q[hyp_idx[k]]      (affine, per column)
//   phiinv   = sel * exp(-log phi);  d = dS0 + phiinv;  isd = rsqrt(d)
//   A        = isd_i isd_j S0 off the diagonal, exactly 1 + jitter on it
//   L L^T = A with u = L^-1 (rt * isd) fused            (gst_chol_fwd)
//   ll       = base + 1/2 (sum u^2 - (logdet A + sum log d) - sum sel log phi)
// a non-finite ll becomes -inf, the prior comes from the (kind, a, b)
// table, and the step accepts when (ll1 + lp1) - (ll0 + lp0) > logu.
//
// What bounds it on an H100: operations. Per chain it reads S0 once
// (4 v^2 bytes) and does S+1 factorizations (~(S+1) v^3/3 flops), ~60
// flops per byte at v = 60, past the ~20 flops per byte FP32 ridge. The
// design keeps S0 in shared memory for the whole block, builds each
// proposal's equilibrated matrix into a second shared buffer and factors
// it in place; only logdet and the quadratic form leave the recurrence.
// One block per chain. Two v x v buffers bound v: MAX_HYPER_V = 160
// (~212 KB of the 227 KB a block may use); above it the sampler takes the
// closure path through the chol kernel.
#include "gst_common.cuh"

#define GST_HYPER_MAXK 16

struct GstHypIdx {
  int n;
  int idx[GST_HYPER_MAXK];
};

namespace {

struct HyperSmem {
  float *S0, *A, *dS0, *rt, *K, *sel, *isd, *rp, *u, *col, *racc, *sx, *sq,
      *sp, *out2;
};

// (ll, on thread 0) of proposal q.
__device__ float hyper_ll(const float* q, const HyperSmem& s,
                          const GstHypIdx& hi, int v, float base,
                          float jitter, float* red) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float plph = 0.f, plogd = 0.f;
  for (int c = tid; c < v; c += nt) {
    float lph = s.K[c];
    for (int k = 0; k < hi.n; ++k) lph = lph + s.K[(1 + k) * v + c] * q[hi.idx[k]];
    const float phiinv = s.sel[c] * expf(-lph);
    const float d = s.dS0[c] + phiinv;
    const float isd = rsqrtf(d);
    s.isd[c] = isd;
    s.rp[c] = s.rt[c] * isd;
    plph += s.sel[c] * lph;
    plogd += logf(d);
  }
  const float sum_lph = gst_block_sum(plph, red);
  const float sum_logd = gst_block_sum(plogd, red);
  for (int idx = tid; idx < v * v; idx += nt) {
    const int i = idx / v, k = idx % v;
    if (k <= i)
      s.A[idx] = (i == k) ? 1.f + jitter : s.S0[idx] * s.isd[i] * s.isd[k];
  }
  __syncthreads();
  gst_chol_fwd(s.A, v, v, s.rp, s.u, s.col, s.racc, s.out2);
  float ll = 0.f;
  if (tid == 0) {
    ll = base + 0.5f * (s.out2[1] - (s.out2[0] + sum_logd) - sum_lph);
    if (!isfinite(ll)) ll = -INFINITY;
  }
  return ll;
}

__global__ void hyper_mh_kernel(const float* __restrict__ x,
                                const float* __restrict__ S0,
                                const float* __restrict__ dS0,
                                const float* __restrict__ rt,
                                const float* __restrict__ base,
                                const float* __restrict__ dx,
                                const float* __restrict__ logu,
                                const float* __restrict__ K,
                                const float* __restrict__ sel,
                                const float* __restrict__ specs, GstHypIdx hi,
                                float* __restrict__ xo,
                                float* __restrict__ acc, int v, int p, int S,
                                float jitter) {
  extern __shared__ float sm[];
  HyperSmem s;
  s.S0 = sm;
  s.A = s.S0 + v * v;
  s.dS0 = s.A + v * v;
  s.rt = s.dS0 + v;
  s.K = s.rt + v;                // (1 + nk) * v
  s.sel = s.K + (1 + hi.n) * v;
  s.isd = s.sel + v;
  s.rp = s.isd + v;
  s.u = s.rp + v;
  s.col = s.u + v;
  s.racc = s.col + v;
  s.sx = s.racc + v;             // p
  s.sq = s.sx + p;               // p
  s.sp = s.sq + p;               // 3 * p
  s.out2 = s.sp + 3 * p;         // 2
  __shared__ float red[32];
  __shared__ int accept;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t c = blockIdx.x;
  const float* S0c = S0 + c * v * v;
  for (int idx = tid; idx < v * v; idx += nt) s.S0[idx] = S0c[idx];
  for (int i = tid; i < v; i += nt) {
    s.dS0[i] = dS0[c * v + i];
    s.rt[i] = rt[c * v + i];
    s.sel[i] = sel[i];
  }
  for (int i = tid; i < (1 + hi.n) * v; i += nt) s.K[i] = K[i];
  for (int k = tid; k < p; k += nt) s.sx[k] = x[c * p + k];
  for (int k = tid; k < 3 * p; k += nt) s.sp[k] = specs[k];
  __syncthreads();
  const float bc = base[c];
  float ll0 = hyper_ll(s.sx, s, hi, v, bc, jitter, red);
  float lp0 = tid == 0 ? gst_lnprior_sum(s.sx, s.sp, p) : 0.f;
  float nacc = 0.f;
  for (int j = 0; j < S; ++j) {
    for (int k = tid; k < p; k += nt) s.sq[k] = s.sx[k] + dx[(c * S + j) * p + k];
    __syncthreads();
    const float ll1 = hyper_ll(s.sq, s, hi, v, bc, jitter, red);
    if (tid == 0) {
      const float lp1 = gst_lnprior_sum(s.sq, s.sp, p);
      const bool am = (ll1 + lp1) - (ll0 + lp0) > logu[c * S + j];
      accept = am;
      if (am) {
        ll0 = ll1;
        lp0 = lp1;
        nacc += 1.f;
      }
    }
    __syncthreads();
    if (accept)
      for (int k = tid; k < p; k += nt) s.sx[k] = s.sq[k];
    __syncthreads();
  }
  for (int k = tid; k < p; k += nt) xo[c * p + k] = s.sx[k];
  if (tid == 0) acc[c] = nacc / (float)S;
}

}  // namespace

extern "C" {

size_t gst_hyper_smem(int v, int p, int nk) {
  return sizeof(float) * (2 * (size_t)v * v + (size_t)(9 + nk) * v + 5 * p + 2);
}

// hyp_host: nk ints in host memory, the x-indices the K rows multiply.
int gst_hyper_mh(const float* x, const float* S0, const float* dS0,
                 const float* rt, const float* base, const float* dx,
                 const float* logu, const float* K, const float* sel,
                 const float* specs, const int* hyp_host, int nk, float* xo,
                 float* acc, int C, int v, int p, int S, float jitter,
                 void* stream) {
  if (nk > GST_HYPER_MAXK) return (int)cudaErrorInvalidValue;
  GstHypIdx hi;
  hi.n = nk;
  for (int k = 0; k < nk; ++k) hi.idx[k] = hyp_host[k];
  const size_t smem = gst_hyper_smem(v, p, nk);
  cudaError_t e = gst_smem_optin(hyper_mh_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = v <= 64 ? 128 : 256;
  hyper_mh_kernel<<<C, threads, smem, (cudaStream_t)stream>>>(
      x, S0, dS0, rt, base, dx, logu, K, sel, specs, hi, xo, acc, v, p, S,
      jitter);
  return (int)cudaGetLastError();
}

}  // extern "C"
