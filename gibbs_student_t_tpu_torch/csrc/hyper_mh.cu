// The whole hyper-parameter Metropolis-Hastings block in one launch.
//
// Replaces gibbs_student_t_tpu/ops/pallas_hyper.py::_hyper_kernel (entry
// hyper_mh_fused). Per chain, on the sweep's Schur block S0 (v x v), for
// the current point and each of S proposals q = x + dx[j]:
//   log phi  = K[0] + sum_k K[1+k] * q[hyp_idx[k]]      (affine, per column)
//   phiinv   = sel * exp(-log phi);  d = dS0 + phiinv;  isd = rsqrt(d)
//   A        = isd_i isd_j S0 off the diagonal, exactly 1 + jitter on it
//   L L^T = A with u = L^-1 (rt * isd) fused     (gst_common.cuh recurrences)
//   ll       = base + 1/2 (sum u^2 - (logdet A + sum log d) - sum sel log phi)
// a non-finite ll becomes -inf, the prior comes from the (kind, a, b)
// table, and the step accepts when (ll1 + lp1) - (ll0 + lp0) > logu.
//
// What bounds it on an H100: operations. Per chain it reads S0 once
// (4 v^2 bytes) and does S+1 factorizations (~(S+1) v^3/3 flops), ~60
// flops per byte at v = 60, past the ~20 flops per byte FP32 ridge.
//
// What held the first version back was latency, not arithmetic: one
// 128-thread block per chain ran S+1 factorizations through the
// block-cooperative recurrence, (S+1) * 2v = 1,320 block barriers per
// chain plus four per proposal for two block sums, a division and a
// modulo per element of the update and of the build of A, and the
// per-column scalar work on thread 0; it ran 150x over its bound, and a
// launch of 64 chains took almost half the time of one of 1,024.
//
// Now, for v <= 64, one warp owns a chain and several chains share a block
// (the wrapper picks how many from C, so that 1,024 chains are one wave
// over the card and 64 chains are 64 blocks). S0 stays in shared memory
// as its packed lower triangle for all S+1 evaluations; a proposal's
// matrix is never built: gst_chol_fwd_warp takes each entry
// isd_i isd_j S0[i][j] (1 + jitter on the diagonal, rt_j isd_j in the
// right-hand-side row) as it starts the entry's column, and writes only
// the factor. The per-column log phi / exp / rsqrt / log work is two
// columns a lane, the three sums are warp shuffles, lane 0 decides the
// accept and a shuffle broadcasts it. Each warp stages its chain's K, sel
// and prior table beside its own buffers ((1 + nk) v + v + 3p floats, under
// 1 KB at v = 60), so the kernel has no block barrier at all.
// For 64 < v <= 160 a block still owns a chain, with gst_chol_fwd_block
// (a warp per row of the update, one barrier per column) and a row-wise
// build of A. Two v x v buffers bound v: MAX_HYPER_V = 160 (~213 KB of the
// 227 KB a block may use); above it the sampler takes the closure path
// through the chol kernel.
//
// Grouped form. The kernel takes the constants of G models (K (G, 1+nk, v),
// sel (G, v), specs (G, 3, p)) and Cg chains per group, group-major: chain
// c reads its group's at g = c / Cg. This replaces hyper_mh_fused at G > 1
// (pallas_hyper.py:371, the multi-pulsar ensemble's per-pulsar constants);
// a single model passes Cg = C and every chain reads group 0. In the warp
// form a block's warps may hold chains of two or more groups (Cg need not
// be a multiple of the chains per block), which is why each warp stages its
// own chain's constants. What bounds the grouped form is what bounds the
// single one: one warp's latency through S + 1 factorizations.
#include "gst_common.cuh"

#define GST_HYPER_MAXK 16

struct GstHypIdx {
  int n;
  int idx[GST_HYPER_MAXK];
};

namespace {

// ---- v <= 64: a warp per chain -------------------------------------------

// Floats of shared memory one chain of the warp form takes: S0 packed, the
// factor packed with the right-hand-side row, dS0, rt, isd (v + 1: the
// right-hand-side row's slot is never read), x and q.
__host__ __device__ inline int hyper_warp_floats(int v, int p) {
  return (gst_tri(v) + gst_warp_floats(v) + 3 * v + 1 + 2 * p + 3) & ~3;
}

struct HyperWarp {
  const float *K, *sel, *sp;     // the chain's group's constants
  float *S0p, *Lp, *dS0, *rt, *isd, *sx, *sq;
};

// Floats of shared memory a warp's copy of its group's constants takes: K,
// sel and the prior table, rounded to keep the next buffer 16-byte aligned.
__host__ __device__ inline int hyper_const_floats(int v, int p, int nk) {
  return ((2 + nk) * v + 3 * p + 3) & ~3;
}

// Entry (i, j) of a proposal's equilibrated matrix, and its right-hand side
// in row v. Branchless, and every load lands inside the chain's shared
// memory for any 0 <= i, j <= v (the recurrence also asks for entries it
// then drops): S0p runs on into the factor, rt into isd, isd has v + 1
// slots.
struct HyperInit {
  const float *S0p, *isd, *rt;
  float diag;
  int v;
  __device__ __forceinline__ float operator()(int i, int base, int j) const {
    const float sj = isd[j];
    const float a = S0p[base + j] * isd[i] * sj;
    const float rj = rt[j] * sj;
    return i == v ? rj : (i == j ? diag : a);
  }
};

// ll of proposal q, the same bits on every lane.
template <int NR>
__device__ __forceinline__ float hyper_ll_warp(const float* q,
                                               const HyperWarp& w,
                                               const GstHypIdx& hi, int v,
                                               float base, float jitter) {
  const int lane = threadIdx.x & 31;
  float plph = 0.f, plogd = 0.f;
  for (int c = lane; c < v; c += 32) {
    float lph = w.K[c];
    for (int k = 0; k < hi.n; ++k) lph = lph + w.K[(1 + k) * v + c] * q[hi.idx[k]];
    const float phiinv = w.sel[c] * expf(-lph);
    const float d = w.dS0[c] + phiinv;
    w.isd[c] = rsqrtf(d);
    plph += w.sel[c] * lph;
    plogd += logf(d);
  }
  const float sum_lph = gst_warp_sum(plph);
  const float sum_logd = gst_warp_sum(plogd);
  __syncwarp();
  float ld, quad;
  gst_chol_fwd_warp<NR>(w.Lp, v, HyperInit{w.S0p, w.isd, w.rt, 1.f + jitter, v},
                        ld, quad);
  float ll = base + 0.5f * (quad - (ld + sum_logd) - sum_lph);
  if (!isfinite(ll)) ll = -INFINITY;
  return ll;
}

template <int NR, int VW>
__global__ void __launch_bounds__(256)
hyper_mh_warp_kernel(const float* __restrict__ x,
                     const float* __restrict__ S0,
                     const float* __restrict__ dS0,
                     const float* __restrict__ rt,
                     const float* __restrict__ base,
                     const float* __restrict__ dx,
                     const float* __restrict__ logu,
                     const float* __restrict__ K,
                     const float* __restrict__ sel,
                     const float* __restrict__ specs, GstHypIdx hi,
                     float* __restrict__ xo, float* __restrict__ acc, int C,
                     int Cg, int v, int p, int S, float jitter) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t c = (size_t)blockIdx.x * (nt >> 5) + warp;
  if (c >= (size_t)C) return;
  const size_t g = c / Cg;
  const int nconst = hyper_const_floats(v, p, hi.n);
  float* Ks = sm + warp * (nconst + hyper_warp_floats(v, p));  // (1 + nk) v
  float* sels = Ks + (1 + hi.n) * v;                           // v
  float* sps = sels + v;                                       // 3 * p
  for (int i = lane; i < (1 + hi.n) * v; i += 32)
    Ks[i] = K[g * (1 + hi.n) * v + i];
  for (int i = lane; i < v; i += 32) sels[i] = sel[g * v + i];
  for (int i = lane; i < 3 * p; i += 32) sps[i] = specs[g * 3 * p + i];
  HyperWarp w;
  w.K = Ks;
  w.sel = sels;
  w.sp = sps;
  w.S0p = Ks + nconst;
  w.Lp = w.S0p + gst_tri(v);
  w.dS0 = w.Lp + gst_warp_floats(v);
  w.rt = w.dS0 + v;
  w.isd = w.rt + v;                        // v + 1
  w.sx = w.isd + v + 1;                    // p
  w.sq = w.sx + p;                         // p
  gst_stage_tri<VW>(S0 + c * v * v, v, w.S0p);
  for (int i = lane; i < v; i += 32) {
    w.dS0[i] = dS0[c * v + i];
    w.rt[i] = rt[c * v + i];
  }
  for (int k = lane; k < p; k += 32) w.sx[k] = x[c * p + k];
  __syncwarp();
  const float bc = base[c];
  float ll0 = hyper_ll_warp<NR>(w.sx, w, hi, v, bc, jitter);
  float lp0 = gst_lnprior_sum(w.sx, w.sp, p);
  float nacc = 0.f;
  for (int j = 0; j < S; ++j) {
    for (int k = lane; k < p; k += 32)
      w.sq[k] = w.sx[k] + dx[(c * S + j) * p + k];
    __syncwarp();
    const float ll1 = hyper_ll_warp<NR>(w.sq, w, hi, v, bc, jitter);
    const float lp1 = gst_lnprior_sum(w.sq, w.sp, p);
    int am = (ll1 + lp1) - (ll0 + lp0) > logu[c * S + j];
    am = __shfl_sync(GST_FULL_MASK, am, 0);      // lane 0 decides
    if (am) {
      ll0 = ll1;
      lp0 = lp1;
      nacc += 1.f;
      for (int k = lane; k < p; k += 32) w.sx[k] = w.sq[k];
    }
    __syncwarp();
  }
  for (int k = lane; k < p; k += 32) xo[c * p + k] = w.sx[k];
  if (lane == 0) acc[c] = nacc / (float)S;
}

// ---- 64 < v <= 160: a block per chain ----------------------------------------

struct HyperSmem {
  float *S0, *A, *dS0, *rt, *K, *sel, *isd, *rp, *u, *racc, *dinv, *sx, *sq,
      *sp;
};

// (ll, on thread 0) of proposal q.
__device__ float hyper_ll_block(const float* q, const HyperSmem& s,
                                const GstHypIdx& hi, int v, int lda,
                                float base, float jitter, float* red) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
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
  for (int i = warp; i < v; i += nw) {
    const float* src = s.S0 + i * v;
    float* dst = s.A + i * lda;
    const float si = s.isd[i];
    for (int k = lane; k <= i; k += 32)
      dst[k] = (i == k) ? 1.f + jitter : src[k] * si * s.isd[k];
  }
  float ld, quad;
  gst_chol_fwd_block(s.A, v, lda, s.rp, s.u, s.racc, s.dinv, ld, quad);
  float ll = 0.f;
  if (tid == 0) {
    ll = base + 0.5f * (quad - (ld + sum_logd) - sum_lph);
    if (!isfinite(ll)) ll = -INFINITY;
  }
  return ll;
}

template <int VW>
__global__ void __launch_bounds__(256)
hyper_mh_block_kernel(const float* __restrict__ x,
                      const float* __restrict__ S0,
                      const float* __restrict__ dS0,
                      const float* __restrict__ rt,
                      const float* __restrict__ base,
                      const float* __restrict__ dx,
                      const float* __restrict__ logu,
                      const float* __restrict__ K,
                      const float* __restrict__ sel,
                      const float* __restrict__ specs, GstHypIdx hi,
                      float* __restrict__ xo, float* __restrict__ acc, int Cg,
                      int v, int lda, int p, int S, float jitter) {
  extern __shared__ float sm[];
  const size_t g = (size_t)blockIdx.x / Cg;
  K += g * (1 + hi.n) * v;
  sel += g * v;
  specs += g * 3 * p;
  HyperSmem s;
  s.S0 = sm;                     // v * v (lower triangle used)
  s.A = s.S0 + v * v;            // v * lda
  s.dS0 = s.A + v * lda;
  s.rt = s.dS0 + v;
  s.K = s.rt + v;                // (1 + nk) * v
  s.sel = s.K + (1 + hi.n) * v;
  s.isd = s.sel + v;
  s.rp = s.isd + v;
  s.u = s.rp + v;
  s.racc = s.u + v;
  s.dinv = s.racc + v;
  s.sx = s.dinv + v;             // p
  s.sq = s.sx + p;               // p
  s.sp = s.sq + p;               // 3 * p
  __shared__ float red[32];
  __shared__ int accept;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const size_t c = blockIdx.x;
  const float* S0c = S0 + c * v * v;
  for (int i = warp; i < v; i += nw) {
    const float* src = S0c + i * v;
    float* dst = s.S0 + i * v;
    if (VW == 4) {
      for (int k = 4 * lane; k <= i; k += 128)
        *reinterpret_cast<float4*>(dst + k) =
            *reinterpret_cast<const float4*>(src + k);
    } else {
      for (int k = lane; k <= i; k += 32) dst[k] = src[k];
    }
  }
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
  float ll0 = hyper_ll_block(s.sx, s, hi, v, lda, bc, jitter, red);
  float lp0 = tid == 0 ? gst_lnprior_sum(s.sx, s.sp, p) : 0.f;
  float nacc = 0.f;
  for (int j = 0; j < S; ++j) {
    for (int k = tid; k < p; k += nt) s.sq[k] = s.sx[k] + dx[(c * S + j) * p + k];
    __syncthreads();
    const float ll1 = hyper_ll_block(s.sq, s, hi, v, lda, bc, jitter, red);
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

#define GST_HYPER_ARGS                                                        \
  x, S0, dS0, rt, base, dx, logu, K, sel, specs, hi, xo, acc

template <int NR, int VW>
cudaError_t launch_warp(const float* x, const float* S0, const float* dS0,
                        const float* rt, const float* base, const float* dx,
                        const float* logu, const float* K, const float* sel,
                        const float* specs, const GstHypIdx& hi, float* xo,
                        float* acc, int C, int Cg, int v, int p, int S,
                        float jitter, int per_block, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)per_block *
                      (hyper_const_floats(v, p, hi.n) + hyper_warp_floats(v, p));
  cudaError_t e = gst_smem_optin(hyper_mh_warp_kernel<NR, VW>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (C + per_block - 1) / per_block;
  hyper_mh_warp_kernel<NR, VW><<<blocks, 32 * per_block, smem, stream>>>(
      GST_HYPER_ARGS, C, Cg, v, p, S, jitter);
  return cudaGetLastError();
}

template <int VW>
cudaError_t launch_block(const float* x, const float* S0, const float* dS0,
                         const float* rt, const float* base, const float* dx,
                         const float* logu, const float* K, const float* sel,
                         const float* specs, const GstHypIdx& hi, float* xo,
                         float* acc, int C, int Cg, int v, int p, int S,
                         float jitter, cudaStream_t stream) {
  const int lda = v | 1;
  const size_t smem = sizeof(float) * ((size_t)v * v + (size_t)v * lda +
                                       (size_t)(10 + hi.n) * v + 5 * p);
  cudaError_t e = gst_smem_optin(hyper_mh_block_kernel<VW>, smem);
  if (e != cudaSuccess) return e;
  hyper_mh_block_kernel<VW><<<C, 256, smem, stream>>>(GST_HYPER_ARGS, Cg, v,
                                                      lda, p, S, jitter);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// hyp_host: nk ints in host memory, the x-indices the K rows multiply.
// C chains in groups of Cg (C a multiple of Cg): K (C / Cg, 1 + nk, v),
// sel (C / Cg, v), specs (C / Cg, 3, p).
// per_block > 0: the warp form with that many chains (warps) per block,
// 1 <= per_block <= 8, v <= 64. per_block == 0: the block form, one
// 256-thread block per chain, v <= 160.
int gst_hyper_mh(const float* x, const float* S0, const float* dS0,
                 const float* rt, const float* base, const float* dx,
                 const float* logu, const float* K, const float* sel,
                 const float* specs, const int* hyp_host, int nk, float* xo,
                 float* acc, int C, int Cg, int v, int p, int S, float jitter,
                 int per_block, void* stream) {
  if (nk > GST_HYPER_MAXK || v < 1 || per_block < 0 || per_block > 8 ||
      Cg < 1 || C % Cg)
    return (int)cudaErrorInvalidValue;
  GstHypIdx hi;
  hi.n = nk;
  for (int k = 0; k < nk; ++k) hi.idx[k] = hyp_host[k];
  cudaStream_t st = (cudaStream_t)stream;
  if (per_block > 0) {
    if (v > GST_WARP_MAX_M) return (int)cudaErrorInvalidValue;
    const bool vec = ((v * v) & 3) == 0 && gst_aligned16(S0);
#define GST_HYPER_WARP(NR, VW)                                                \
  launch_warp<NR, VW>(GST_HYPER_ARGS, C, Cg, v, p, S, jitter, per_block, st)
    cudaError_t e;
    if (v < 32)
      e = vec ? GST_HYPER_WARP(1, 4) : GST_HYPER_WARP(1, 1);
    else if (v < 64)
      e = vec ? GST_HYPER_WARP(2, 4) : GST_HYPER_WARP(2, 1);
    else
      e = vec ? GST_HYPER_WARP(3, 4) : GST_HYPER_WARP(3, 1);
#undef GST_HYPER_WARP
    return (int)e;
  }
  if (v > GST_BLOCK_MAX_M) return (int)cudaErrorInvalidValue;
  const bool vec = (v & 3) == 0 && gst_aligned16(S0);
  return (int)(vec ? launch_block<4>(GST_HYPER_ARGS, C, Cg, v, p, S, jitter,
                                     st)
                   : launch_block<1>(GST_HYPER_ARGS, C, Cg, v, p, S, jitter,
                                     st));
}

}  // extern "C"
