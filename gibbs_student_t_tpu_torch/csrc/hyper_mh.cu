// The whole hyper-parameter Metropolis-Hastings block in one launch, in
// float32 (entry gst_hyper_mh) and float64 (the sampler's dtype=float64:
// gst_hyper_mh_f64, the same kernels instantiated on T = double).
//
// Replaces gibbs_student_t_tpu/ops/pallas_hyper.py::_hyper_kernel (entry
// hyper_mh_fused), whose JAX float64 path runs the 10-step loop through
// XLA instead. Per chain, on the sweep's Schur block S0 (v x v), for
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
// and prior table beside its own buffers ((1 + nk) v + v + 3p elements,
// under 1 KB at v = 60 in float32), so the kernel has no block barrier at all.
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
//
// Float64 (T = double), what changes with 8-byte elements:
// - shared memory: a chain of the warp form takes 33 KB at v = 60, so a
//   block holds at most 6 within 227 KB and 1,024 chains take two waves
//   over the card (ops/hyper_mh.py launch_form caps the count; the
//   launch refuses more); the block form's two v x v buffers bound v at
//   112 (MAX_HYPER_V_F64, for up to 16 hyper indices and 64 parameters),
//   above which the sampler takes the closure path through the float64
//   chol_fused;
// - registers: a lane's rows of the recurrence take twice the registers;
// - rsqrt, exp and log of a double are not those of the CPU's libm, so
//   the kernel and the plain version part by ulps.
// What bounds it: operations, on the FP64 pipe at half the FP32 rate.
#include "gst_common.cuh"

#define GST_HYPER_MAXK 16

struct GstHypIdx {
  int n;
  int idx[GST_HYPER_MAXK];
};

namespace {

// ---- v <= 64: a warp per chain -------------------------------------------

// Elements of shared memory one chain of the warp form takes: S0 packed, the
// factor packed with the right-hand-side row, dS0, rt, isd (v + 1: the
// right-hand-side row's slot is never read), x and q.
__host__ __device__ inline int hyper_warp_floats(int v, int p) {
  return (gst_tri(v) + gst_warp_floats(v) + 3 * v + 1 + 2 * p + 3) & ~3;
}

template <typename T>
struct HyperWarp {
  const T *K, *sel, *sp;         // the chain's group's constants
  T *S0p, *Lp, *dS0, *rt, *isd, *sx, *sq;
};

// Elements of shared memory a warp's copy of its group's constants takes: K,
// sel and the prior table, rounded to keep the next buffer 16-byte aligned.
__host__ __device__ inline int hyper_const_floats(int v, int p, int nk) {
  return ((2 + nk) * v + 3 * p + 3) & ~3;
}

// Entry (i, j) of a proposal's equilibrated matrix, and its right-hand side
// in row v. Branchless, and every load lands inside the chain's shared
// memory for any 0 <= i, j <= v (the recurrence also asks for entries it
// then drops): S0p runs on into the factor, rt into isd, isd has v + 1
// slots.
template <typename T>
struct HyperInit {
  const T *S0p, *isd, *rt;
  T diag;
  int v;
  __device__ __forceinline__ T operator()(int i, int base, int j) const {
    const T sj = isd[j];
    const T a = S0p[base + j] * isd[i] * sj;
    const T rj = rt[j] * sj;
    return i == v ? rj : (i == j ? diag : a);
  }
};

// ll of proposal q, the same bits on every lane.
template <int NR, typename T>
__device__ __forceinline__ T hyper_ll_warp(const T* q, const HyperWarp<T>& w,
                                           const GstHypIdx& hi, int v, T base,
                                           T jitter) {
  const int lane = threadIdx.x & 31;
  T plph = T(0), plogd = T(0);
  for (int c = lane; c < v; c += 32) {
    T lph = w.K[c];
    for (int k = 0; k < hi.n; ++k) lph = lph + w.K[(1 + k) * v + c] * q[hi.idx[k]];
    const T phiinv = w.sel[c] * gst_exp(-lph);
    const T d = w.dS0[c] + phiinv;
    w.isd[c] = gst_rsqrt(d);
    plph += w.sel[c] * lph;
    plogd += gst_log(d);
  }
  const T sum_lph = gst_warp_sum(plph);
  const T sum_logd = gst_warp_sum(plogd);
  __syncwarp();
  T ld, quad;
  gst_chol_fwd_warp<NR>(w.Lp, v,
                        HyperInit<T>{w.S0p, w.isd, w.rt, T(1) + jitter, v},
                        ld, quad);
  T ll = base + T(0.5) * (quad - (ld + sum_logd) - sum_lph);
  if (!isfinite(ll)) ll = -INFINITY;
  return ll;
}

template <int NR, int VW, typename T>
__global__ void __launch_bounds__(256)
hyper_mh_warp_kernel(const T* __restrict__ x, const T* __restrict__ S0,
                     const T* __restrict__ dS0, const T* __restrict__ rt,
                     const T* __restrict__ base, const T* __restrict__ dx,
                     const T* __restrict__ logu, const T* __restrict__ K,
                     const T* __restrict__ sel, const T* __restrict__ specs,
                     GstHypIdx hi, T* __restrict__ xo, T* __restrict__ acc,
                     int C, int Cg, int v, int p, int S, T jitter) {
  GST_DYN_SMEM(T, sm);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t c = (size_t)blockIdx.x * (nt >> 5) + warp;
  if (c >= (size_t)C) return;
  const size_t g = c / Cg;
  const int nconst = hyper_const_floats(v, p, hi.n);
  T* Ks = sm + warp * (nconst + hyper_warp_floats(v, p));  // (1 + nk) v
  T* sels = Ks + (1 + hi.n) * v;                           // v
  T* sps = sels + v;                                       // 3 * p
  for (int i = lane; i < (1 + hi.n) * v; i += 32)
    Ks[i] = K[g * (1 + hi.n) * v + i];
  for (int i = lane; i < v; i += 32) sels[i] = sel[g * v + i];
  for (int i = lane; i < 3 * p; i += 32) sps[i] = specs[g * 3 * p + i];
  HyperWarp<T> w;
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
  const T bc = base[c];
  T ll0 = hyper_ll_warp<NR>(w.sx, w, hi, v, bc, jitter);
  T lp0 = gst_lnprior_sum(w.sx, w.sp, p);
  T nacc = T(0);
  for (int j = 0; j < S; ++j) {
    for (int k = lane; k < p; k += 32)
      w.sq[k] = w.sx[k] + dx[(c * S + j) * p + k];
    __syncwarp();
    const T ll1 = hyper_ll_warp<NR>(w.sq, w, hi, v, bc, jitter);
    const T lp1 = gst_lnprior_sum(w.sq, w.sp, p);
    int am = (ll1 + lp1) - (ll0 + lp0) > logu[c * S + j];
    am = __shfl_sync(GST_FULL_MASK, am, 0);      // lane 0 decides
    if (am) {
      ll0 = ll1;
      lp0 = lp1;
      nacc += T(1);
      for (int k = lane; k < p; k += 32) w.sx[k] = w.sq[k];
    }
    __syncwarp();
  }
  for (int k = lane; k < p; k += 32) xo[c * p + k] = w.sx[k];
  if (lane == 0) acc[c] = nacc / (T)S;
}

// ---- 64 < v <= 160: a block per chain ----------------------------------------

template <typename T>
struct HyperSmem {
  T *S0, *A, *dS0, *rt, *K, *sel, *isd, *rp, *u, *racc, *dinv, *sx, *sq, *sp;
};

// (ll, on thread 0) of proposal q.
template <typename T>
__device__ T hyper_ll_block(const T* q, const HyperSmem<T>& s,
                            const GstHypIdx& hi, int v, int lda, T base,
                            T jitter, T* red) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  T plph = T(0), plogd = T(0);
  for (int c = tid; c < v; c += nt) {
    T lph = s.K[c];
    for (int k = 0; k < hi.n; ++k) lph = lph + s.K[(1 + k) * v + c] * q[hi.idx[k]];
    const T phiinv = s.sel[c] * gst_exp(-lph);
    const T d = s.dS0[c] + phiinv;
    const T isd = gst_rsqrt(d);
    s.isd[c] = isd;
    s.rp[c] = s.rt[c] * isd;
    plph += s.sel[c] * lph;
    plogd += gst_log(d);
  }
  const T sum_lph = gst_block_sum(plph, red);
  const T sum_logd = gst_block_sum(plogd, red);
  for (int i = warp; i < v; i += nw) {
    const T* src = s.S0 + i * v;
    T* dst = s.A + i * lda;
    const T si = s.isd[i];
    for (int k = lane; k <= i; k += 32)
      dst[k] = (i == k) ? T(1) + jitter : src[k] * si * s.isd[k];
  }
  T ld, quad;
  gst_chol_fwd_block(s.A, v, lda, s.rp, s.u, s.racc, s.dinv, ld, quad);
  T ll = T(0);
  if (tid == 0) {
    ll = base + T(0.5) * (quad - (ld + sum_logd) - sum_lph);
    if (!isfinite(ll)) ll = -INFINITY;
  }
  return ll;
}

template <int VW, typename T>
__global__ void __launch_bounds__(256)
hyper_mh_block_kernel(const T* __restrict__ x, const T* __restrict__ S0,
                      const T* __restrict__ dS0, const T* __restrict__ rt,
                      const T* __restrict__ base, const T* __restrict__ dx,
                      const T* __restrict__ logu, const T* __restrict__ K,
                      const T* __restrict__ sel, const T* __restrict__ specs,
                      GstHypIdx hi, T* __restrict__ xo, T* __restrict__ acc,
                      int Cg, int v, int lda, int p, int S, T jitter) {
  GST_DYN_SMEM(T, sm);
  const size_t g = (size_t)blockIdx.x / Cg;
  K += g * (1 + hi.n) * v;
  sel += g * v;
  specs += g * 3 * p;
  HyperSmem<T> s;
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
  __shared__ T red[32];
  __shared__ int accept;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const size_t c = blockIdx.x;
  const T* S0c = S0 + c * v * v;
  for (int i = warp; i < v; i += nw) {
    const T* src = S0c + i * v;
    T* dst = s.S0 + i * v;
    if constexpr (VW == 4) {       // four floats a 16-byte copy
      for (int k = 4 * lane; k <= i; k += 128)
        *reinterpret_cast<float4*>(dst + k) =
            *reinterpret_cast<const float4*>(src + k);
    } else if constexpr (VW == 2) {  // two doubles
      for (int k = 2 * lane; k <= i; k += 64)
        *reinterpret_cast<double2*>(dst + k) =
            *reinterpret_cast<const double2*>(src + k);
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
  const T bc = base[c];
  T ll0 = hyper_ll_block(s.sx, s, hi, v, lda, bc, jitter, red);
  T lp0 = tid == 0 ? gst_lnprior_sum(s.sx, s.sp, p) : T(0);
  T nacc = T(0);
  for (int j = 0; j < S; ++j) {
    for (int k = tid; k < p; k += nt) s.sq[k] = s.sx[k] + dx[(c * S + j) * p + k];
    __syncthreads();
    const T ll1 = hyper_ll_block(s.sq, s, hi, v, lda, bc, jitter, red);
    if (tid == 0) {
      const T lp1 = gst_lnprior_sum(s.sq, s.sp, p);
      const bool am = (ll1 + lp1) - (ll0 + lp0) > logu[c * S + j];
      accept = am;
      if (am) {
        ll0 = ll1;
        lp0 = lp1;
        nacc += T(1);
      }
    }
    __syncthreads();
    if (accept)
      for (int k = tid; k < p; k += nt) s.sx[k] = s.sq[k];
    __syncthreads();
  }
  for (int k = tid; k < p; k += nt) xo[c * p + k] = s.sx[k];
  if (tid == 0) acc[c] = nacc / (T)S;
}

#define GST_HYPER_ARGS                                                        \
  x, S0, dS0, rt, base, dx, logu, K, sel, specs, hi, xo, acc

template <int NR, int VW, typename T>
cudaError_t launch_warp(const T* x, const T* S0, const T* dS0, const T* rt,
                        const T* base, const T* dx, const T* logu, const T* K,
                        const T* sel, const T* specs, const GstHypIdx& hi,
                        T* xo, T* acc, int C, int Cg, int v, int p, int S,
                        T jitter, int per_block, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)per_block *
                      (hyper_const_floats(v, p, hi.n) + hyper_warp_floats(v, p));
  if (smem > GST_SMEM_OPTIN) return cudaErrorInvalidValue;
  cudaError_t e = gst_smem_optin(hyper_mh_warp_kernel<NR, VW, T>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (C + per_block - 1) / per_block;
  hyper_mh_warp_kernel<NR, VW, T><<<blocks, 32 * per_block, smem, stream>>>(
      GST_HYPER_ARGS, C, Cg, v, p, S, jitter);
  return cudaGetLastError();
}

template <int VW, typename T>
cudaError_t launch_block(const T* x, const T* S0, const T* dS0, const T* rt,
                         const T* base, const T* dx, const T* logu,
                         const T* K, const T* sel, const T* specs,
                         const GstHypIdx& hi, T* xo, T* acc, int C, int Cg,
                         int v, int p, int S, T jitter, cudaStream_t stream) {
  const int lda = v | 1;
  const size_t smem = sizeof(T) * ((size_t)v * v + (size_t)v * lda +
                                   (size_t)(10 + hi.n) * v + 5 * p);
  if (smem > GST_SMEM_OPTIN) return cudaErrorInvalidValue;
  cudaError_t e = gst_smem_optin(hyper_mh_block_kernel<VW, T>, smem);
  if (e != cudaSuccess) return e;
  hyper_mh_block_kernel<VW, T><<<C, 256, smem, stream>>>(GST_HYPER_ARGS, Cg,
                                                         v, lda, p, S,
                                                         jitter);
  return cudaGetLastError();
}

// hyp_host: nk ints in host memory, the x-indices the K rows multiply.
// C chains in groups of Cg (C a multiple of Cg): K (C / Cg, 1 + nk, v),
// sel (C / Cg, v), specs (C / Cg, 3, p).
// per_block > 0: the warp form with that many chains (warps) per block,
// 1 <= per_block <= 8, v <= 64, the chains within 227 KB of shared memory
// (6 doubles at v = 60). per_block == 0: the block form, one 256-thread
// block per chain, v <= 160 (float) or as far as 227 KB holds (double).
template <typename T>
int hyper_mh_entry(const T* x, const T* S0, const T* dS0, const T* rt,
                   const T* base, const T* dx, const T* logu, const T* K,
                   const T* sel, const T* specs, const int* hyp_host, int nk,
                   T* xo, T* acc, int C, int Cg, int v, int p, int S,
                   T jitter, int per_block, cudaStream_t st) {
  constexpr int V = GstVec<T>::N;
  if (nk > GST_HYPER_MAXK || v < 1 || per_block < 0 || per_block > 8 ||
      Cg < 1 || C % Cg)
    return (int)cudaErrorInvalidValue;
  GstHypIdx hi;
  hi.n = nk;
  for (int k = 0; k < nk; ++k) hi.idx[k] = hyp_host[k];
  if (per_block > 0) {
    if (v > GST_WARP_MAX_M) return (int)cudaErrorInvalidValue;
    const bool vec = ((v * v) % V) == 0 && gst_aligned16(S0);
#define GST_HYPER_WARP(NR, VW)                                                \
  launch_warp<NR, VW>(GST_HYPER_ARGS, C, Cg, v, p, S, jitter, per_block, st)
    cudaError_t e;
    if (v < 32)
      e = vec ? GST_HYPER_WARP(1, V) : GST_HYPER_WARP(1, 1);
    else if (v < 64)
      e = vec ? GST_HYPER_WARP(2, V) : GST_HYPER_WARP(2, 1);
    else
      e = vec ? GST_HYPER_WARP(3, V) : GST_HYPER_WARP(3, 1);
#undef GST_HYPER_WARP
    return (int)e;
  }
  if (v > GST_BLOCK_MAX_M) return (int)cudaErrorInvalidValue;
  const bool vec = (v % V) == 0 && gst_aligned16(S0);
  return (int)(vec ? launch_block<V>(GST_HYPER_ARGS, C, Cg, v, p, S, jitter,
                                     st)
                   : launch_block<1>(GST_HYPER_ARGS, C, Cg, v, p, S, jitter,
                                     st));
}

}  // namespace

extern "C" {

int gst_hyper_mh(const float* x, const float* S0, const float* dS0,
                 const float* rt, const float* base, const float* dx,
                 const float* logu, const float* K, const float* sel,
                 const float* specs, const int* hyp_host, int nk, float* xo,
                 float* acc, int C, int Cg, int v, int p, int S, float jitter,
                 int per_block, void* stream) {
  return hyper_mh_entry(x, S0, dS0, rt, base, dx, logu, K, sel, specs,
                        hyp_host, nk, xo, acc, C, Cg, v, p, S, jitter,
                        per_block, (cudaStream_t)stream);
}

int gst_hyper_mh_f64(const double* x, const double* S0, const double* dS0,
                     const double* rt, const double* base, const double* dx,
                     const double* logu, const double* K, const double* sel,
                     const double* specs, const int* hyp_host, int nk,
                     double* xo, double* acc, int C, int Cg, int v, int p,
                     int S, double jitter, int per_block, void* stream) {
  return hyper_mh_entry(x, S0, dS0, rt, base, dx, logu, K, sel, specs,
                        hyp_host, nk, xo, acc, C, Cg, v, p, S, jitter,
                        per_block, (cudaStream_t)stream);
}

}  // extern "C"
