// Per-chain Gram products of a shared basis: TNT = T^T diag(w) T and
// d = T^T (w y), w = 1/nvec, for every chain in one call.
//
// Replaces gibbs_student_t_tpu/ops/pallas_tnt.py::_tnt_kernel (entry
// tnt_batched_pallas), the TOA-blocked reduction of the 1e5-TOA stress
// path. The likelihood constant stays outside, in PyTorch (as outside the
// TPU kernel).
//
// What bounds it on an H100: operations. At the stress shape (64 chains,
// 102,400 TOAs, m = 74) it reads T once (30 MB) and w (26 MB) and does
// C n (m (m + 1) / 2 + m) multiply-adds, 3.7e10 flops: 0.56 ms at the
// 67 TFLOP/s FP32 rate against 0.02 ms for the bytes.
//
// The design keeps the TPU kernel's idea: a tile of TOAs of the shared
// basis is staged in shared memory once and reused by every chain of a
// chain tile, and the weighted basis never exists in device memory. d rides
// along as one more column: column m of the staged tile is y, so row m of
// the (m + 1) x (m + 1) weighted Gram is d. A block owns one 16 x 16 tile
// of the lower triangle of that Gram (tiles above the diagonal are never
// computed) for 16 chains; each thread accumulates a 2 x 2 output patch for
// 4 chains in registers, forming each basis product once and applying the 4
// chains' weights to it (FP32 FMA). The TOA axis is split over blocks
// (blockIdx.z) so that a few hundred blocks fill the 132 SMs at 64 chains;
// each split writes its partial sums, and a second kernel adds the splits
// in a fixed order (the result does not depend on scheduling), mirrors the
// lower triangle into the full TNT and peels off d.
#include <algorithm>

#include "gst_common.cuh"

#define TNT_BT 64       // TOAs per staged tile
#define TNT_CT 16       // chains per block
#define TNT_OT 16       // edge of an output tile
#define TNT_THREADS 256 // 64 patch positions x 4 chain slots

namespace {

__device__ __forceinline__ void tnt_fma4(float (&a)[4], float w, float p00,
                                         float p01, float p10, float p11) {
  a[0] = fmaf(w, p00, a[0]);
  a[1] = fmaf(w, p01, a[1]);
  a[2] = fmaf(w, p10, a[2]);
  a[3] = fmaf(w, p11, a[3]);
}

// part[ks][c] (MP x MP, lower tiles only) = the split ks's weighted Gram of
// [T | y] for chain c.
__global__ void __launch_bounds__(TNT_THREADS)
tnt_partial_kernel(const float* __restrict__ T, const float* __restrict__ y,
                   const float* __restrict__ w, float* __restrict__ part,
                   int C, int n, int m, int MP, int tiles_per_split) {
  extern __shared__ float4 sm4[];
  float* ts = reinterpret_cast<float*>(sm4);  // TNT_BT x MP: [T | y | 0]
  float* ws = ts + TNT_BT * MP;               // TNT_BT x TNT_CT weights
  int pr = blockIdx.x, bi = 0;                // lower tile pair (bi >= bj)
  while (pr > bi) pr -= ++bi;
  const int bj = pr;
  const int c0 = blockIdx.y * TNT_CT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slot = tid >> 6, pos = tid & 63;
  const int i0 = bi * TNT_OT + 2 * (pos >> 3);
  const int j0 = bj * TNT_OT + 2 * (pos & 7);
  float acc[4][4] = {};  // [chain of the slot][patch entry]
  const int ntile = (n + TNT_BT - 1) / TNT_BT;
  const int tb = blockIdx.z * tiles_per_split;
  const int te = min(ntile, tb + tiles_per_split);
  for (int tile = tb; tile < te; ++tile) {
    const int t0 = tile * TNT_BT;
    for (int r = warp; r < TNT_BT; r += TNT_THREADS / 32) {
      const int t = t0 + r;
      for (int col = lane; col < MP; col += 32) {
        float v = 0.f;
        if (t < n) v = col < m ? T[(size_t)t * m + col] : (col == m ? y[t] : 0.f);
        ts[r * MP + col] = v;
      }
    }
    for (int k = tid; k < TNT_BT * TNT_CT; k += TNT_THREADS) {
      const int r = k / TNT_CT, cl = k % TNT_CT;
      const int c = c0 + cl, t = t0 + r;
      ws[k] = (c < C && t < n) ? w[(size_t)c * n + t] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < TNT_BT; ++r) {
      const float2 a = *reinterpret_cast<const float2*>(ts + r * MP + i0);
      const float2 b = *reinterpret_cast<const float2*>(ts + r * MP + j0);
      const float4 wv =
          *reinterpret_cast<const float4*>(ws + r * TNT_CT + 4 * slot);
      const float p00 = a.x * b.x, p01 = a.x * b.y;
      const float p10 = a.y * b.x, p11 = a.y * b.y;
      tnt_fma4(acc[0], wv.x, p00, p01, p10, p11);
      tnt_fma4(acc[1], wv.y, p00, p01, p10, p11);
      tnt_fma4(acc[2], wv.z, p00, p01, p10, p11);
      tnt_fma4(acc[3], wv.w, p00, p01, p10, p11);
    }
    __syncthreads();
  }
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + 4 * slot + q;
    if (c >= C) continue;
    float* out = part + ((size_t)blockIdx.z * C + c) * MP * MP;
    out[i0 * MP + j0] = acc[q][0];
    out[i0 * MP + j0 + 1] = acc[q][1];
    out[(i0 + 1) * MP + j0] = acc[q][2];
    out[(i0 + 1) * MP + j0 + 1] = acc[q][3];
  }
}

// TNT[c] (m x m, both triangles) and d[c] from the splits' partial sums.
__global__ void tnt_finish_kernel(const float* __restrict__ part,
                                  float* __restrict__ tnt,
                                  float* __restrict__ d, int C, int m, int MP,
                                  int splits) {
  const size_t per = (size_t)m * m + m;
  const size_t total = per * C;
  const size_t plane = (size_t)C * MP * MP;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t c = idx / per;
    const int r = (int)(idx % per);
    int a, b;
    if (r < m * m) {
      a = max(r / m, r % m);
      b = min(r / m, r % m);
    } else {
      a = m;
      b = r - m * m;
    }
    const float* src = part + c * MP * MP + (size_t)a * MP + b;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += src[k * plane];
    if (r < m * m)
      tnt[c * m * m + r] = s;
    else
      d[c * m + b] = s;
  }
}

int tnt_mp(int m) { return (m + 1 + TNT_OT - 1) / TNT_OT * TNT_OT; }

// TOA splits: enough blocks for ~4 per SM, each split at least one tile.
int tnt_splits(int C, int n, int m) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      sms = 132;
  }
  const int nt = tnt_mp(m) / TNT_OT;
  const int blocks = nt * (nt + 1) / 2 * ((C + TNT_CT - 1) / TNT_CT);
  const int ntile = (n + TNT_BT - 1) / TNT_BT;
  const int want = (4 * sms + blocks - 1) / blocks;
  return std::max(1, std::min(ntile, want));
}

}  // namespace

extern "C" {

// Floats of device workspace gst_tnt_batched needs at this shape.
size_t gst_tnt_workspace(int C, int n, int m) {
  const size_t mp = tnt_mp(m);
  return (size_t)tnt_splits(C, n, m) * C * mp * mp;
}

// T (n, m) and y (n) shared, w (C, n) = 1/nvec; writes tnt (C, m, m) and
// d (C, m). `work` holds gst_tnt_workspace(C, n, m) floats.
int gst_tnt_batched(const float* T, const float* y, const float* w,
                    float* work, float* tnt, float* d, int C, int n, int m,
                    void* stream) {
  const int MP = tnt_mp(m), nt = MP / TNT_OT;
  const int splits = tnt_splits(C, n, m);
  const int ntile = (n + TNT_BT - 1) / TNT_BT;
  const int per = (ntile + splits - 1) / splits;
  const size_t smem = sizeof(float) * (size_t)TNT_BT * (MP + TNT_CT);
  cudaError_t e = gst_smem_optin(tnt_partial_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(nt * (nt + 1) / 2, (C + TNT_CT - 1) / TNT_CT, splits);
  tnt_partial_kernel<<<grid, TNT_THREADS, smem, (cudaStream_t)stream>>>(
      T, y, w, work, C, n, m, MP, per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = ((size_t)m * m + m) * C;
  const int fblocks = (int)std::min<size_t>((total + 255) / 256, 4096);
  tnt_finish_kernel<<<fblocks, 256, 0, (cudaStream_t)stream>>>(work, tnt, d, C,
                                                              m, MP, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
