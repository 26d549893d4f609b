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
// 67 TFLOP/s FP32 rate against 0.02 ms for the bytes. The TPU kernel runs
// the contraction on the matrix unit at full float32 (Precision.HIGHEST);
// the port keeps full float32, so this kernel stays on the FP32 pipes and
// is built as an SGEMM.
//
// The design: one product with chains as rows. With X = [T | y] (n x
// (m + 1)) and the pairs q = (i_q, j_q), i_q >= j_q, of the lower triangle
// of X's (m + 1) x (m + 1) Gram enumerated row by row (q = i (i + 1) / 2 +
// j; the table comes from ops/tnt.py pair_index, padded to whole pair
// tiles with the (m, m) slot),
//
//     G[c, q] = sum_t w[c, t] X[t, i_q] X[t, j_q],
//
// a product of W (C x n) with P (n x Q): chains are the M dimension, pairs
// the N dimension, TOAs the K dimension. Row m of the Gram is d; the (m, m)
// pair (y w y) and the padding slots are dropped. Only wanted pairs are
// computed: the waste is Q rounded up to the 128-pair tile (3 % at m = 74).
//
// - A block owns 64 chains x 128 pairs; each of its 128 threads keeps an
//   8 x 8 patch (chains 4ty..4ty+3 and 32+4ty..; pairs 4tx..4tx+3 and
//   64+4tx..) in 64 registers. Per TOA it reads its 8 weights and 8
//   products as four 16-byte shared-memory loads for 64 FMAs, so the FP32
//   pipe, not shared memory, sets the pace. The split halves make a
//   quarter-warp's 16-byte loads fall on distinct banks.
// - P is never stored in device memory. A block stages a tile of BK TOAs
//   of X (the tile of T is one contiguous span: BK rows of m floats start
//   on a 16-byte boundary whatever m is, because BK is a multiple of 4; y
//   is a second span) and builds its BK x 128 tile of P in shared memory,
//   one multiply per element shared by all 64 chains.
// - W is laid out [TOA][chain] for the micro-kernel. A chain's BK weights
//   are contiguous in device memory, so each thread loads four chains at
//   one TOA into registers (coalesced: a warp's lanes read consecutive
//   TOAs) and stores them transposed as one 16-byte store; the row stride
//   of 68 floats (4 mod 32) keeps those stores conflict-free.
// - Staging is asynchronous and every shared buffer is doubled, so one
//   barrier per tile separates the phases: in phase k the block multiplies
//   tile k, builds tile k + 1's products and stores its weights, while
//   tile k + 2's X is in flight by cp.async (16 bytes, .cg, zero-filled
//   past the last TOA) and its W in registers. On an H100 this form took
//   1.09 ms at the stress shape against 1.11 for two barriers and single
//   buffers; 4 blocks per SM instead of 3 (128 registers: spills), 16-TOA
//   tiles, 8 x 16 patches over 256-pair tiles, and W copied transposed by
//   4-byte cp.async all measured slower (PERF.md, the Gram kernel).
// - The TOA axis is split over blockIdx.z so that the grid fills the card
//   in one wave (blocks per SM from the occupancy calculator); each split
//   writes its (C, Qpad) partial sums and a second kernel adds the splits
//   in a fixed order, so the result does not depend on scheduling. It
//   unpacks pair q to TNT[c, i, j] and TNT[c, j, i] (the same float, so TNT
//   is exactly symmetric) or to d[c, j] for i = m.
//
// The lanes form (gst_tnt_lanes) replaces gibbs_student_t_tpu/ops/
// pallas_tnt.py::tnt_lanes_pallas, the serving slot pool's reduction: one
// basis per group of 16 lanes, every group in ONE launch (the JAX entry
// launches once per group). A block then owns the 16 chains of one group
// (BM = 16): its group index picks the basis T + g nT m and y + g nT, and
// its 128 threads keep 2 x 8 patches (chains 2ty, 2ty + 1; the same pairs
// as above), so a block never spans two bases. At the pool's shape (1,024
// lanes, 130 TOAs, m = 74) it does 0.76 GFLOP, 0.011 ms at the FP32 rate
// against 0.008 ms for its bytes: bound by operations too. Each group's
// basis is stored padded to nT rows (a multiple of 4, so every group's span
// starts on a 16-byte boundary); only the first n rows are read.
#include <algorithm>

#include "gst_common.cuh"

#define TNT_BM 64        // chains per block (the M tile), one basis
#define TNT_BM_LANES 16  // chains per block of the lanes form: one group
#define TNT_BN 128       // pairs per block (the N tile); ops/tnt.py PAIR_TILE
#define TNT_THREADS 128  // 8 chain groups x 16 pair groups
static_assert(TNT_THREADS == TNT_BN, "a thread builds one column of P");

// Row stride, in floats, of the [TOA][chain] W tile of BM chains: 68 for
// 64 chains (4 mod 32, conflict-free 16-byte stores), 20 for 16 (a
// quarter-warp's eight stores cover the 32 banks once).
template <int BM>
__host__ __device__ constexpr int tnt_ws() {
  return BM + 4;
}

namespace {

__device__ __forceinline__ void tnt_cp16(float* dst, const float* src,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tnt_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void tnt_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying the X tile of TOAs t0 .. t0 + BK into xs: T's rows as one
// span of BK m floats, then BK floats of y; what lies past TOA n arrives as
// zeros.
template <int BK>
__device__ __forceinline__ void tnt_stage_x(float* xs,
                                            const float* __restrict__ T,
                                            const float* __restrict__ y,
                                            int t0, int n, int m) {
  const int rows = min(BK, n - t0);
  const int tq = BK * m / 4, tvalid = rows * m;
  const float* src = T + (size_t)t0 * m;
  for (int q = threadIdx.x; q < tq + BK / 4; q += TNT_THREADS) {
    if (q < tq) {
      const int left = min(max(tvalid - 4 * q, 0), 4);
      tnt_cp16(xs + 4 * q, left ? src + 4 * q : T, 4 * left);
    } else {
      const int r = 4 * (q - tq);
      const int left = min(max(rows - r, 0), 4);
      tnt_cp16(xs + BK * m + r, left ? y + t0 + r : y, 4 * left);
    }
  }
}

// Slot s = threadIdx.x + 128 r of the W tile is (TOA s % BK, chains
// 4 (s / BK) .. + 3): BK BM / 512 slots per thread, 4 floats each.
template <int BK, int BM>
__device__ __forceinline__ void tnt_load_w(float (&wr)[BK * BM / 512][4],
                                           const float* __restrict__ w,
                                           int c0, int C, int t0, int n) {
#pragma unroll
  for (int r = 0; r < BK * BM / 512; ++r) {
    const int s = threadIdx.x + TNT_THREADS * r;
    const int t = t0 + s % BK, cq = c0 + 4 * (s / BK);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wr[r][e] = (cq + e < C && t < n) ? __ldg(w + (size_t)(cq + e) * n + t)
                                       : 0.f;
  }
}

template <int BK, int BM>
__device__ __forceinline__ void tnt_store_w(
    float* wt, const float (&wr)[BK * BM / 512][4]) {
#pragma unroll
  for (int r = 0; r < BK * BM / 512; ++r) {
    const int s = threadIdx.x + TNT_THREADS * r;
    *reinterpret_cast<float4*>(wt + (s % BK) * tnt_ws<BM>() + 4 * (s / BK)) =
        make_float4(wr[r][0], wr[r][1], wr[r][2], wr[r][3]);
  }
}

// Tile k's products into ps: thread tid builds column tid, P[k][tid] =
// X[k][i] X[k][j], reading X[k][c] at xs[o + k s] (a basis column: offset
// c, stride m; y: offset BK m, stride 1).
template <int BK>
__device__ __forceinline__ void tnt_build_p(float* ps, const float* xs,
                                            int oi, int si, int oj, int sj) {
#pragma unroll 8
  for (int k = 0; k < BK; ++k)
    ps[k * TNT_BN + threadIdx.x] = xs[oi + k * si] * xs[oj + k * sj];
}

// The block-local chain of a thread's patch row i: for 64 chains, rows
// 4ty .. 4ty + 3 and 32 + 4ty .. + 3; for 16, rows 2ty and 2ty + 1.
template <int BM>
__device__ __forceinline__ int tnt_row(int i, int ty) {
  if (BM == TNT_BM) return i < 4 ? 4 * ty + i : 28 + 4 * ty + i;
  return 2 * ty + i;
}

// acc[i][j] += sum over the tile's TOAs of W[k][chain i] P[k][pair j].
template <int BK, int BM>
__device__ __forceinline__ void tnt_mma(float (&acc)[BM / 8][8],
                                        const float* wt, const float* ps,
                                        int tx, int ty) {
  constexpr int WS = tnt_ws<BM>();
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    float a[BM / 8];
    if constexpr (BM == TNT_BM) {
      const float4 a0 = *reinterpret_cast<const float4*>(wt + k * WS + 4 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(wt + k * WS + 32 + 4 * ty);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
    } else {
      const float2 a0 = *reinterpret_cast<const float2*>(wt + k * WS + 2 * ty);
      a[0] = a0.x, a[1] = a0.y;
    }
    const float4 b0 =
        *reinterpret_cast<const float4*>(ps + k * TNT_BN + 4 * tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(ps + k * TNT_BN + 64 + 4 * tx);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// part[z][c][q] = the split z's sum over its TOAs of w[c, t] X[t, i_q]
// X[t, j_q], for the block's BM chains and 128 pairs, in the phases above.
// In the lanes form (BM = 16) chains c0 .. c0 + 15 share the basis of group
// c0 / cg, which starts at T + g nT m and y + g nT; the single-basis form
// (BM = 64) reads T and y as they are.
template <int BK, int BM>
__global__ void __launch_bounds__(TNT_THREADS)
tnt_pairs_kernel(const float* __restrict__ T, const float* __restrict__ y,
                 const float* __restrict__ w, const int* __restrict__ pairs,
                 float* __restrict__ part, int C, int n, int m, int qpad,
                 int tiles_per_split, int cg, int nT) {
  static_assert(BK * BM % 512 == 0, "whole W slots per thread");
  constexpr int WS = tnt_ws<BM>();
  extern __shared__ float4 sm4[];
  const int xstage = BK * (m + 1);
  float* xs0 = reinterpret_cast<float*>(sm4);  // 2 x [T span | y]
  float* ps0 = xs0 + 2 * xstage;               // 2 x BK x TNT_BN products
  float* wt0 = ps0 + 2 * BK * TNT_BN;          // 2 x BK x WS weights
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * TNT_BN, c0 = blockIdx.y * BM;
  if constexpr (BM != TNT_BM) {
    // the lanes form: the block's group picks its basis
    const size_t g = (size_t)(c0 / cg);
    T += g * nT * m;
    y += g * nT;
  }
  const int pi = pairs[q0 + tid], pj = pairs[qpad + q0 + tid];
  const int oi = pi < m ? pi : BK * m, si = pi < m ? m : 1;
  const int oj = pj < m ? pj : BK * m, sj = pj < m ? m : 1;
  const int ntile = (n + BK - 1) / BK;
  const int tb = blockIdx.z * tiles_per_split;
  const int te = min(ntile, tb + tiles_per_split);
  float acc[BM / 8][8] = {};
  float wr[BK * BM / 512][4];
  if (tb < te) {
    // tile tb built and stored; tile tb + 1's X arrived, its W in registers
    tnt_stage_x<BK>(xs0, T, y, tb * BK, n, m);
    tnt_cp_commit();
    tnt_load_w<BK, BM>(wr, w, c0, C, tb * BK, n);
    tnt_cp_wait<0>();
    __syncthreads();
    tnt_store_w<BK, BM>(wt0, wr);
    tnt_build_p<BK>(ps0, xs0, oi, si, oj, sj);
    if (tb + 1 < te) {
      tnt_stage_x<BK>(xs0 + xstage, T, y, (tb + 1) * BK, n, m);
      tnt_cp_commit();
      tnt_load_w<BK, BM>(wr, w, c0, C, (tb + 1) * BK, n);
    }
    tnt_cp_wait<0>();
    __syncthreads();
  }
  for (int tile = tb; tile < te; ++tile) {
    const int b = (tile - tb) & 1;
    if (tile + 1 < te) {
      // X stage b held tile k, built in the previous phase; the other
      // product and weight buffers held tile k - 1, multiplied there
      if (tile + 2 < te) {
        tnt_stage_x<BK>(xs0 + b * xstage, T, y, (tile + 2) * BK, n, m);
        tnt_cp_commit();
      }
      tnt_store_w<BK, BM>(wt0 + (b ^ 1) * BK * WS, wr);
      if (tile + 2 < te)
        tnt_load_w<BK, BM>(wr, w, c0, C, (tile + 2) * BK, n);
      tnt_build_p<BK>(ps0 + (b ^ 1) * BK * TNT_BN, xs0 + (b ^ 1) * xstage, oi,
                      si, oj, sj);
    }
    tnt_mma<BK, BM>(acc, wt0 + b * BK * WS, ps0 + b * BK * TNT_BN, tx, ty);
    tnt_cp_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < BM / 8; ++i) {
    const int c = c0 + tnt_row<BM>(i, ty);
    if (c >= C) continue;
    float* out = part + ((size_t)blockIdx.z * C + c) * qpad + q0;
    *reinterpret_cast<float4*>(out + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + 64 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// TNT[c] (m x m, both triangles) and d[c] from the splits' partial sums,
// added in split order; the (m, m) pair (q = Q - 1) and the padding are
// dropped.
__global__ void tnt_unpack_kernel(const float* __restrict__ part,
                                  const int* __restrict__ pairs,
                                  float* __restrict__ tnt,
                                  float* __restrict__ d, int C, int m,
                                  int qpad, int splits) {
  const int qreal = (m + 1) * (m + 2) / 2 - 1;
  const size_t total = (size_t)C * qreal;
  const size_t plane = (size_t)C * qpad;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t c = idx / qreal;
    const int q = (int)(idx % qreal);
    const float* src = part + c * qpad + q;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += src[k * plane];
    const int i = pairs[q], j = pairs[qpad + q];
    if (i < m) {
      tnt[(c * m + i) * m + j] = s;
      tnt[(c * m + j) * m + i] = s;
    } else {
      d[c * m + j] = s;
    }
  }
}

int tnt_qpad(int m) {
  const int q = (m + 1) * (m + 2) / 2;
  return (q + TNT_BN - 1) / TNT_BN * TNT_BN;
}

size_t tnt_smem(int bk, int bm, int m) {
  return sizeof(float) * (size_t)bk * 2 * ((m + 1) + TNT_BN + bm + 4);
}

// The TOA tile for BM chains a block: 32 where its shared memory fits (for
// 64 chains, m up to 710 in 227 KB), else 8 (m up to 3,434); 0 when neither
// fits, or when only 8 does and the block has 16 chains (the lanes form's
// W tile then leaves threads without a slot).
int tnt_bk(int bm, int m) {
  static int optin = 0;
  if (!optin) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      optin = 48 * 1024;
  }
  if (tnt_smem(32, bm, m) <= (size_t)optin) return 32;
  if (bm == TNT_BM && tnt_smem(8, bm, m) <= (size_t)optin) return 8;
  return 0;
}

template <int BK, int BM>
cudaError_t tnt_occupancy(int m, int* per_sm) {
  const size_t smem = tnt_smem(BK, BM, m);
  cudaError_t e = gst_smem_optin(tnt_pairs_kernel<BK, BM>, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, tnt_pairs_kernel<BK, BM>, TNT_THREADS, smem);
  return e;
}

// Opt the kernel of tile bk and BM chains a block into its shared memory
// and return the number of TOA splits that fills the card in one wave (at
// least 1, at most one tile per split).
template <int BM>
cudaError_t tnt_prepare(int bk, int C, int n, int m, int* splits) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      sms = 132;
  }
  int per_sm = 0;
  cudaError_t e = bk == 32 ? tnt_occupancy<32, BM>(m, &per_sm)
                           : tnt_occupancy<8, TNT_BM>(m, &per_sm);
  if (e != cudaSuccess) return e;
  const int tiles = tnt_qpad(m) / TNT_BN * ((C + BM - 1) / BM);
  const int ntile = (n + bk - 1) / bk;
  *splits = std::max(1, std::min(ntile, std::max(1, per_sm) * sms / tiles));
  return cudaSuccess;
}

// One call: the pairs kernel over the splits, then the unpack kernel. cg is
// the chains per basis (C for one basis) and nT the rows of each basis.
template <int BM>
int tnt_run(const float* T, const float* y, const float* w, const int* pairs,
            int npairs, float* work, float* tnt, float* d, int C, int n,
            int nT, int cg, int m, void* stream) {
  const int bk = tnt_bk(BM, m), qpad = tnt_qpad(m);
  if (!bk || npairs != qpad || !gst_aligned16(T, y))
    return (int)cudaErrorInvalidValue;
  int splits = 0;
  cudaError_t e = tnt_prepare<BM>(bk, C, n, m, &splits);
  if (e != cudaSuccess) return (int)e;
  const int ntile = (n + bk - 1) / bk;
  const int per = (ntile + splits - 1) / splits;
  const dim3 grid(qpad / TNT_BN, (C + BM - 1) / BM, splits);
  const size_t smem = tnt_smem(bk, BM, m);
  cudaStream_t s = (cudaStream_t)stream;
  if (bk == 32)
    tnt_pairs_kernel<32, BM><<<grid, TNT_THREADS, smem, s>>>(
        T, y, w, pairs, work, C, n, m, qpad, per, cg, nT);
  else
    tnt_pairs_kernel<8, TNT_BM><<<grid, TNT_THREADS, smem, s>>>(
        T, y, w, pairs, work, C, n, m, qpad, per, cg, nT);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)C * ((m + 1) * (m + 2) / 2 - 1);
  const int fblocks = (int)std::min<size_t>((total + 255) / 256, 4096);
  if (fblocks)
    tnt_unpack_kernel<<<fblocks, 256, 0, s>>>(work, pairs, tnt, d, C, m, qpad,
                                              splits);
  return (int)cudaGetLastError();
}

template <int BM>
size_t tnt_workspace(int C, int n, int m) {
  const int bk = tnt_bk(BM, m);
  int splits = 0;
  if (!bk || tnt_prepare<BM>(bk, C, n, m, &splits) != cudaSuccess) return 0;
  return (size_t)splits * C * tnt_qpad(m);
}

}  // namespace

extern "C" {

// Floats of device workspace gst_tnt_batched needs at this shape (0 when
// the shape is out of the kernel's reach; gst_tnt_batched then fails).
size_t gst_tnt_workspace(int C, int n, int m) {
  return tnt_workspace<TNT_BM>(C, n, m);
}

// T (n, m), 16-byte aligned, and y (n), 16-byte aligned, shared; w (C, n)
// = 1/nvec; pairs (2, npairs) int32, ops/tnt.py pair_index(m). Writes
// tnt (C, m, m) and d (C, m). `work` holds gst_tnt_workspace(C, n, m)
// floats.
int gst_tnt_batched(const float* T, const float* y, const float* w,
                    const int* pairs, int npairs, float* work, float* tnt,
                    float* d, int C, int n, int m, void* stream) {
  return tnt_run<TNT_BM>(T, y, w, pairs, npairs, work, tnt, d, C, n, n, C,
                         m, stream);
}

// Floats of device workspace gst_tnt_lanes needs for B lanes (0 when the
// shape is out of the lanes kernel's reach; gst_tnt_lanes then fails).
size_t gst_tnt_lanes_workspace(int B, int n, int m) {
  return tnt_workspace<TNT_BM_LANES>(B, n, m);
}

// The lanes form: B lanes in groups of 16, group g with its own basis, T
// (B / 16, nT, m) and y (B / 16, nT), 16-byte aligned, nT a multiple of 4
// and at least n (rows past n are not read); w (B, n) = 1/nvec. Writes tnt
// (B, m, m) and d (B, m); `work` holds gst_tnt_lanes_workspace(B, n, m)
// floats.
int gst_tnt_lanes(const float* T, const float* y, const float* w,
                  const int* pairs, int npairs, float* work, float* tnt,
                  float* d, int B, int n, int nT, int m, void* stream) {
  if (B % TNT_BM_LANES || nT % 4 || nT < n)
    return (int)cudaErrorInvalidValue;
  return tnt_run<TNT_BM_LANES>(T, y, w, pairs, npairs, work, tnt, d, B, n,
                               nT, TNT_BM_LANES, m, stream);
}

}  // extern "C"
