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
// The lanes form (gst_tnt_lanes, tnt_lanes_kernel below) replaces
// gibbs_student_t_tpu/ops/pallas_tnt.py::tnt_lanes_pallas, the serving
// slot pool's reduction: one basis per group of 16 lanes, every group in
// ONE launch (the JAX entry launches once per group). At the pool's shape
// (1,024 lanes, 130 TOAs, m = 74) it does 0.76 GFLOP, 0.011 ms at the FP32
// rate, and writes 22.4 MB of TNT, 0.007 ms: bound by operations. It is a
// kernel of its own, not the product above at 16 chains a block, because
// at 130 TOAs that pipeline has nothing to hide (5 TOA tiles a block, each
// behind a wait and a barrier, the group's basis re-staged by each of its
// 23 pair tiles) and a 16-chain tile does a quarter of the 64-chain tile's
// work per shared load; its partial sums then went through device memory
// to a second kernel that wrote both triangles with a store strided by m.
// The lanes kernel:
//
// - The Gram of X = [T | y] is cut into 16 x 16 tiles (I0, J0), I0 >= J0,
//   of its lower triangle, rows and columns 0 .. 16 R - 1 with R =
//   ceil((m + 1) / 16) (the table comes from ops/tnt.py lanes_tiles(m)). A
//   block owns `per_block` tiles of one group (blockIdx.y; ops/tnt.py
//   lanes_form picks the count); each tile has 64 threads, and thread (a,
//   b) of a tile keeps the 2 x 2 pairs (I0 + 2a + {0, 1}, J0 + 2b + {0,
//   1}) for all 16 lanes of its group: 64 registers. Per TOA it reads its
//   two row and two column values (two 8-byte loads), forms its four
//   products once, reads the 16 lanes' weights as four broadcast 16-byte
//   loads and does 64 FMAs: each product serves every lane.
// - The block stages the group's X (row stride xs = 16 R floats, zeros past
//   column m) by 4-byte asynchronous copies, all in flight at once, and the
//   16 lanes' weights w = 1/nvec (formed here, a thread a TOA, [TOA][lane])
//   in shared memory once, when they fit (the pool's 130 x 80 + 130 x 16
//   floats, 49.9 KB); then the TOA loop has no barrier. Larger bases go by
//   chunks of kt TOAs, one barrier pair a chunk.
// - The sums go straight to their places, with no workspace: (i, j) with
//   i, j < m to TNT[c, i, j] and, off the diagonal tiles, the same float to
//   TNT[c, j, i], so TNT is exactly symmetric; neighbouring floats go as
//   one 8-byte store where m is even. A diagonal tile computes its upper
//   half too and writes every entry once: the thread of (j, i) forms X_j
//   X_i, the same float as X_i X_j, and sums it in the same order, so the
//   two are equal bit for bit. Row m is d. Pair (m, m), y w y, is dropped
//   with the padding: a TOA-serial sum of 2,000 terms misses the
//   constant's 1e-6 relative gate, so one more block of each group sums
//   log nvec and y w y per lane over 32 strided partial sums and a
//   shuffle tree, for const = -(sum log nvec + y w y) / 2.
// - Work: the tiles cover 16 R (R + 1) / 2 x 16 pairs where (m + 1)(m +
//   2) / 2 are wanted (1.35x at m = 74: the diagonal tiles' upper halves
//   and the padding). Every block is resident at once at the pool's
//   shape, so the blocks' staging, products and stores follow one another
//   on the card rather than overlapping.
#include <algorithm>

#include "gst_common.cuh"

#define TNT_BM 64        // chains per block (the M tile), one basis
#define TNT_BN 128       // pairs per block (the N tile); ops/tnt.py PAIR_TILE
#define TNT_THREADS 128  // 8 chain groups x 16 pair groups
static_assert(TNT_THREADS == TNT_BN, "a thread builds one column of P");
// Row stride, in floats, of the [TOA][chain] W tile: 4 mod 32, so the
// transposed 16-byte stores are conflict-free.
#define TNT_WS (TNT_BM + 4)

#define TNT_LANES 16     // lanes per group of the lanes form (ops/lanes.py)
#define TNT_LT 16        // rows and columns of a Gram tile of the lanes form
#define TNT_LT_THREADS 64  // threads per tile: 8 x 8, a 2 x 2 patch each
#define TNT_LANES_MAX_PER_BLOCK 4
// shared memory the lanes kernel stages at most: n TOAs whole up to here,
// chunks of TOAs past it (two blocks an SM)
#define TNT_LANES_SMEM (96 * 1024)

namespace {

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
      gst_cp16(xs + 4 * q, left ? src + 4 * q : T, 4 * left);
    } else {
      const int r = 4 * (q - tq);
      const int left = min(max(rows - r, 0), 4);
      gst_cp16(xs + BK * m + r, left ? y + t0 + r : y, 4 * left);
    }
  }
}

// Slot s = threadIdx.x + 128 r of the W tile is (TOA s % BK, chains
// 4 (s / BK) .. + 3): BK / 8 slots per thread, 4 floats each.
template <int BK>
__device__ __forceinline__ void tnt_load_w(float (&wr)[BK / 8][4],
                                           const float* __restrict__ w,
                                           int c0, int C, int t0, int n) {
#pragma unroll
  for (int r = 0; r < BK / 8; ++r) {
    const int s = threadIdx.x + TNT_THREADS * r;
    const int t = t0 + s % BK, cq = c0 + 4 * (s / BK);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wr[r][e] = (cq + e < C && t < n) ? __ldg(w + (size_t)(cq + e) * n + t)
                                       : 0.f;
  }
}

template <int BK>
__device__ __forceinline__ void tnt_store_w(float* wt,
                                            const float (&wr)[BK / 8][4]) {
#pragma unroll
  for (int r = 0; r < BK / 8; ++r) {
    const int s = threadIdx.x + TNT_THREADS * r;
    *reinterpret_cast<float4*>(wt + (s % BK) * TNT_WS + 4 * (s / BK)) =
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

// acc[i][j] += sum over the tile's TOAs of W[k][chain i] P[k][pair j]; a
// thread's chains are 4ty .. 4ty + 3 and 32 + 4ty .. + 3.
template <int BK>
__device__ __forceinline__ void tnt_mma(float (&acc)[8][8], const float* wt,
                                        const float* ps, int tx, int ty) {
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    const float4 a0 =
        *reinterpret_cast<const float4*>(wt + k * TNT_WS + 4 * ty);
    const float4 a1 =
        *reinterpret_cast<const float4*>(wt + k * TNT_WS + 32 + 4 * ty);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float4 b0 =
        *reinterpret_cast<const float4*>(ps + k * TNT_BN + 4 * tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(ps + k * TNT_BN + 64 + 4 * tx);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// part[z][c][q] = the split z's sum over its TOAs of w[c, t] X[t, i_q]
// X[t, j_q], for the block's 64 chains and 128 pairs, in the phases above.
template <int BK>
__global__ void __launch_bounds__(TNT_THREADS)
tnt_pairs_kernel(const float* __restrict__ T, const float* __restrict__ y,
                 const float* __restrict__ w, const int* __restrict__ pairs,
                 float* __restrict__ part, int C, int n, int m, int qpad,
                 int tiles_per_split) {
  extern __shared__ float4 sm4[];
  const int xstage = BK * (m + 1);
  float* xs0 = reinterpret_cast<float*>(sm4);  // 2 x [T span | y]
  float* ps0 = xs0 + 2 * xstage;               // 2 x BK x TNT_BN products
  float* wt0 = ps0 + 2 * BK * TNT_BN;          // 2 x BK x TNT_WS weights
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * TNT_BN, c0 = blockIdx.y * TNT_BM;
  const int pi = pairs[q0 + tid], pj = pairs[qpad + q0 + tid];
  const int oi = pi < m ? pi : BK * m, si = pi < m ? m : 1;
  const int oj = pj < m ? pj : BK * m, sj = pj < m ? m : 1;
  const int ntile = (n + BK - 1) / BK;
  const int tb = blockIdx.z * tiles_per_split;
  const int te = min(ntile, tb + tiles_per_split);
  float acc[8][8] = {};
  float wr[BK / 8][4];
  if (tb < te) {
    // tile tb built and stored; tile tb + 1's X arrived, its W in registers
    tnt_stage_x<BK>(xs0, T, y, tb * BK, n, m);
    gst_cp_commit();
    tnt_load_w<BK>(wr, w, c0, C, tb * BK, n);
    gst_cp_wait<0>();
    __syncthreads();
    tnt_store_w<BK>(wt0, wr);
    tnt_build_p<BK>(ps0, xs0, oi, si, oj, sj);
    if (tb + 1 < te) {
      tnt_stage_x<BK>(xs0 + xstage, T, y, (tb + 1) * BK, n, m);
      gst_cp_commit();
      tnt_load_w<BK>(wr, w, c0, C, (tb + 1) * BK, n);
    }
    gst_cp_wait<0>();
    __syncthreads();
  }
  for (int tile = tb; tile < te; ++tile) {
    const int b = (tile - tb) & 1;
    if (tile + 1 < te) {
      // X stage b held tile k, built in the previous phase; the other
      // product and weight buffers held tile k - 1, multiplied there
      if (tile + 2 < te) {
        tnt_stage_x<BK>(xs0 + b * xstage, T, y, (tile + 2) * BK, n, m);
        gst_cp_commit();
      }
      tnt_store_w<BK>(wt0 + (b ^ 1) * BK * TNT_WS, wr);
      if (tile + 2 < te) tnt_load_w<BK>(wr, w, c0, C, (tile + 2) * BK, n);
      tnt_build_p<BK>(ps0 + (b ^ 1) * BK * TNT_BN, xs0 + (b ^ 1) * xstage, oi,
                      si, oj, sj);
    }
    tnt_mma<BK>(acc, wt0 + b * BK * TNT_WS, ps0 + b * BK * TNT_BN, tx, ty);
    gst_cp_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + (i < 4 ? 4 * ty + i : 28 + 4 * ty + i);
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

size_t tnt_smem(int bk, int m) {
  return sizeof(float) * (size_t)bk * 2 * ((m + 1) + TNT_BN + TNT_WS);
}

int tnt_optin() {
  static int optin = 0;
  if (!optin) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      optin = 48 * 1024;
  }
  return optin;
}

// The TOA tile: 32 where its shared memory fits (m up to 710 in 227 KB),
// else 8 (m up to 3,434); 0 when neither fits.
int tnt_bk(int m) {
  const int optin = tnt_optin();
  if (tnt_smem(32, m) <= (size_t)optin) return 32;
  if (tnt_smem(8, m) <= (size_t)optin) return 8;
  return 0;
}

template <int BK>
cudaError_t tnt_occupancy(int m, int* per_sm) {
  const size_t smem = tnt_smem(BK, m);
  cudaError_t e = gst_smem_optin(tnt_pairs_kernel<BK>, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, tnt_pairs_kernel<BK>, TNT_THREADS, smem);
  return e;
}

// Opt the kernel of tile bk into its shared memory and return the number
// of TOA splits that fills the card in one wave (at least 1, at most one
// tile per split).
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
  cudaError_t e = bk == 32 ? tnt_occupancy<32>(m, &per_sm)
                           : tnt_occupancy<8>(m, &per_sm);
  if (e != cudaSuccess) return e;
  const int tiles = tnt_qpad(m) / TNT_BN * ((C + TNT_BM - 1) / TNT_BM);
  const int ntile = (n + bk - 1) / bk;
  *splits = std::max(1, std::min(ntile, std::max(1, per_sm) * sms / tiles));
  return cudaSuccess;
}

// v0, v1 to p[0], p[1] where ok0, ok1: one 8-byte store when both go and
// p is 8-byte aligned (`pair`: the row length is even).
__device__ __forceinline__ void tnt_store2(float* p, float v0, float v1,
                                           bool ok0, bool ok1, bool pair) {
  if (ok0 && ok1 && pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (ok0) p[0] = v0;
    if (ok1) p[1] = v1;
  }
}

// The lanes form. Thread (a, b) of tile k keeps acc[l][2 ii + jj] = sum over
// the TOAs of w[l][t] X[t][i0 + ii] X[t][j0 + jj] for the group's lanes l,
// with i0 = I0 + 2a, j0 = J0 + 2b (the table's tile k); X is staged with
// row stride xs (zeros past column m) and w = 1/nvec as [TOA][lane]. A
// block whose tile index runs past the table only stages and waits; the
// last block of each group (blockIdx.x = gridDim.x - 1) holds no tile and
// forms the group's constants. The group's basis starts at T + g sT (rows
// of m floats) and y + g sy; its lanes' nvec rows are 16 g .. 16 g + 15 of
// nvec (B, n).
__global__ void __launch_bounds__(TNT_LT_THREADS* TNT_LANES_MAX_PER_BLOCK)
tnt_lanes_kernel(const float* __restrict__ T, const float* __restrict__ y,
                 const float* __restrict__ nvec,
                 const int* __restrict__ tiles, int ntiles,
                 float* __restrict__ tnt, float* __restrict__ d,
                 float* __restrict__ cst, int n, int m, long long sT,
                 long long sy, int kt, int xs) {
  extern __shared__ float4 sm4[];
  float* Xs = reinterpret_cast<float*>(sm4);  // kt x xs
  float* Ws = Xs + (size_t)kt * xs;           // kt x 16
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
  const int g = blockIdx.y;
  const float* Tg = T + g * sT;
  const float* yg = y + g * sy;
  const float* nv = nvec + (size_t)g * TNT_LANES * n;
  if (blockIdx.x == gridDim.x - 1) {
    // const = -(sum log nvec + y^T N^-1 y) / 2, a warp a lane: each lane of
    // the warp sums a 32nd of the TOAs, then a shuffle tree, so a long basis
    // does not sum its n terms in one serial chain
    for (int l = warp; l < TNT_LANES; l += nwarp) {
      float sl = 0.f, sw = 0.f;
#pragma unroll 4
      for (int t = lane; t < n; t += 32) {
        const float v = __ldg(nv + (size_t)l * n + t), yt = __ldg(yg + t);
        sl += logf(v);
        sw = fmaf(yt * yt, 1.0f / v, sw);
      }
      sl = gst_warp_sum(sl);
      sw = gst_warp_sum(sw);
      if (lane == 0) cst[(size_t)g * TNT_LANES + l] = -0.5f * (sl + sw);
    }
    return;
  }
  const int k = blockIdx.x * (nthr / TNT_LT_THREADS) + tid / TNT_LT_THREADS;
  const bool active = k < ntiles;
  const int e = tid % TNT_LT_THREADS, a = e >> 3, b = e & 7;
  const int i0 = (active ? tiles[k] : 0) + 2 * a;
  const int j0 = (active ? tiles[ntiles + k] : 0) + 2 * b;
  const bool diag = active && tiles[k] == tiles[ntiles + k];
  float acc[TNT_LANES][4] = {};
  for (int t0 = 0; t0 < n; t0 += kt) {
    const int rows = min(kt, n - t0);
    if (t0) __syncthreads();  // the previous chunk is consumed
    // X by 4-byte asynchronous copies, all of them in flight at once
    for (int r = warp; r < rows; r += nwarp) {
      const float* src = Tg + (size_t)(t0 + r) * m;
      float* dst = Xs + r * xs;
      for (int c = lane; c < xs; c += 32) {
        if (c < m)
          gst_cp4(dst + c, src + c);
        else if (c == m)
          gst_cp4(dst + c, yg + t0 + r);
        else
          dst[c] = 0.f;
      }
    }
    gst_cp_commit();
    // w = 1/nvec, a thread a TOA with its 16 lanes' loads in flight
    // together, stored as one 64-byte row
    for (int r = tid; r < rows; r += nthr) {
      float v[TNT_LANES];
#pragma unroll
      for (int l = 0; l < TNT_LANES; ++l)
        v[l] = __ldg(nv + (size_t)l * n + t0 + r);
      float4* dst = reinterpret_cast<float4*>(Ws + r * TNT_LANES);
#pragma unroll
      for (int q = 0; q < TNT_LANES / 4; ++q)
        dst[q] = make_float4(1.0f / v[4 * q], 1.0f / v[4 * q + 1],
                             1.0f / v[4 * q + 2], 1.0f / v[4 * q + 3]);
    }
    gst_cp_wait<0>();
    __syncthreads();
    if (active) {
#pragma unroll 1
      for (int t = 0; t < rows; ++t) {
        const float2 xi = *reinterpret_cast<const float2*>(Xs + t * xs + i0);
        const float2 xj = *reinterpret_cast<const float2*>(Xs + t * xs + j0);
        const float p[4] = {xi.x * xj.x, xi.x * xj.y, xi.y * xj.x,
                            xi.y * xj.y};
        const float4* wp = reinterpret_cast<const float4*>(Ws + t * TNT_LANES);
#pragma unroll
        for (int v = 0; v < TNT_LANES / 4; ++v) {
          const float4 w4 = wp[v];
          const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[4 * v + u][q] = fmaf(w[u], p[q], acc[4 * v + u][q]);
        }
      }
    }
  }
  if (!active) return;
  // rows i0, i0 + 1 of the patch to TNT (or d for row m), and, off the
  // diagonal tiles, columns j0, j0 + 1 to the transposed places; pairs of
  // neighbouring floats as one 8-byte store where m is even
  const bool pair = (m & 1) == 0;
#pragma unroll
  for (int l = 0; l < TNT_LANES; ++l) {
    const size_t c = (size_t)g * TNT_LANES + l;
    float* Tc = tnt + c * m * m;
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int i = i0 + ii;
      float* dst = i < m ? Tc + (size_t)i * m + j0 : d + c * m + j0;
      if (i <= m)
        tnt_store2(dst, acc[l][2 * ii], acc[l][2 * ii + 1], j0 < m,
                   j0 + 1 < m, pair);
    }
    if (!diag) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        tnt_store2(Tc + (size_t)(j0 + jj) * m + i0, acc[l][jj], acc[l][2 + jj],
                   i0 < m, i0 + 1 < m, pair);
    }
  }
}

}  // namespace

extern "C" {

// Floats of device workspace gst_tnt_batched needs at this shape (0 when
// the shape is out of the kernel's reach; gst_tnt_batched then fails).
size_t gst_tnt_workspace(int C, int n, int m) {
  const int bk = tnt_bk(m);
  int splits = 0;
  if (!bk || tnt_prepare(bk, C, n, m, &splits) != cudaSuccess) return 0;
  return (size_t)splits * C * tnt_qpad(m);
}

// T (n, m), 16-byte aligned, and y (n), 16-byte aligned, shared; w (C, n)
// = 1/nvec; pairs (2, npairs) int32, ops/tnt.py pair_index(m). Writes
// tnt (C, m, m) and d (C, m). `work` holds gst_tnt_workspace(C, n, m)
// floats. Two launches: the pairs kernel over the splits, then the unpack.
int gst_tnt_batched(const float* T, const float* y, const float* w,
                    const int* pairs, int npairs, float* work, float* tnt,
                    float* d, int C, int n, int m, void* stream) {
  const int bk = tnt_bk(m), qpad = tnt_qpad(m);
  if (!bk || npairs != qpad || !gst_aligned16(T, y))
    return (int)cudaErrorInvalidValue;
  int splits = 0;
  cudaError_t e = tnt_prepare(bk, C, n, m, &splits);
  if (e != cudaSuccess) return (int)e;
  const int ntile = (n + bk - 1) / bk;
  const int per = (ntile + splits - 1) / splits;
  const dim3 grid(qpad / TNT_BN, (C + TNT_BM - 1) / TNT_BM, splits);
  const size_t smem = tnt_smem(bk, m);
  cudaStream_t s = (cudaStream_t)stream;
  if (bk == 32)
    tnt_pairs_kernel<32><<<grid, TNT_THREADS, smem, s>>>(T, y, w, pairs, work,
                                                         C, n, m, qpad, per);
  else
    tnt_pairs_kernel<8><<<grid, TNT_THREADS, smem, s>>>(T, y, w, pairs, work,
                                                        C, n, m, qpad, per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)C * ((m + 1) * (m + 2) / 2 - 1);
  const int fblocks = (int)std::min<size_t>((total + 255) / 256, 4096);
  if (fblocks)
    tnt_unpack_kernel<<<fblocks, 256, 0, s>>>(work, pairs, tnt, d, C, m, qpad,
                                              splits);
  return (int)cudaGetLastError();
}

// The lanes form, one launch: B lanes in groups of 16, group g with its own
// basis, rows of m floats from T + g sT (nT >= n of them; only the first n
// are read) and y + g sy; nvec (B, n). tiles (2, ntiles) int32, ops/tnt.py
// lanes_tiles(m); per_block tiles a block, 1 .. 4. Writes tnt (B, m, m),
// both triangles, d (B, m) and cst (B) = -(sum log nvec + y^T N^-1 y) / 2.
int gst_tnt_lanes(const float* T, const float* y, const float* nvec,
                  const int* tiles, int ntiles, float* tnt, float* d,
                  float* cst, int B, int n, int m, long long sT, long long sy,
                  int per_block, void* stream) {
  const int R = (m + 1 + TNT_LT - 1) / TNT_LT;
  if (B % TNT_LANES || m < 1 || n < 0 || ntiles != R * (R + 1) / 2 ||
      per_block < 1 || per_block > TNT_LANES_MAX_PER_BLOCK)
    return (int)cudaErrorInvalidValue;
  if (!B) return (int)cudaSuccess;
  const int xs = R * TNT_LT;
  const size_t row = sizeof(float) * (size_t)(xs + TNT_LANES);
  const int fit = (int)std::min<size_t>(TNT_LANES_SMEM / row, 1 << 30);
  const int kt = std::max(1, std::min(n, fit));
  const size_t smem = row * kt;
  if (smem > (size_t)tnt_optin()) return (int)cudaErrorInvalidValue;
  cudaError_t e = gst_smem_optin(tnt_lanes_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // the tiles' blocks, then one block of each group for its constants
  const dim3 grid((ntiles + per_block - 1) / per_block + 1, B / TNT_LANES);
  tnt_lanes_kernel<<<grid, TNT_LT_THREADS * per_block, smem,
                     (cudaStream_t)stream>>>(T, y, nvec, tiles, ntiles, tnt, d,
                                             cst, n, m, sT, sy, kt, xs);
  return (int)cudaGetLastError();
}

}  // extern "C"
