// Kernel 4: MSAC scores of essential-matrix hypotheses.
//
// Replaces tpuslam/kernels/pose_pallas.py::msac_scores_pallas (_msac_kernel).
// Plain twin: tpuslam_torch/kernels/pose.py::msac_scores_reference.
//
// score[h] = sum_m min(err^2 / max(denom, 1e-18), 1), where err and the four
// gradient terms of denom are 9-term dot products of the hypothesis vec(E)
// with five of the 45 rows of the (9, 5M) match operand (build_msac_operand;
// row 5 i + blk of its (45, M) view is entry i of column block blk).
//
// What bounds it on the H100: float32 operations.  97 per (hypothesis,
// match), 1.63 G per 16-pair chunk at H = M = 1024, against 3.6 MB of
// operands: 24.3 us at the card's 67 TFLOP/s.  That rate counts a fused
// multiply-add as two; here every product and every sum is rounded on its
// own (__fmul_rn/__fadd_rn, the twin's rounding), one operation an
// instruction, and the IEEE divide is about nine more, so the floor of this
// arithmetic is near 2.3x the bound.  The data are tiny and shared: what
// must not happen is that loads, not arithmetic, fill the schedulers'
// slots, or that schedulers sit with one warp each.
//
// Design: register tiling, with the matches split over the warps of a block.
//   - A block takes one (frame pair, slab of 128 hypotheses).  Every lane of
//     every warp holds the same 4 hypotheses of the slab (lane, lane + 32,
//     ...; 36 registers of E), so a warp covers the whole slab.
//   - The block's 16 warps split the matches: warp w takes the 32-match
//     tiles w, w + 16, ... and stages each in its own shared memory with
//     cp.async (16 bytes a lane where M and the operand's address allow, 4
//     otherwise; two buffers, the next tile in flight while this one is
//     scored).  Nothing but __syncwarp orders a warp's loads and reads.
//   - A tile is scored four matches at a time: one 16-byte shared load (a
//     broadcast, every lane reads the same address) brings one operand row
//     of four matches and feeds 16 (hypothesis, match) accumulators, so
//     there are 45 shared loads for ~1,700 arithmetic operations where a
//     thread with one hypothesis made 45 for 97.
//   - Each warp leaves its partial sums in shared memory; after one
//     __syncthreads the block's first 128 threads add the 16 partials in
//     warp order.  No atomics: two runs give the same bits.  Only the order
//     of the sum over matches differs from the twin's (a thread adds its own
//     matches in index order); every product, dot product, denominator and
//     the divide keep the twin's order and rounding.
//   - Matches past M are staged as zeros and score exactly 0, as invalid
//     matches do; hypotheses past H are computed on zeros and not stored.
//     A zero numerator skips the divide (its quotient is +0 either way):
//     div.rn's range check sends 0 / x down its slow path, and the main
//     path's operand is mostly invalid matches (a third less time there).
//   One pair's double-buffered tiles for 16 warps plus the partials are
//   192,512 bytes of dynamic shared memory: one block of 512 threads an SM,
//   16 warps resident, four a scheduler, each with 16 independent chains.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHypPerThread = 4;            // hypotheses a thread
constexpr int kSlab = 32 * kHypPerThread;   // hypotheses a block
constexpr int kWarps = 16;                  // warps a block; each takes every 16th tile
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                   // matches a tile
constexpr int kRows = 45;                   // operand rows: 9 entries of vec(E) x 5 blocks
constexpr int kStages = 2;                  // tile buffers a warp
constexpr int kTileFloats = kRows * kTile;
constexpr size_t kSharedBytes =
    sizeof(float) * ((size_t)kWarps * kStages * kTileFloats + (size_t)kWarps * kSlab);

__device__ __forceinline__ void cp_async(float* smem, const float* gmem, bool vec, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  // fewer source bytes than the copy's size: the rest is written as zeros
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage matches m0 .. m0 + 31 of the pair's (45, M) operand; zeros past M.
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ Pp, int M,
                                          int m0, int lane, bool vec) {
  if (vec) {  // M % 4 == 0: a 16-byte unit is wholly inside or wholly past M
    for (int i = lane; i < kRows * (kTile / 4); i += 32) {
      const int row = i / (kTile / 4);
      const int c = (i - row * (kTile / 4)) * 4;
      const bool in = m0 + c < M;
      cp_async(tile + row * kTile + c, in ? Pp + (size_t)row * M + m0 + c : Pp, true, in ? 16 : 0);
    }
  } else {
    const bool in = m0 + lane < M;
    for (int row = 0; row < kRows; ++row)
      cp_async(tile + row * kTile + lane, in ? Pp + (size_t)row * M + m0 + lane : Pp, false,
               in ? 4 : 0);
  }
}

// Add the truncated errors of the tile's first `groups` x 4 matches to the
// thread's scores, matches in index order.
__device__ __forceinline__ void score_tile(const float* __restrict__ tile, int groups,
                                           const float (&e)[kHypPerThread][9],
                                           float (&score)[kHypPerThread]) {
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    float err[kHypPerThread][4], den[kHypPerThread][4];
#pragma unroll
    for (int blk = 0; blk < 5; ++blk) {
      float dot[kHypPerThread][4];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(tile + (5 * i + blk) * kTile + 4 * g);
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int j = 0; j < kHypPerThread; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float prod = __fmul_rn(e[j][i], p[c]);
            dot[j][c] = i == 0 ? prod : __fadd_rn(dot[j][c], prod);
          }
      }
#pragma unroll
      for (int j = 0; j < kHypPerThread; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (blk == 0) {
            err[j][c] = dot[j][c];
          } else {
            const float sq = __fmul_rn(dot[j][c], dot[j][c]);
            den[j][c] = blk == 1 ? sq : __fadd_rn(den[j][c], sq);
          }
        }
    }
#pragma unroll
    for (int j = 0; j < kHypPerThread; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // 0 / x is +0 for every x >= 1e-18, and the IEEE divide takes its slow
        // path on a zero numerator: every invalid (zeroed) match would pay it
        const float num = __fmul_rn(err[j][c], err[j][c]);
        float e2 = 0.0f;
        if (num != 0.0f) e2 = __fdiv_rn(num, fmaxf(den[j][c], 1e-18f));
        score[j] = __fadd_rn(score[j], fminf(e2, 1.0f));
      }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
msac_kernel(const float* __restrict__ E, const float* __restrict__ P,
            float* __restrict__ out, int H, int M, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* partial = smem + kWarps * kStages * kTileFloats;  // [kWarps][kSlab]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pair = blockIdx.y;
  const int h0 = blockIdx.x * kSlab;
  const float* Pp = P + (size_t)pair * kRows * M;
  float* tiles = smem + warp * kStages * kTileFloats;

  const int n_tiles = (M + kTile - 1) / kTile;
  if (warp < n_tiles) load_tile(tiles, Pp, M, warp * kTile, lane, vec);
  cp_async_commit();

  float e[kHypPerThread][9];
#pragma unroll
  for (int j = 0; j < kHypPerThread; ++j) {
    const int h = h0 + 32 * j + lane;
#pragma unroll
    for (int i = 0; i < 9; ++i) e[j][i] = h < H ? E[((size_t)pair * H + h) * 9 + i] : 0.0f;
  }
  float score[kHypPerThread];
#pragma unroll
  for (int j = 0; j < kHypPerThread; ++j) score[j] = 0.0f;

  int stage = 0;
  for (int t = warp; t < n_tiles; t += kWarps, stage ^= 1) {
    if (t + kWarps < n_tiles)
      load_tile(tiles + (stage ^ 1) * kTileFloats, Pp, M, (t + kWarps) * kTile, lane, vec);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile t has landed for this lane
    __syncwarp();        // ... and for the warp's other lanes
    score_tile(tiles + stage * kTileFloats, (min(kTile, M - t * kTile) + 3) / 4, e, score);
    __syncwarp();        // every lane is done with this buffer before it is refilled
  }

#pragma unroll
  for (int j = 0; j < kHypPerThread; ++j) partial[warp * kSlab + 32 * j + lane] = score[j];
  __syncthreads();
  const int h = h0 + threadIdx.x;
  if (threadIdx.x < kSlab && h < H) {
    float sum = partial[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, partial[w * kSlab + threadIdx.x]);
    out[(size_t)pair * H + h] = sum;
  }
}

}  // namespace

extern "C" int tpuslam_msac_scores(const void* E, const void* P, void* out, int B, int H,
                                   int M, void* stream) {
  // above the 48 KB a kernel gets unasked; per device, so set on every call
  cudaError_t err = cudaFuncSetAttribute(msac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSharedBytes);
  if (err != cudaSuccess) return (int)err;
  const int vec = M % 4 == 0 && (uintptr_t)P % 16 == 0;
  dim3 grid((H + kSlab - 1) / kSlab, B);
  msac_kernel<<<grid, kThreads, kSharedBytes, (cudaStream_t)stream>>>(
      (const float*)E, (const float*)P, (float*)out, H, M, vec);
  return (int)cudaGetLastError();
}
