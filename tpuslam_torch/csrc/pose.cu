// Kernel 4: MSAC scores of essential-matrix hypotheses.
//
// Replaces tpuslam/kernels/pose_pallas.py::msac_scores_pallas (_msac_kernel).
// Plain twin: tpuslam_torch/kernels/pose.py::msac_scores_reference.
//
// score[h] = sum_m min(err^2 / max(denom, 1e-18), 1), where err and the four
// gradient terms of denom are 9-term dot products of the hypothesis vec(E)
// with five columns of the (9, 5M) match operand (build_msac_operand).
//
// What bounds it on the H100: float32 FMAs — 45 products per (hypothesis,
// match), 0.75 G multiply-adds per 16-pair chunk at H=M=1024 — against a
// tiny footprint: E is 36 bytes per hypothesis and the operand 180 bytes
// per match, so nothing needs to leave the SM but one float per hypothesis.
// Design: one block per (frame pair, 128-hypothesis slab), one thread per
// hypothesis holding its 9 entries of E in registers; the block walks the
// matches in tiles of 32 columns staged in shared memory (every thread
// reads the same column, a broadcast), and each thread accumulates its own
// truncated sum in match order.  No atomics: results are deterministic.
// The dot products and the denominator use explicit __fmul_rn/__fadd_rn in
// the order of the plain twin, so only the final sum's order differs from
// it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHyp = 128;   // hypotheses per block (threads)
constexpr int kCols = 32;   // matches per shared-memory tile

__device__ __forceinline__ float dot9(const float* e, const float* col, int stride) {
  float s = __fmul_rn(e[0], col[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) s = __fadd_rn(s, __fmul_rn(e[i], col[i * stride]));
  return s;
}

__global__ void __launch_bounds__(kHyp)
msac_kernel(const float* __restrict__ E, const float* __restrict__ P,
            float* __restrict__ out, int H, int M) {
  __shared__ float tile[9][5][kCols];
  const int pair = blockIdx.y;
  const int h = blockIdx.x * kHyp + threadIdx.x;
  const float* Pp = P + (size_t)pair * 9 * 5 * M;
  float e[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) e[i] = h < H ? E[((size_t)pair * H + h) * 9 + i] : 0.0f;
  float acc = 0.0f;
  for (int m0 = 0; m0 < M; m0 += kCols) {
    for (int i = threadIdx.x; i < 9 * 5 * kCols; i += kHyp) {
      const int r = i / (5 * kCols);
      const int rem = i - r * 5 * kCols;
      const int blk = rem / kCols;
      const int c = rem - blk * kCols;
      const int m = m0 + c;
      tile[r][blk][c] = m < M ? Pp[(size_t)r * 5 * M + (size_t)blk * M + m] : 0.0f;
    }
    __syncthreads();
    const int n = min(kCols, M - m0);
    for (int c = 0; c < n; ++c) {
      const int stride = 5 * kCols;
      const float err = dot9(e, &tile[0][0][c], stride);
      const float a1 = dot9(e, &tile[0][1][c], stride);
      const float a2 = dot9(e, &tile[0][2][c], stride);
      const float b1 = dot9(e, &tile[0][3][c], stride);
      const float b2 = dot9(e, &tile[0][4][c], stride);
      const float denom = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(a1, a1), __fmul_rn(a2, a2)), __fmul_rn(b1, b1)),
          __fmul_rn(b2, b2));
      const float e2 = __fdiv_rn(__fmul_rn(err, err), fmaxf(denom, 1e-18f));
      acc = __fadd_rn(acc, fminf(e2, 1.0f));
    }
    __syncthreads();
  }
  if (h < H) out[(size_t)pair * H + h] = acc;
}

}  // namespace

extern "C" int tpuslam_msac_scores(const void* E, const void* P, void* out, int B, int H,
                                   int M, void* stream) {
  dim3 grid((H + kHyp - 1) / kHyp, B);
  msac_kernel<<<grid, kHyp, 0, (cudaStream_t)stream>>>((const float*)E, (const float*)P,
                                                        (float*)out, H, M);
  return (int)cudaGetLastError();
}
