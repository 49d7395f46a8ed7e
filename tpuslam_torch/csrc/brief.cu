// Kernels 2 and 3: BRIEF patch extraction and own-orientation-bin dots.
//
// Kernel 2 replaces tpuslam/kernels/brief_pallas.py::extract_patches_pallas
// (_extract_kernel; wrapper extract_brief_patches_tpu).  Plain twin:
// tpuslam_torch/frontend/brief.py::extract_brief_patches_i8.
//   Bound on the H100: bytes — it is a gather that moves K*S2p bytes per
//   frame (37.7 MB per 16-frame chunk at K=1024, S2p=2304) and computes
//   nothing.  Design: one block per (frame, keypoint); consecutive threads
//   read consecutive pixels of a patch row and write consecutive output
//   bytes, so both sides coalesce; the 48-wide rows of neighbouring
//   patches overlap, and L1/L2 absorb the re-reads of the blurred image.
//
// Kernel 3 replaces tpuslam/kernels/brief_pallas.py::brief_own_bin_dots
// (_own_bin_kernel).  Plain twin: tpuslam_torch/frontend/brief.py::
// own_bin_dots_onehot.
//   Bound on the H100: int8 multiply-accumulates — 2304 per (keypoint,
//   pair), 9.7 G per 16-frame chunk — and the L2 reads of each keypoint's
//   590 KB W[bin] slab that feed them.  Design: one block per (frame,
//   keypoint), one thread per pair; the keypoint's patch sits in shared
//   memory as packed int32 words, W arrives pre-packed four rows to a word
//   ((bins, S2p/4, P) int32, packed by the wrapper), so a warp reads 128
//   contiguous bytes per step and each thread retires four MACs per __dp4a.
//   Only the keypoint's own bin is ever computed (the Pallas kernel's point:
//   the (K, bins*P) tensor never exists).  Integer arithmetic, exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kExtractThreads = 256;
constexpr int kDotThreads = 256;

__global__ void __launch_bounds__(kExtractThreads)
extract_kernel(const uint8_t* __restrict__ blurred, const float* __restrict__ kps_xy,
               int8_t* __restrict__ out, int H, int W, int K, int side, int half,
               int s2p) {
  const int bk = blockIdx.x;  // frame * K + keypoint
  const int b = bk / K;
  // float -> int truncates toward zero, then clip (brief_pallas.py:133-134).
  const int xi = min(max((int)kps_xy[2 * bk], 0), W - 1);
  const int yi = min(max((int)kps_xy[2 * bk + 1], 0), H - 1);
  const uint8_t* img = blurred + (size_t)b * H * W;
  int8_t* dst = out + (size_t)bk * s2p;
  const int n = side * side;
  for (int i = threadIdx.x; i < s2p; i += kExtractThreads) {
    int v = 0;
    if (i < n) {
      const int r = i / side;
      const int c = i - r * side;
      const int gy = yi - half + r;
      const int gx = xi - half + c;
      const int px =
          (gy >= 0 && gy < H && gx >= 0 && gx < W) ? (int)img[(size_t)gy * W + gx] : 0;
      v = px - 128;
    }
    dst[i] = (int8_t)v;
  }
}

__global__ void __launch_bounds__(kDotThreads)
own_bin_kernel(const int8_t* __restrict__ patches, const int32_t* __restrict__ bin_idx,
               const int32_t* __restrict__ w4, int32_t* __restrict__ out, int s2p, int P,
               int bins) {
  extern __shared__ int32_t patch4[];  // s2p / 4 packed words
  const int bk = blockIdx.x;
  const int q_len = s2p / 4;
  const int32_t* src = reinterpret_cast<const int32_t*>(patches + (size_t)bk * s2p);
  for (int q = threadIdx.x; q < q_len; q += kDotThreads) patch4[q] = src[q];
  __syncthreads();
  const int bin = bin_idx[bk];
  const bool in_range = bin >= 0 && bin < bins;
  const int32_t* w = w4 + (size_t)(in_range ? bin : 0) * q_len * P;
  for (int p = threadIdx.x; p < P; p += kDotThreads) {
    int acc = 0;
    if (in_range) {
#pragma unroll 8
      for (int q = 0; q < q_len; ++q) acc = __dp4a(patch4[q], w[(size_t)q * P + p], acc);
    }
    out[(size_t)bk * P + p] = acc;
  }
}

}  // namespace

extern "C" int tpuslam_extract_patches(const void* blurred, const void* kps_xy, void* out,
                                       int B, int H, int W, int K, int side, int half,
                                       int s2p, void* stream) {
  extract_kernel<<<B * K, kExtractThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blurred, (const float*)kps_xy, (int8_t*)out, H, W, K, side, half,
      s2p);
  return (int)cudaGetLastError();
}

extern "C" int tpuslam_own_bin_dots(const void* patches, const void* bin_idx,
                                    const void* w4, void* out, int B, int K, int s2p,
                                    int P, int bins, void* stream) {
  const size_t smem = (size_t)s2p;  // s2p / 4 int32 words
  own_bin_kernel<<<B * K, kDotThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)patches, (const int32_t*)bin_idx, (const int32_t*)w4, (int32_t*)out,
      s2p, P, bins);
  return (int)cudaGetLastError();
}
