// Kernel 5: fused 5x5 Gaussian blur + FAST-12 + packed-key windowed NMS.
//
// Replaces tpuslam/kernels/frontend_pallas.py::fused_frontend_nms_batch
// (_nms_kernel).  Plain twin: tpuslam_torch/kernels/frontend.py::
// fused_frontend_nms_reference, i.e. gaussian_blur_u8, then
// _packed_key(score, local_max_nms(corner, score, window)).
//
// Output per pixel: the blur (u8) and the post-NMS packed key (int64), the
// score << 20 | inverted raster index >> idx_shift of a corner that is the
// maximum of its (2*window-1)^2 neighbourhood, else 0.  Both border rules
// are applied here: the blur's 2-px border copies the source, corners live
// in the 3-px interior only (keys outside it are 0, which is also what the
// twin's zero-padded window max reads outside the image).
//
// Design: one block of 256 threads per (frame, 32x64 output tile), in four
// shared-memory passes:
//   1. stage the u8 image over tile +- (R + 3), R = window - 1, zeros
//      outside the image;
//   2. FAST and the packed key over tile +- R (uint32: CUDA has the
//      unsigned max that Mosaic lacked, so no sign flip);
//   3. the window max along rows, for every key row and output column;
//   4. along columns per output pixel; keep = key > 0 && key == max; write
//      the key and the tile's blur.
//
// What should bound it: the recompute, not bytes.  It reads 1 byte a pixel
// and writes 9 (blur u8, key i64), but FAST runs over the (32 + 2R)(64 + 2R)
// extended region: 2.27x the tile's pixels at window 12.
// A later redesign can share FAST results between neighbouring tiles
// (larger tiles, or a separate FAST pass through L2) to cut that.  The
// window max is a plain (2R + 1)-tap loop per pass, ~(2R + 1)(kh + 32)/32
// compares a pixel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fast.cuh"

namespace {

using tpuslam::Taps;

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreads = 256;
constexpr int kFast = 3;                       // FAST circle radius
constexpr int kMaxR = 13;                      // window - 1 <= 13 (window <= 14)
constexpr int kImgH = kTileH + 2 * (kMaxR + kFast);
constexpr int kImgW = kTileW + 2 * (kMaxR + kFast);
constexpr int kKeyH = kTileH + 2 * kMaxR;
constexpr int kKeyW = kTileW + 2 * kMaxR;
constexpr int kIdxBits = 20;

__global__ void __launch_bounds__(kThreads)
frontend_nms_kernel(const uint8_t* __restrict__ images, uint8_t* __restrict__ blur,
                    int64_t* __restrict__ key_out, int H, int W, int threshold,
                    int contiguous, int window, int idx_shift, Taps taps) {
  __shared__ uint8_t img[kImgH][kImgW];
  __shared__ uint32_t key[kKeyH][kKeyW];
  __shared__ uint32_t row_max[kKeyH][kTileW];

  const int R = window - 1;
  const int halo = R + kFast;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = (size_t)H * W;
  const uint8_t* src = images + (size_t)b * plane;

  // 1. image over tile +- halo; local (ly, lx) is global (y0 - halo + ly, x0 - halo + lx)
  const int ih = kTileH + 2 * halo;
  const int iw = kTileW + 2 * halo;
  for (int i = threadIdx.x; i < ih * iw; i += kThreads) {
    const int ly = i / iw;
    const int lx = i - ly * iw;
    const int gy = y0 - halo + ly;
    const int gx = x0 - halo + lx;
    img[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? src[(size_t)gy * W + gx] : 0;
  }
  __syncthreads();

  // 2. packed keys over tile +- R; key (ky, kx) is global (y0 - R + ky, x0 - R + kx)
  const int kh = kTileH + 2 * R;
  const int kw = kTileW + 2 * R;
  const uint32_t last = (uint32_t)H * (uint32_t)W - 1u;
  for (int i = threadIdx.x; i < kh * kw; i += kThreads) {
    const int ky = i / kw;
    const int kx = i - ky * kw;
    const int gy = y0 - R + ky;
    const int gx = x0 - R + kx;
    uint32_t k = 0;
    if (gy >= kFast && gy < H - kFast && gx >= kFast && gx < W - kFast) {
      int sad;
      if (tpuslam::fast_corner(&img[ky + kFast][kx + kFast], kImgW, threshold, contiguous,
                               &sad)) {
        const uint32_t idx = (uint32_t)gy * (uint32_t)W + (uint32_t)gx;
        k = ((uint32_t)sad << kIdxBits) | ((last - idx) >> idx_shift);
      }
    }
    key[ky][kx] = k;
  }
  __syncthreads();

  // 3. max along x: row_max[ky][tx] = max key[ky][tx .. tx + 2R]
  for (int i = threadIdx.x; i < kh * kTileW; i += kThreads) {
    const int ky = i / kTileW;
    const int tx = i - ky * kTileW;
    uint32_t m = 0;
    for (int d = 0; d <= 2 * R; ++d) m = max(m, key[ky][tx + d]);
    row_max[ky][tx] = m;
  }
  __syncthreads();

  // 4. max along y, keep test, and the blur of the tile
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW;
    const int tx = i - ty * kTileW;
    const int gy = y0 + ty;
    const int gx = x0 + tx;
    if (gy >= H || gx >= W) continue;
    uint32_t m = 0;
    for (int d = 0; d <= 2 * R; ++d) m = max(m, row_max[ty + d][tx]);
    const uint32_t k = key[ty + R][tx + R];
    const size_t o = (size_t)b * plane + (size_t)gy * W + gx;
    key_out[o] = (k > 0 && k == m) ? (int64_t)k : 0;
    const uint8_t* c = &img[ty + halo][tx + halo];
    const bool border = gy < 2 || gy >= H - 2 || gx < 2 || gx >= W - 2;
    blur[o] = border ? c[0] : tpuslam::blur5x5(c, kImgW, taps);
  }
}

}  // namespace

extern "C" int tpuslam_frontend_nms(const void* images, void* blur, void* key, int B, int H,
                                    int W, int threshold, int contiguous, int window,
                                    int idx_shift, const float* taps_host, void* stream) {
  if (window < 1 || window - 1 > kMaxR) return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < 25; ++i) taps.k[i] = taps_host[i];
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  frontend_nms_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)images, (uint8_t*)blur, (int64_t*)key, H, W, threshold, contiguous,
      window, idx_shift, taps);
  return (int)cudaGetLastError();
}
