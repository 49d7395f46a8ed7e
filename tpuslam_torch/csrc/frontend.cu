// Kernel 1: fused 5x5 Gaussian blur + FAST-12 segment test + SAD score.
//
// Replaces tpuslam/kernels/frontend_pallas.py::fused_frontend_batch
// (_frontend_kernel).  Plain twin: tpuslam_torch/frontend/brief.py::
// gaussian_blur_u8 and tpuslam_torch/frontend/fast.py::fast_response_and_mask.
//
// What bounds it on the H100: bytes.  Per pixel it reads 1 byte and writes
// 6 (blur u8, corner u8, score i32) against ~25 FMAs and ~27 compares: far
// below the card's FLOP/byte ridge.  The design keeps each input byte to
// one device-memory read: a block stages its 32x32 output tile plus the
// 3-pixel halo both stencils need (FAST radius 3, blur radius 2) in shared
// memory, one thread per output pixel, and every neighbour read after that
// comes from shared memory.  Outputs are written once, coalesced along rows.
//
// Semantics match the plain twins bit for bit (the stencils are shared with
// kernel 5, fast.cuh).  The border rules (blur border copied from the
// source, corners masked to the 3-px interior) are applied by the Python
// wrapper, as in the reference package.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fast.cuh"

namespace {

using tpuslam::Taps;

constexpr int kTile = 32;
constexpr int kHalo = 3;
constexpr int kSmem = kTile + 2 * kHalo;

__global__ void __launch_bounds__(kTile * kTile)
frontend_kernel(const uint8_t* __restrict__ images, uint8_t* __restrict__ blur,
                uint8_t* __restrict__ corner, int32_t* __restrict__ score, int H,
                int W, int threshold, int contiguous, Taps taps) {
  __shared__ int tile[kSmem][kSmem];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const size_t plane = (size_t)H * W;
  const uint8_t* src = images + b * plane;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < kSmem * kSmem; i += kTile * kTile) {
    const int ly = i / kSmem;
    const int lx = i - ly * kSmem;
    const int gy = y0 + ly - kHalo;
    const int gx = x0 + lx - kHalo;
    tile[ly][lx] =
        (gy >= 0 && gy < H && gx >= 0 && gx < W) ? (int)src[(size_t)gy * W + gx] : 0;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int* c = &tile[threadIdx.y + kHalo][threadIdx.x + kHalo];
  const uint8_t blurred = tpuslam::blur5x5(c, kSmem, taps);
  int sad;
  const bool is_corner = tpuslam::fast_corner(c, kSmem, threshold, contiguous, &sad);

  const size_t o = b * plane + (size_t)y * W + x;
  blur[o] = blurred;
  corner[o] = is_corner ? 1 : 0;
  score[o] = sad;
}

}  // namespace

extern "C" const char* tpuslam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int tpuslam_frontend(const void* images, void* blur, void* corner, void* score,
                                int B, int H, int W, int threshold, int contiguous,
                                const float* taps_host, void* stream) {
  Taps taps;
  for (int i = 0; i < 25; ++i) taps.k[i] = taps_host[i];
  dim3 block(kTile, kTile);
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  frontend_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)images, (uint8_t*)blur, (uint8_t*)corner, (int32_t*)score, H, W,
      threshold, contiguous, taps);
  return (int)cudaGetLastError();
}
