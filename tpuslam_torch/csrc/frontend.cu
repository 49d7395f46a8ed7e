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
// Semantics match the plain twin bit for bit: pixels outside the image read
// as 0; the 25 blur taps are accumulated in row-major order with explicit
// __fmul_rn/__fadd_rn (nvcc would otherwise contract to FMA and change the
// rounding that floor(acc + 0.5) sees); FAST runs the wrap-around
// bright/dark run counters over 15 + contiguous circle steps with the
// "{0,8} and >= 3 of {0,4,8,12}" pretest.  The border rules (blur border
// copied from the source, corners masked to the 3-px interior) are applied
// by the Python wrapper, as in the reference package.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 3;
constexpr int kSmem = kTile + 2 * kHalo;

struct Taps {
  float k[25];
};

__device__ __forceinline__ void circle(int i, int* dx, int* dy) {
  // (dx, dy), index 0 at 12 o'clock, clockwise (fast.py CIRCLE_OFFSETS).
  const int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  *dx = DX[i];
  *dy = DY[i];
}

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
  const int cy = threadIdx.y + kHalo;
  const int cx = threadIdx.x + kHalo;

  // 5x5 blur, taps in row-major order, no FMA contraction.
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 5; ++dx) {
      const float px = (float)tile[cy + dy - 2][cx + dx - 2];
      acc = __fadd_rn(acc, __fmul_rn(taps.k[dy * 5 + dx], px));
    }
  }
  const uint8_t blurred = (uint8_t)(int)floorf(__fadd_rn(acc, 0.5f));

  // FAST: rolling run counters over the circle, wrapped.
  const int center = tile[cy][cx];
  const int hi = center + threshold;
  const int lo = center - threshold;
  int bright_run = 0, dark_run = 0, sad = 0, nb4 = 0, nd4 = 0;
  bool seg = false, first_pair = false;
  const int steps = min(32, 15 + contiguous);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i >= steps) break;
    int dx, dy;
    circle(i & 15, &dx, &dy);
    const int nb = tile[cy + dy][cx + dx];
    const bool bright = nb > hi;
    const bool dark = nb < lo;
    bright_run = bright ? bright_run + 1 : 0;
    dark_run = dark ? dark_run + 1 : 0;
    seg = seg || bright_run >= contiguous || dark_run >= contiguous;
    if (i < 16) {
      sad += abs(nb - center);
      if ((i & 3) == 0) {
        nb4 += bright;
        nd4 += dark;
        if (i == 0 || i == 8) first_pair = first_pair || bright || dark;
      }
    }
  }
  const bool is_corner = first_pair && (nb4 >= 3 || nd4 >= 3) && seg;

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
