// Per-pixel stencils shared by kernel 1 (frontend.cu) and kernel 5 (nms.cu):
// the FAST-12 segment test with its SAD score, and the 5x5 Gaussian blur.
// Both read a tile staged in shared memory through a pointer to the centre
// pixel and the tile's row stride; pixels outside the image must already
// read as 0 there.
//
// Semantics are those of the plain twins (tpuslam_torch/frontend/fast.py::
// fast_response_and_mask, tpuslam_torch/frontend/brief.py::gaussian_blur_u8),
// bit for bit: FAST runs the wrap-around bright/dark run counters over
// 15 + contiguous circle steps with the "{0,8} and >= 3 of {0,4,8,12}"
// pretest; the blur adds its 25 taps in row-major order with explicit
// __fmul_rn/__fadd_rn (nvcc would otherwise contract to FMA and change the
// rounding that floor(acc + 0.5) sees).

#pragma once

#include <stdint.h>

namespace tpuslam {

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

// FAST corner test and 16-neighbour SAD score of the pixel at `c`.
template <typename T>
__device__ __forceinline__ bool fast_corner(const T* c, int stride, int threshold,
                                            int contiguous, int* sad_out) {
  const int center = c[0];
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
    const int nb = c[dy * stride + dx];
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
  *sad_out = sad;
  return first_pair && (nb4 >= 3 || nd4 >= 3) && seg;
}

// 5x5 blur of the pixel at `c`: floor(sum of tap * pixel + 0.5).
template <typename T>
__device__ __forceinline__ uint8_t blur5x5(const T* c, int stride, const Taps& taps) {
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 5; ++dx) {
      const float px = (float)c[(dy - 2) * stride + (dx - 2)];
      acc = __fadd_rn(acc, __fmul_rn(taps.k[dy * 5 + dx], px));
    }
  }
  return (uint8_t)(int)floorf(__fadd_rn(acc, 0.5f));
}

}  // namespace tpuslam
