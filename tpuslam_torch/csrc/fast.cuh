// Per-pixel stencils shared by kernel 1 (frontend.cu) and kernel 5 (nms.cu):
// the FAST-12 segment test with its SAD score, and the 5x5 Gaussian blur.
//
// Semantics are those of the plain twins (tpuslam_torch/frontend/fast.py::
// fast_response_and_mask, tpuslam_torch/frontend/brief.py::gaussian_blur_u8),
// bit for bit.  FAST works on two 16-bit masks, bit i set where circle pixel
// i is brighter than centre + threshold (resp. darker than centre -
// threshold), each doubled to 32 bits: the "{0,8} and >= 3 of {0,4,8,12}"
// pretest counts four bits, and the segment test looks for a cyclic run of
// `contiguous` set bits with four shift-ANDs — what the twin's wrap-around
// run counters over 15 + contiguous circle steps find, without their
// serial steps.  The blur adds its 25 taps in row-major order with explicit
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

// The segment test's shifts for a run of n in [1, 16] (the wrappers check
// n): in a mask doubled to 32 bits, y_h bit p means bits p..p+h-1 are all
// set; y_2h = y_h & y_h >> h, and y_n = y_h & y_h >> (n - h) once
// n - h <= h.  Four steps cover n <= 16; unused steps shift by 0.  Computed
// once on the host, so the device does four shift-ANDs and no branch.
struct RunShifts {
  int s[4];
};

inline RunShifts run_shifts(int n) {
  RunShifts r = {{0, 0, 0, 0}};
  int have = 1, step = 0;
  while (2 * have <= n) {
    r.s[step++] = have;
    have *= 2;
  }
  if (have < n) r.s[step] = n - have;
  return r;
}

// Whether the doubled mask (mask16 * 0x10001) holds a cyclic run of n set bits.
__device__ __forceinline__ bool has_cyclic_run(uint32_t doubled, const RunShifts& r) {
  uint32_t y = doubled;
#pragma unroll
  for (int i = 0; i < 4; ++i) y &= y >> r.s[i];
  return y != 0;
}

// FAST decision from the doubled bright and dark masks.  The pretest
// "{0,8} and >= 3 of {0,4,8,12}" is ">= 3 of {0,4,8,12}" (three of the four
// include 0 or 8): both counts at once, the bright one in bits 12-15 and the
// dark one in bits 28-31 of v, and + 5 sets bit 3 of a count >= 3.
__device__ __forceinline__ bool fast_decide(uint32_t bright2, uint32_t dark2,
                                            const RunShifts& r) {
  const uint32_t v = ((bright2 & 0x00001111u) | (dark2 & 0x11110000u)) * 0x1111u;
  const bool pretest = ((v + 0x50005000u) & 0x80008000u) != 0;
  return pretest & (has_cyclic_run(bright2, r) | has_cyclic_run(dark2, r));
}

// FAST corner test and 16-neighbour SAD score of the pixel at `c` in a tile
// staged in shared memory (row stride `stride`; pixels outside the image
// must read as 0 there).
template <typename T>
__device__ __forceinline__ bool fast_corner(const T* c, int stride, int threshold,
                                            const RunShifts& runs, int* sad_out) {
  const int center = c[0];
  const int hi = center + threshold;
  const int lo = center - threshold;
  uint32_t bright = 0, dark = 0;
  int sad = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    int dx, dy;
    circle(i, &dx, &dy);
    const int nb = c[dy * stride + dx];
    bright |= (uint32_t)(nb > hi) << i;
    dark |= (uint32_t)(nb < lo) << i;
    sad += abs(nb - center);
  }
  *sad_out = sad;
  return fast_decide(bright * 0x10001u, dark * 0x10001u, runs);
}

// 5x5 blur: floor(sum of tap * px(dy, dx) + 0.5), taps in row-major order,
// dy and dx in [-2, 2]; `px` returns the pixel as a float.
template <typename Px>
__device__ __forceinline__ uint8_t blur5x5_at(const Taps& taps, Px px) {
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 5; ++dx)
      acc = __fadd_rn(acc, __fmul_rn(taps.k[dy * 5 + dx], px(dy - 2, dx - 2)));
  }
  return (uint8_t)(int)floorf(__fadd_rn(acc, 0.5f));
}

// 5x5 blur of the pixel at `c` in a shared-memory tile of row stride `stride`.
template <typename T>
__device__ __forceinline__ uint8_t blur5x5(const T* c, int stride, const Taps& taps) {
  return blur5x5_at(taps, [&](int dy, int dx) { return (float)c[dy * stride + dx]; });
}

}  // namespace tpuslam
