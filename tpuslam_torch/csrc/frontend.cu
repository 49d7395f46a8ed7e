// Kernel 1: fused 5x5 Gaussian blur + FAST-12 segment test + SAD score.
//
// Replaces tpuslam/kernels/frontend_pallas.py::fused_frontend_batch
// (_frontend_kernel).  Plain twin: tpuslam_torch/kernels/frontend.py::
// fused_frontend_reference (gaussian_blur_u8 and fast_response_and_mask).
// Outputs, each (B, H, W): blur u8 with the 2-px border copied from the
// source, corner u8 (0/1) masked to the 3-px interior, and the SAD score
// i32 everywhere (zeros outside the image) — the reference's border rules,
// applied here, so the wrapper only allocates and launches.
//
// What bounds it on the H100: bytes.  Per pixel it reads 1 byte and writes
// 6 (blur u8, corner u8, score i32): 7 B/px, 23.8 us for the main path's
// (16, 512, 1392) at 3.35 TB/s, against 50 float32 operations a pixel
// (8.5 us at 67 TFLOP/s).  What held the one-pixel-a-thread design back was
// instructions (~300 a pixel: 41 shared loads, 27 serial run-counter steps)
// and the border rules as seven more full-plane torch ops.  Design:
//   - one block of 128 threads per (frame, 12 x 128 tile); the tile and its
//     3-px halo are staged in shared memory as u8 with 16-byte loads (byte
//     loads only at the image's edges or when rows are not 16-byte aligned);
//   - each thread owns 4 horizontally adjacent pixels of 3 rows, and keeps
//     the 9 x 12-byte neighbourhood of its strip in registers (27 words);
//     of 1-16 rows a thread and 64-512 threads a block, 3 rows of 128
//     threads (95 registers, five blocks an SM) ran fastest on the H100;
//   - FAST runs 4 pixels at once in the bytes of a word: the circle pixel
//     i of the 4 pixels is one funnel shift, the bright and dark compares
//     against the saturated centre +- threshold are SWAR byte compares, their
//     results go into per-byte 16-bit masks (their bit shifts done as
//     __umulhi, on the multiplier's pipe), and the SAD uses __vabsdiffu4;
//     each pixel's decision is then a byte permute, a multiply-add pretest
//     and four shift-ANDs per mask, with no branch (fast.cuh);
//   - the blur keeps its arithmetic: 25 taps in row-major order,
//     __fmul_rn/__fadd_rn, floor(acc + 0.5); each window byte becomes a float
//     once (an exact byte permute into 2^23's mantissa, minus 2^23), and the
//     five float rows a pixel row needs slide down the strip in registers;
//   - blur and corner leave as 4-byte words, the score as 16-byte vectors.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fast.cuh"

namespace {

using tpuslam::Taps;

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 3;
constexpr int kTileW = 32 * 4;                              // 32 lanes x 4 pixels
constexpr int kTileH = (kThreads / 32) * kRowsPerThread;    // 4 warps x 3 rows
constexpr int kHalo = 3;
constexpr int kLeft = 16;                                   // staged columns left of the tile
constexpr int kSmemH = kTileH + 2 * kHalo;
constexpr int kSmemW = kLeft + kTileW + 16;                 // 16-byte aligned on both sides
constexpr int kWinRows = kRowsPerThread + 2 * kHalo;
constexpr uint32_t kMsb = 0x80808080u;

// Per byte, the most significant bit set where a >= b (unsigned).
__device__ __forceinline__ uint32_t ge_u8x4(uint32_t a, uint32_t b) {
  const uint32_t low = (a | kMsb) - (b & ~kMsb);  // msb: low 7 bits of a >= those of b
  return (((a ^ b) & a) | (~(a ^ b) & low)) & kMsb;
}

// The 4 bytes of the 12-byte window `w` that start at byte s (0 <= s <= 8).
__device__ __forceinline__ uint32_t bytes_at(const uint32_t (&w)[3], int s) {
  return (s & 3) == 0 ? w[s >> 2] : __funnelshift_r(w[s >> 2], w[(s >> 2) + 1], 8 * (s & 3));
}

// Byte s of the window as a float, exactly: the byte in the mantissa of 2^23, minus 2^23.
__device__ __forceinline__ float byte_f(const uint32_t (&w)[3], int s) {
  return __fsub_rn(__uint_as_float(__byte_perm(w[s >> 2], 0x4B000000u, (s & 3) | 0x7440)),
                   8388608.0f);
}

__global__ void __launch_bounds__(kThreads)
frontend_kernel(const uint8_t* __restrict__ images, uint8_t* __restrict__ blur,
                uint8_t* __restrict__ corner, int32_t* __restrict__ score, int H, int W,
                int threshold, tpuslam::RunShifts runs, int vec_in, int vec_out, Taps taps) {
  __shared__ __align__(16) uint8_t tile[kSmemH][kSmemW];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = (size_t)H * W;
  const uint8_t* src = images + b * plane;

  // 1. rows y0-3 .. y0+kTileH+2, columns x0-16 .. x0+kTileW+15; zeros outside the image.
  for (int i = threadIdx.x; i < kSmemH * (kSmemW / 16); i += kThreads) {
    const int ly = i / (kSmemW / 16);
    const int lc = (i - ly * (kSmemW / 16)) * 16;
    const int gy = y0 - kHalo + ly;
    const int gx = x0 - kLeft + lc;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H) {
      const uint8_t* row = src + (size_t)gy * W;
      if (vec_in && gx >= 0 && gx + 16 <= W) {
        v = *reinterpret_cast<const uint4*>(row + gx);
      } else {
        uint32_t q[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int x = gx + j;
          if (x >= 0 && x < W) q[j >> 2] |= (uint32_t)row[x] << (8 * (j & 3));
        }
        v = make_uint4(q[0], q[1], q[2], q[3]);
      }
    }
    *reinterpret_cast<uint4*>(&tile[ly][lc]) = v;
  }
  __syncthreads();

  // 2. The thread's pixels: x = xs .. xs+3 of kRowsPerThread rows.  Window byte s
  //    of a row is column xs - 4 + s, so pixel j sits at byte 4 + j.
  const int lane = threadIdx.x & 31;
  const int xs = x0 + 4 * lane;
  const int ly0 = (threadIdx.x >> 5) * kRowsPerThread;
  if (xs >= W || y0 + ly0 >= H) return;
  uint32_t win[kWinRows][3];
#pragma unroll
  for (int r = 0; r < kWinRows; ++r) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(&tile[ly0 + r][kLeft - 4 + 4 * lane]);
    win[r][0] = p[0];
    win[r][1] = p[1];
    win[r][2] = p[2];
  }
  const uint32_t t4 = (uint32_t)threshold * 0x01010101u;

  // The blur's window rows as floats, converted once each, five at a time.
  float fr[5][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) fr[r + 1][q] = byte_f(win[r + 1], q + 2);

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int y = y0 + ly0 + i;
    if (y >= H) break;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) fr[r][q] = fr[r + 1][q];
#pragma unroll
    for (int q = 0; q < 8; ++q) fr[4][q] = byte_f(win[i + 5], q + 2);

    const uint32_t c4 = win[i + kHalo][1];
    const uint32_t hi4 = __vaddus4(c4, t4);  // saturated: nothing is brighter than 255
    const uint32_t lo4 = __vsubus4(c4, t4);  // nor darker than 0
    uint32_t bright_lo = 0, bright_hi = 0, dark_lo = 0, dark_hi = 0;
    uint32_t sad_even = 0, sad_odd = 0;      // pixels 0, 2 and 1, 3 in 16-bit lanes
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      int dx, dy;
      tpuslam::circle(k, &dx, &dy);
      const uint32_t nb = bytes_at(win[i + kHalo + dy], 4 + dx);
      const uint32_t br = ~ge_u8x4(hi4, nb) & kMsb;  // nb > centre + threshold
      const uint32_t dk = ~ge_u8x4(nb, lo4) & kMsb;  // nb < centre - threshold
      // bit 7 of byte j -> bit k & 7 of byte j: a right shift by 7 - (k & 7),
      // done as the high word of a product (the multiplier's pipe, not the ALU's)
      const int m = k & 7;
      const uint32_t br_k = m == 7 ? br : __umulhi(br, 1u << (25 + m));
      const uint32_t dk_k = m == 7 ? dk : __umulhi(dk, 1u << (25 + m));
      if (k < 8) {
        bright_lo += br_k;
        dark_lo += dk_k;
      } else {
        bright_hi += br_k;
        dark_hi += dk_k;
      }
      const uint32_t ad = __vabsdiffu4(nb, c4);
      sad_even += ad & 0x00FF00FFu;
      sad_odd += (ad >> 8) & 0x00FF00FFu;
    }

    const bool row_blur = y >= 2 && y < H - 2;
    const bool row_fast = y >= kHalo && y < H - kHalo;
    uint32_t blur4 = 0, corner4 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = xs + j;
      // bytes (lo_j, hi_j, lo_j, hi_j): the pixel's 16-bit mask doubled to 32 bits
      const uint32_t sel = j | ((j + 4) << 4) | (j << 8) | ((j + 4) << 12);
      const bool is_corner =
          row_fast & (x >= kHalo) & (x < W - kHalo) &
          tpuslam::fast_decide(__byte_perm(bright_lo, bright_hi, sel),
                               __byte_perm(dark_lo, dark_hi, sel), runs);
      const uint32_t blurred =
          tpuslam::blur5x5_at(taps, [&](int ddy, int ddx) { return fr[ddy + 2][j + 2 + ddx]; });
      const uint32_t bl = row_blur & (x >= 2) & (x < W - 2) ? blurred : (c4 >> (8 * j)) & 0xFFu;
      blur4 |= bl << (8 * j);
      corner4 |= (uint32_t)is_corner << (8 * j);
    }

    const int sad[4] = {(int)(sad_even & 0xFFFFu), (int)(sad_odd & 0xFFFFu),
                        (int)(sad_even >> 16), (int)(sad_odd >> 16)};
    const size_t o = b * plane + (size_t)y * W + xs;
    if (vec_out && xs + 3 < W) {
      *reinterpret_cast<uint32_t*>(blur + o) = blur4;
      *reinterpret_cast<uint32_t*>(corner + o) = corner4;
      *reinterpret_cast<int4*>(score + o) = make_int4(sad[0], sad[1], sad[2], sad[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (xs + j >= W) break;
        blur[o + j] = (uint8_t)(blur4 >> (8 * j));
        corner[o + j] = (uint8_t)(corner4 >> (8 * j));
        score[o + j] = sad[j];
      }
    }
  }
}

}  // namespace

extern "C" const char* tpuslam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int tpuslam_frontend(const void* images, void* blur, void* corner, void* score,
                                int B, int H, int W, int threshold, int contiguous,
                                const float* taps_host, void* stream) {
  if (threshold < 0 || threshold > 255 || contiguous < 1 || contiguous > 16)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < 25; ++i) taps.k[i] = taps_host[i];
  // 16-byte loads need 16-byte aligned rows; 4- and 16-byte stores need W % 4 == 0.
  const int vec_in = (W % 16 == 0) && ((uintptr_t)images % 16 == 0);
  const int vec_out = (W % 4 == 0) && ((uintptr_t)blur % 4 == 0) &&
                      ((uintptr_t)corner % 4 == 0) && ((uintptr_t)score % 16 == 0);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  frontend_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)images, (uint8_t*)blur, (uint8_t*)corner, (int32_t*)score, H, W,
      threshold, tpuslam::run_shifts(contiguous), vec_in, vec_out, taps);
  return (int)cudaGetLastError();
}
