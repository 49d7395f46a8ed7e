// Stencils shared by kernel 1 (frontend.cu) and kernel 5 (nms.cu): the
// FAST-12 segment test with its SAD score, four pixels at once in the bytes
// of a word (fast4_ring, fast4_corner, fast4_sad), and the 5x5 Gaussian blur.
//
// Semantics are those of the plain twins (tpuslam_torch/frontend/fast.py::
// fast_response_and_mask, tpuslam_torch/frontend/brief.py::gaussian_blur_u8),
// bit for bit.  FAST works on two 16-bit masks, bit i set where circle pixel
// i is brighter than centre + threshold (resp. darker than centre -
// threshold), each doubled to 32 bits: the "{0,8} and >= 3 of {0,4,8,12}"
// pretest counts four bits, and the segment test looks for a cyclic run of
// `contiguous` set bits with four shift-ANDs — what the twin's wrap-around
// run counters over 15 + contiguous circle steps find, without their
// serial steps.  Both kernels reach it through fast4_ring and fast4_corner.
// The blur adds its 25 taps in row-major order with explicit
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

// FAST over 4 horizontally adjacent pixels of row y at once.  `rows` are the
// 7 image rows y-3 .. y+3, each as the 12 bytes of columns x-4 .. x+7 in
// three words held in registers: the pixels are bytes 4..7 of rows[3].  `t4`
// is the threshold in every byte.  fast4_ring makes the 16 ring compares:
// circle pixel i of the 4 pixels is one funnel shift; the bright and dark
// compares against the saturated centre +- threshold are SWAR byte compares
// whose results go into per-byte 16-bit masks (the bit shifts done as
// __umulhi, on the multiplier's pipe); the SADs add up through __vabsdiffu4
// in 16-bit lanes.  fast4_corner is pixel j's decision (a byte permute and
// fast_decide), fast4_sad its score.
struct Ring4 {
  uint32_t bright_lo, bright_hi, dark_lo, dark_hi, sad_even, sad_odd;
};

__device__ __forceinline__ Ring4 fast4_ring(const uint32_t (*rows)[3], uint32_t t4) {
  const uint32_t c4 = rows[3][1];
  const uint32_t hi4 = __vaddus4(c4, t4);  // saturated: nothing is brighter than 255
  const uint32_t lo4 = __vsubus4(c4, t4);  // nor darker than 0
  uint32_t bright_lo = 0, bright_hi = 0, dark_lo = 0, dark_hi = 0;
  uint32_t sad_even = 0, sad_odd = 0;      // pixels 0, 2 and 1, 3 in 16-bit lanes
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    int dx, dy;
    circle(k, &dx, &dy);
    const uint32_t nb = bytes_at(rows[3 + dy], 4 + dx);
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
  return Ring4{bright_lo, bright_hi, dark_lo, dark_hi, sad_even, sad_odd};
}

// Whether pixel j (0..3) of the ring's strip is a FAST corner.
__device__ __forceinline__ bool fast4_corner(const Ring4& r, int j, const RunShifts& runs) {
  // bytes (lo_j, hi_j, lo_j, hi_j): the pixel's 16-bit mask doubled to 32 bits
  const uint32_t sel = j | ((j + 4) << 4) | (j << 8) | ((j + 4) << 12);
  return fast_decide(__byte_perm(r.bright_lo, r.bright_hi, sel),
                     __byte_perm(r.dark_lo, r.dark_hi, sel), runs);
}

// Pixel j's 16-neighbour SAD.
__device__ __forceinline__ int fast4_sad(const Ring4& r, int j) {
  const uint32_t s = (j & 1) ? r.sad_odd : r.sad_even;
  return (int)((j & 2) ? s >> 16 : s & 0xFFFFu);
}

// Whether any of 4 adjacent pixels can pass fast_decide's pretest (>= 3 of
// circle pixels {0, 4, 8, 12} brighter, or >= 3 darker): `up` and `down` are
// the 4 pixels' neighbours 3 rows above and below, `mid` their own row's
// 12-byte window.  A strip that fails holds no corner, whatever the rest of
// its rings: a caller that needs no score there can skip fast4_ring.
__device__ __forceinline__ bool fast4_pretest(uint32_t up, const uint32_t (&mid)[3],
                                              uint32_t down, uint32_t t4) {
  const uint32_t c4 = mid[1];
  const uint32_t hi4 = __vaddus4(c4, t4);
  const uint32_t lo4 = __vsubus4(c4, t4);
  const uint32_t right = bytes_at(mid, 7), left = bytes_at(mid, 1);
  // per byte, the msb clear where the neighbour is brighter (resp. darker)
  const uint32_t b0 = ge_u8x4(hi4, up), b4 = ge_u8x4(hi4, right);
  const uint32_t b8 = ge_u8x4(hi4, down), b12 = ge_u8x4(hi4, left);
  const uint32_t d0 = ge_u8x4(up, lo4), d4 = ge_u8x4(right, lo4);
  const uint32_t d8 = ge_u8x4(down, lo4), d12 = ge_u8x4(left, lo4);
  // "not >= 3 of 4" is ">= 2 of 4 clear bits set": (a & b) | ((a | b) & (c | d)) | (c & d)
  const uint32_t few_bright = (b0 & b4) | ((b0 | b4) & (b8 | b12)) | (b8 & b12);
  const uint32_t few_dark = (d0 & d4) | ((d0 | d4) & (d8 | d12)) | (d8 & d12);
  return ((few_bright & few_dark) & kMsb) != kMsb;
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

// 5x5 blur of pixel j (0..3) of a strip whose five window rows are held as
// floats: fr[r][q] is row y - 2 + r, column x - 2 + q of the strip's first pixel x.
__device__ __forceinline__ uint32_t blur5x5_rows(const Taps& taps, const float (&fr)[5][8], int j) {
  return blur5x5_at(taps, [&](int dy, int dx) { return fr[dy + 2][j + 2 + dx]; });
}

}  // namespace tpuslam
