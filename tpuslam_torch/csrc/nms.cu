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
// What bounds it on the H100: bytes by the count (1 read, 9 written a
// pixel), but what it spends is instruction slots: FAST must also run over the
// window's halo around every tile.  Design, one block of 512 threads per
// (frame, 64 x 96 output tile), two blocks an SM (110,608 B of dynamic
// shared memory each), R = window - 1:
//   0. the u8 image over tile +- 16 (>= R + 3) is staged with 16-byte
//      stores; a row that starts at any byte is read as the two aligned
//      16-byte units that cover each chunk, realigned with selects and funnel
//      shifts (byte loads only where the cover would leave the buffer);
//   1. FAST and the packed uint32 key over tile +- R, 4 keys a thread as
//      SWAR byte compares (fast.cuh, shared with kernel 1), the work items
//      dealt over the part of the region that lies inside the image's 3-px
//      interior, so a ragged last tile costs what it holds (1.68x the tile's
//      pixels at window 12, against 2.27x for 32 x 64).  Kernel 5 needs a
//      score only at corners, so the 4-pixel groups first take FAST's own
//      pretest (4 of the 16 ring pixels), the ones that can hold a corner
//      are listed in shared memory (a ballot and one atomic a warp), and the
//      16 ring compares run over the list alone: about an eighth of the
//      groups on the KITTI frames, all of them on noise, where the pretest
//      is what the kernel pays on top;
//   2. the window max, separably and by doubling, in O(log window) max a
//      pixel and axis instead of 2R + 1: the max of 8 neighbours (three
//      doubling steps in registers, from 16-byte loads), then at most four
//      taps of it 8 apart, the last pulled back so that the union is the
//      window exactly (three taps at window 12; windows 3 and 4 take two taps
//      of the 4-wide max, windows 1 and 2 skip the doubling); along x the
//      taps are conflict-free word loads, a pixel a thread, along y 16-byte
//      loads, 4 pixels a thread; two uint32 planes take turns.  A 16-wide
//      stage (two taps) needs a pass and a barrier more an axis and ran
//      slower: the passes are short, and what they cost is their barriers;
//   3. keep = key > 0 && key == max, with the tile's own keys kept in
//      registers since step 1; the blur from float rows as in kernel 1 (25
//      taps row-major, __fmul_rn/__fadd_rn, floor(acc + 0.5)); keys leave as
//      16-byte vectors, the blur as 4-byte words, wherever the address
//      allows, so a width that is not a multiple of 4 or 16 stays exact.
// Pixels beyond the image never reach a key or an interior blur (FAST reads
// 3 px, the blur 2, and both leave the border alone), so the staged bytes
// outside a row may hold the neighbouring row's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fast.cuh"

namespace {

using tpuslam::Taps;

constexpr int kThreads = 512;
constexpr int kTileH = 64;
constexpr int kTileW = 96;
constexpr int kFast = 3;                       // FAST circle radius
constexpr int kMaxR = 13;                      // window - 1 <= 13 (window <= 14)
constexpr int kPad = 16;                       // staged beyond the tile on every side
// Local (r, c) is global (y0 - kPad + r, x0 - kPad + c), in the image and in both planes.
constexpr int kRows = kTileH + 2 * kPad;       // 96 local rows
constexpr int kCols = kTileW + 2 * kPad;       // 128 local columns: one warp's 4-key groups
constexpr int kGroups = kCols / 4;
constexpr int kStrips = kTileW / 4;            // 4-pixel output strips a tile row
constexpr int kOwn = kTileH * kStrips / kThreads;  // output strips a thread
constexpr int kFront = 16;                     // bytes before the image, which a window may read
constexpr int kIdxBits = 20;
// step 1a's turns a thread: the most key groups a tile can hold, over the threads
constexpr int kRounds = ((kTileH + 2 * kMaxR) * kGroups + kThreads - 1) / kThreads;
constexpr size_t kSharedBytes = kFront + kRows * kCols + 2 * sizeof(uint32_t) * kRows * kCols;
static_assert(kTileH * kStrips % kThreads == 0, "every thread owns the same number of strips");
static_assert(kPad >= kMaxR + kFast && kCols == 128 && kPad % 16 == 0 && kTileW % 16 == 0, "layout");

__device__ __forceinline__ uint4 max4(uint4 a, uint4 b) {
  return make_uint4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
}

// dst[o] = max of the N rows src[o], src[o + kCols], ... as 16-byte vectors (N 1: a
// copy), for the n offsets o = at(i): the window max's doubling down the columns.
template <int N, typename At>
__device__ __forceinline__ void max_down(const uint32_t* __restrict__ src,
                                         uint32_t* __restrict__ dst, int tid, int n, At at) {
#pragma unroll 1
  for (int i = tid; i < n; i += kThreads) {
    const int o = at(i);
    uint4 row[N];
#pragma unroll
    for (int r = 0; r < N; ++r) row[r] = *reinterpret_cast<const uint4*>(src + o + r * kCols);
#pragma unroll
    for (int half = N / 2; half >= 1; half /= 2)
#pragma unroll
      for (int r = 0; r < half; ++r) row[r] = max4(row[r], row[r + half]);
    *reinterpret_cast<uint4*>(dst + o) = row[0];
  }
}

// dst[r][c] = max over NT taps of src[r][c - R + tap[t]], at the tile's columns of
// the key rows: a pixel a thread, so a warp's loads are consecutive words.
template <int NT>
__device__ __forceinline__ void max_along_x(const uint32_t* __restrict__ src,
                                            uint32_t* __restrict__ dst, int tid, int key_rows,
                                            int row_lo, int R, const int (&tap)[4]) {
#pragma unroll 4
  for (int i = tid; i < key_rows * kTileW; i += kThreads) {
    const int rr = i / kTileW;
    const int o = (row_lo + rr) * kCols + kPad + (i - rr * kTileW);
    const uint32_t* p = src + o - R;
    uint32_t m = p[tap[0]];
#pragma unroll
    for (int t = 1; t < NT; ++t) m = max(m, p[tap[t]]);
    dst[o] = m;
  }
}

// The 16 image bytes that start at address `a` (any alignment), from the two
// aligned 16-byte units that cover them; both lie inside the buffer.
__device__ __forceinline__ uint4 load16_any(uintptr_t a) {
  const uintptr_t a0 = a & ~(uintptr_t)15;
  const uint4 lo = *reinterpret_cast<const uint4*>(a0);
  if (a == a0) return lo;
  const uint4 hi = *reinterpret_cast<const uint4*>(a0 + 16);
  uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int word = (int)(a & 15) >> 2;
#pragma unroll
  for (int i = 0; i < 6; ++i) v[i] = (word & 2) ? v[i + 2] : v[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) v[i] = (word & 1) ? v[i + 1] : v[i];
  const int shift = 8 * (int)(a & 3);
  return make_uint4(__funnelshift_r(v[0], v[1], shift), __funnelshift_r(v[1], v[2], shift),
                    __funnelshift_r(v[2], v[3], shift), __funnelshift_r(v[3], v[4], shift));
}

__global__ void __launch_bounds__(kThreads, 2)
frontend_nms_kernel(const uint8_t* __restrict__ images, uint8_t* __restrict__ blur,
                    int64_t* __restrict__ key_out, int H, int W, size_t image_bytes,
                    int threshold, tpuslam::RunShifts runs, int window, int idx_shift, Taps taps) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* img = smem + kFront;                                        // [kRows][kCols] u8
  uint32_t* plane_a = reinterpret_cast<uint32_t*>(img + kRows * kCols);  // [kRows][kCols]
  uint32_t* plane_b = plane_a + kRows * kCols;                         // [kRows][kCols]
  int* n_listed = reinterpret_cast<int*>(smem);  // in the bytes before the image
  uint32_t* list = plane_b;                      // step 1's work list; the plane is free until step 2

  const int tid = threadIdx.x;
  const int R = window - 1;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = (size_t)H * W;
  const uint8_t* src = images + (size_t)b * plane;

  // 0. zero the key plane; stage image rows 16 - (R + 3) .. 16 + kTileH + R + 3.
  if (tid == 0) *n_listed = 0;
  for (int i = tid; i < kRows * kGroups; i += kThreads)
    reinterpret_cast<uint4*>(plane_a)[i] = make_uint4(0, 0, 0, 0);
  const int stage_lo = kPad - R - kFast;
  const int stage_n = kTileH + 2 * (R + kFast);
#pragma unroll 2
  for (int i = tid; i < stage_n * (kCols / 16); i += kThreads) {
    const int ly = stage_lo + (i >> 3);
    const int lc = (i & 7) * 16;
    const int gy = y0 - kPad + ly;
    const int gx = x0 - kPad + lc;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H && gx + 16 > 0 && gx < W) {
      const uint8_t* row = src + (size_t)gy * W;
      const uintptr_t a = (uintptr_t)row + (intptr_t)gx;
      const uintptr_t a0 = a & ~(uintptr_t)15;
      const uintptr_t first = (uintptr_t)images;
      if (a0 >= first && a0 + (a == a0 ? 16 : 32) <= first + image_bytes) {
        v = load16_any(a);
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
    *reinterpret_cast<uint4*>(img + ly * kCols + lc) = v;
  }
  __syncthreads();

  // 1. packed keys, 4 a work item (a row's 4-column group), over the local rows
  //    and columns that lie both within R of the tile and inside the image's
  //    3-px interior.  1a lists the groups where some pixel passes FAST's
  //    pretest (5 words and 8 byte compares a group); 1b runs the rings of the
  //    listed groups alone, on full warps.  The list's order varies from run to
  //    run, the keys do not: each group writes its own.
  const int c_lo = max(kPad - R, kPad + kFast - x0);
  const int c_hi = min(kPad + kTileW + R, kPad + W - kFast - x0);
  const uint32_t t4 = (uint32_t)threshold * 0x01010101u;
  {
    const int r_lo = max(kPad - R, kPad + kFast - y0);
    const int nr = min(kPad + kTileH + R, kPad + H - kFast - y0) - r_lo;
    const int g_lo = c_lo >> 2;
    const int ng = ((c_hi + 3) >> 2) - g_lo;
    if (ng > 0 && nr > 0) {
      // item i is (row i / ng, group i % ng): stepped, so one divide a thread
      const int step_r = kThreads / ng;
      const int step_g = kThreads - step_r * ng;
      int r = tid / ng;
      int g = tid - r * ng;
      // every thread takes kRounds turns, so the ballots are full warps'; unrolled, the
      // turns' loads overlap, and a warp adds its whole count to the list's length once
      uint32_t votes[kRounds], code[kRounds];
      int n_mine = 0;
#pragma unroll
      for (int round = 0; round < kRounds; ++round) {
        bool listed = false;
        code[round] = (uint32_t)((r_lo + r) << 8 | (g_lo + g));
        if (r < nr) {
          const uint8_t* p = img + (r_lo + r) * kCols + 4 * (g_lo + g);
          const uint32_t* mp = reinterpret_cast<const uint32_t*>(p - 4);
          const uint32_t mid[3] = {mp[0], mp[1], mp[2]};
          listed = tpuslam::fast4_pretest(*reinterpret_cast<const uint32_t*>(p - kFast * kCols), mid,
                                          *reinterpret_cast<const uint32_t*>(p + kFast * kCols), t4);
        }
        votes[round] = __ballot_sync(0xFFFFFFFFu, listed);
        n_mine += __popc(votes[round]);
        r += step_r;
        g += step_g;
        if (g >= ng) {
          g -= ng;
          ++r;
        }
      }
      const int lane = tid & 31;
      int at = 0;
      if (lane == 0 && n_mine) at = atomicAdd(n_listed, n_mine);
      at = __shfl_sync(0xFFFFFFFFu, at, 0);
#pragma unroll
      for (int round = 0; round < kRounds; ++round) {
        if ((votes[round] >> lane) & 1u)
          list[at + __popc(votes[round] & ((1u << lane) - 1u))] = code[round];
        at += __popc(votes[round]);
      }
    }
  }
  __syncthreads();
  {
    const uint32_t last = (uint32_t)H * (uint32_t)W - 1u;
    const int n = *n_listed;
    for (int i = tid; i < n; i += kThreads) {
      const int lr = (int)(list[i] >> 8);
      const int lg = (int)(list[i] & 255u);
      uint32_t win[7][3];
#pragma unroll
      for (int w = 0; w < 7; ++w) {
        const uint32_t* p =
            reinterpret_cast<const uint32_t*>(img + (lr - kFast + w) * kCols + 4 * lg - 4);
        win[w][0] = p[0];
        win[w][1] = p[1];
        win[w][2] = p[2];
      }
      const tpuslam::Ring4 ring = tpuslam::fast4_ring(win, t4);
      const uint32_t idx0 =
          (uint32_t)(y0 - kPad + lr) * (uint32_t)W + (uint32_t)(x0 - kPad + 4 * lg);
      uint32_t k[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * lg + j;
        const bool in = tpuslam::fast4_corner(ring, j, runs) && c >= c_lo && c < c_hi;
        k[j] = in ? ((uint32_t)tpuslam::fast4_sad(ring, j) << kIdxBits) |
                        ((last - idx0 - j) >> idx_shift)
                  : 0u;
      }
      *reinterpret_cast<uint4*>(plane_a + lr * kCols + 4 * lg) = make_uint4(k[0], k[1], k[2], k[3]);
    }
  }
  __syncthreads();

  // 2. The window [i - R, i + R] as taps of `span`-wide maxima: at 0, span, 2 span, ...
  //    and a last one at 2R + 1 - span, so that their union is the window exactly.
  //    The span is 8 from window 5 on (at most four taps), 4 for windows 3 and 4
  //    (two taps), and 1 for windows 1 and 2, which skip the doubling.
  const int span = R >= 4 ? 8 : R >= 2 ? 4 : 1;
  const int last_tap = 2 * R + 1 - span;
  const bool two_taps = 2 * R + 1 <= 2 * span;
  int tap[4] = {0, last_tap, min(span, last_tap), min(2 * span, last_tap)};
  const int key_rows = kTileH + 2 * R;           // local rows 16 - R .. 16 + kTileH + R
  const int row_lo = kPad - R;

  // 2a. plane_b[r][c] = max plane_a[r][c .. c + span - 1], doubling in registers;
  //     the tile's own keys go to registers.
  {
    const uint32_t* __restrict__ src = plane_a;
    uint32_t* __restrict__ dst = plane_b;
#pragma unroll 2
    for (int i = tid; i < key_rows * kGroups; i += kThreads) {
      const int o = (row_lo + (i >> 5)) * kCols + 4 * (i & 31);
      const uint4 u = *reinterpret_cast<const uint4*>(src + o);
      uint4 m = u;
      if (span > 1) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + o + 4);
        const uint32_t k[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
        uint32_t two[10], four[8];
#pragma unroll
        for (int j = 0; j < 6; ++j) two[j] = max(k[j], k[j + 1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) four[j] = max(two[j], two[j + 2]);
        m = make_uint4(four[0], four[1], four[2], four[3]);
        if (span == 8) {
          const uint4 w = *reinterpret_cast<const uint4*>(src + o + 8);
          const uint32_t k8[4] = {v.w, w.x, w.y, w.z};
          two[6] = max(k[6], k[7]);
#pragma unroll
          for (int j = 0; j < 3; ++j) two[7 + j] = max(k8[j], k8[j + 1]);
#pragma unroll
          for (int j = 4; j < 8; ++j) four[j] = max(two[j], two[j + 2]);
          m = make_uint4(max(four[0], four[4]), max(four[1], four[5]), max(four[2], four[6]),
                         max(four[3], four[7]));
        }
      }
      *reinterpret_cast<uint4*>(dst + o) = m;
    }
  }
  uint4 own[kOwn];
#pragma unroll
  for (int n = 0; n < kOwn; ++n) {
    const int s = tid + n * kThreads;
    const int ty = s / kStrips;
    const int q = s - ty * kStrips;
    own[n] = *reinterpret_cast<const uint4*>(plane_a + (kPad + ty) * kCols + kPad + 4 * q);
  }
  __syncthreads();

  // 2b. max along x into plane_a, at the tile's columns of every key row: a pixel a thread.
  if (two_taps) {
    max_along_x<2>(plane_b, plane_a, tid, key_rows, row_lo, R, tap);
  } else {
    max_along_x<4>(plane_b, plane_a, tid, key_rows, row_lo, R, tap);
  }
  __syncthreads();

  // 2c. the same doubling down the columns: plane_b[r][c] = max plane_a[r .. r + span - 1][c].
  const auto strip_at = [&](int i) {
    const int rr = i / kStrips;
    return (row_lo + rr) * kCols + kPad + 4 * (i - rr * kStrips);
  };
  if (span == 8) {
    max_down<8>(plane_a, plane_b, tid, (key_rows - 7) * kStrips, strip_at);
  } else if (span == 4) {
    max_down<4>(plane_a, plane_b, tid, (key_rows - 3) * kStrips, strip_at);
  } else {
    max_down<1>(plane_a, plane_b, tid, key_rows * kStrips, strip_at);
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < 4; ++t) tap[t] *= kCols;

  // 3. max along y, the keep test and the blur, a 4-pixel strip at a time.
#pragma unroll
  for (int n = 0; n < kOwn; ++n) {
    const int s = tid + n * kThreads;
    const int ty = s / kStrips;
    const int q = s - ty * kStrips;
    const int y = y0 + ty;
    const int xs = x0 + 4 * q;
    if (y >= H || xs >= W) continue;
    const uint4 k = own[n];
    uint4 m = make_uint4(0, 0, 0, 0);
    if (k.x | k.y | k.z | k.w) {  // only a corner asks for its window's max
      const uint32_t* p = plane_b + (row_lo + ty) * kCols + kPad + 4 * q;
      m = max4(*reinterpret_cast<const uint4*>(p), *reinterpret_cast<const uint4*>(p + tap[1]));
      if (!two_taps)
        m = max4(m, max4(*reinterpret_cast<const uint4*>(p + tap[2]),
                         *reinterpret_cast<const uint4*>(p + tap[3])));
    }
    const int64_t keep[4] = {(k.x > 0 && k.x == m.x) ? (int64_t)k.x : 0,
                             (k.y > 0 && k.y == m.y) ? (int64_t)k.y : 0,
                             (k.z > 0 && k.z == m.z) ? (int64_t)k.z : 0,
                             (k.w > 0 && k.w == m.w) ? (int64_t)k.w : 0};

    // the strip's five window rows, bytes x - 4 .. x + 7 each, as floats x - 2 .. x + 5
    float fr[5][8];
    uint32_t c4 = 0;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const uint32_t* wp =
          reinterpret_cast<const uint32_t*>(img + (kPad + ty - 2 + i) * kCols + kPad + 4 * q - 4);
      const uint32_t w[3] = {wp[0], wp[1], wp[2]};
      if (i == 2) c4 = w[1];
#pragma unroll
      for (int f = 0; f < 8; ++f) fr[i][f] = tpuslam::byte_f(w, f + 2);
    }
    const bool row_blur = y >= 2 && y < H - 2;
    uint32_t blur4 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = xs + j;
      const uint32_t blurred = tpuslam::blur5x5_rows(taps, fr, j);
      const uint32_t bl = row_blur & (x >= 2) & (x < W - 2) ? blurred : (c4 >> (8 * j)) & 0xFFu;
      blur4 |= bl << (8 * j);
    }

    const size_t o = (size_t)b * plane + (size_t)y * W + xs;
    int64_t* kp = key_out + o;
    uint8_t* bp = blur + o;
    if (xs + 3 < W) {
      if (((uintptr_t)kp & 15) == 0) {
        reinterpret_cast<longlong2*>(kp)[0] = make_longlong2(keep[0], keep[1]);
        reinterpret_cast<longlong2*>(kp)[1] = make_longlong2(keep[2], keep[3]);
      } else {  // 8-byte aligned only: the middle pair is 16-byte aligned
        kp[0] = keep[0];
        *reinterpret_cast<longlong2*>(kp + 1) = make_longlong2(keep[1], keep[2]);
        kp[3] = keep[3];
      }
      if (((uintptr_t)bp & 3) == 0) {
        *reinterpret_cast<uint32_t*>(bp) = blur4;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) bp[j] = (uint8_t)(blur4 >> (8 * j));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (xs + j >= W) break;
        kp[j] = keep[j];
        bp[j] = (uint8_t)(blur4 >> (8 * j));
      }
    }
  }
}

}  // namespace

extern "C" int tpuslam_frontend_nms(const void* images, void* blur, void* key, int B, int H,
                                    int W, int threshold, int contiguous, int window,
                                    int idx_shift, const float* taps_host, void* stream) {
  if (window < 1 || window - 1 > kMaxR || threshold < 0 || threshold > 255 || contiguous < 1 ||
      contiguous > 16 || (uintptr_t)key % 8 != 0)
    return (int)cudaErrorInvalidValue;
  // above the 48 KB a kernel gets unasked; per device, so set on every call
  cudaError_t err = cudaFuncSetAttribute(
      frontend_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSharedBytes);
  if (err != cudaSuccess) return (int)err;
  Taps taps;
  for (int i = 0; i < 25; ++i) taps.k[i] = taps_host[i];
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  frontend_nms_kernel<<<grid, kThreads, kSharedBytes, (cudaStream_t)stream>>>(
      (const uint8_t*)images, (uint8_t*)blur, (int64_t*)key, H, W, (size_t)B * H * W, threshold,
      tpuslam::run_shifts(contiguous), window, idx_shift, taps);
  return (int)cudaGetLastError();
}
