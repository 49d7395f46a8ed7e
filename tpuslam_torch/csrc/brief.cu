// Kernels 2 and 3: BRIEF patch extraction and own-orientation-bin dots.
//
// Kernel 2 replaces tpuslam/kernels/brief_pallas.py::extract_patches_pallas
// (_extract_kernel; wrapper extract_brief_patches_tpu).  Plain twin:
// tpuslam_torch/frontend/brief.py::extract_brief_patches_i8.
//   Bound on the H100: bytes — it is a gather that moves K*S2p bytes per
//   frame (37.7 MB per 16-frame chunk at K=1024, S2p=2304) and computes
//   nothing; the 11.4 MB of image sit in L2 right after kernel 1 wrote them.
//   Moved one byte a thread at a time, the count of loads and stores is
//   the limit, not the bytes.
//   Design: a thread owns one aligned unit of the output — 16 bytes, or 8
//   where the patch side is 8 mod 16 — which never straddles a patch row
//   (the side is a multiple of 8, S2p of 128), and writes it with one vector
//   store.  Its row and column in the patch are worked out once: a block has
//   one thread per unit of a patch and walks a run of consecutive keypoints,
//   sized so that the whole grid is resident at once.  The source row starts
//   at any byte (x - half), so the thread reads the two aligned units that
//   cover it with two vector loads, picks its words with selects, shifts
//   them together (__funnelshift_r) and subtracts 128 from four pixels at a
//   time (word ^ 0x80808080).  A unit that touches a border, or whose aligned
//   cover would leave the image buffer, goes byte by byte: a pixel outside
//   the image is 0, so its byte is 0x80.  Units past side^2 are zeros.
//   Neighbouring patches' rows overlap, and L1/L2 absorb the re-reads.
//
// Kernel 3 replaces tpuslam/kernels/brief_pallas.py::brief_own_bin_dots
// (_own_bin_kernel).  Plain twin: tpuslam_torch/frontend/brief.py::
// own_bin_dots_grouped.  out[b, k, :] = patches[b, k, :] . W[bin[b, k]], int32,
// exact; keypoints whose bin is outside [0, bins) get zero rows.
//   Bound on the H100 at the main path's shapes (16 x 1024 keypoints, S2p
//   2304, 256 pairs, 16 bins): bytes — patches 37.7 MB + W 9.4 MB + output
//   16.8 MB = 19.1 us at 3.35 TB/s, against 19.3 G int8 operations = 9.8 us
//   at 1,979 TOP/s.
//   Design: group by bin, then an int8 tensor-core product, in two passes.
//   Pass 1 (a block per frame) lists the chunk's B*K keypoint rows grouped
//   by bin — across all frames of the chunk — with every out-of-range bin as
//   one more group.  Pass 2 gives each (64-row slab of a group, 128 pairs) a
//   block of 4 warps: the block gathers its patch rows and streams its half
//   of W[bin] once, so a chunk streams each W[bin] ~17 times (~0.24 GB of
//   L2 traffic with the patch rows) where one block per keypoint streamed
//   it 1,024 times (9.66 GB).  ~550 such blocks fit the 132 SMs in one wave
//   at five an SM however the keypoints spread over the bins (the main
//   path's invalid keypoints all have angle 0 and crowd bin 0).  W comes in the
//   (bins, P, S2p) layout built once at detector init, in 64-byte k chunks
//   through a double-buffered cp.async pipeline (80-byte smem rows: the
//   fragment loads hit 32 distinct banks), into
//   mma.sync.m16n8k32.s32.s8.s8.s32 with int32 accumulators (|sum| <=
//   2304 * 128 * 2 < 2^31: exact); each warp holds a 32 x 64 tile.  Slabs
//   are padded with a repeated row that is never stored; the out-of-range
//   group's blocks write zero rows.  mma.sync rather than wgmma + TMA: the A
//   tile is a gather of scattered patch rows, which TMA's box copies do not
//   do, and the bound is bytes, not the tensor-core rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlab = 64;                  // keypoints of one bin per slab (M)
constexpr int kNTile = 128;                // pairs per block (N)
constexpr int kKChunk = 64;                // bytes of S2p per pipeline stage
constexpr int kRowPad = kKChunk + 16;      // shared-memory row stride in bytes
constexpr int kStages = 2;                 // cp.async pipeline depth
constexpr int kDotWarps = 4;               // 2 (M) x 2 (N) warps of 32 x 64
constexpr int kDotThreads = 32 * kDotWarps;
constexpr int kSortThreads = 1024;
constexpr int kMaxBins = 128;

// The U = 4 NW bytes of row gy of a frame from column gx on, each minus 128,
// as NW little-endian words; a pixel outside the frame counts as 0.
template <int NW>
__device__ __forceinline__ void gather_unit(const uint8_t* __restrict__ blurred,
                                            size_t image_bytes, int frame, int gy, int gx,
                                            int H, int W, uint32_t (&w)[NW]) {
  constexpr int U = 4 * NW;
  const bool row_in = gy >= 0 && gy < H;
  const uint8_t* row = blurred + ((size_t)frame * H + gy) * W;  // read only if row_in
  const uintptr_t a = (uintptr_t)(row + gx);
  const uintptr_t a0 = a & ~(uintptr_t)(U - 1);
  const uintptr_t first = (uintptr_t)blurred;
  if (row_in && gx >= 0 && gx + U <= W && a0 >= first && a0 + 2 * U <= first + image_bytes) {
    // inside: the two aligned units that cover the U bytes from a
    uint32_t v[2 * NW + 1];
    if (NW == 4) {
      const uint4 lo = reinterpret_cast<const uint4*>(a0)[0];
      const uint4 hi = reinterpret_cast<const uint4*>(a0)[1];
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    } else {
      const uint2 lo = reinterpret_cast<const uint2*>(a0)[0];
      const uint2 hi = reinterpret_cast<const uint2*>(a0)[1];
      v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
    }
    v[2 * NW] = 0;
    // bring word (a - a0) / 4 to the front: a conditional move by 2 words, then by 1
    const int word = (int)(a - a0) >> 2;
    if (NW == 4) {
#pragma unroll
      for (int i = 0; i + 2 <= 2 * NW; ++i) v[i] = (word & 2) ? v[i + 2] : v[i];
    }
#pragma unroll
    for (int i = 0; i + 1 <= 2 * NW; ++i) v[i] = (word & 1) ? v[i + 1] : v[i];
    const int shift = 8 * (int)(a & 3);
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = __funnelshift_r(v[i], v[i + 1], shift) ^ 0x80808080u;
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      w[i] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = gx + 4 * i + j;
        const uint32_t px = (row_in && x >= 0 && x < W) ? row[x] : 0;
        w[i] |= (px ^ 0x80u) << (8 * j);
      }
    }
  }
}

// A thread per U-byte unit of a patch (a patch of more than 1024 units gives
// a thread several); the block walks keypoints blockIdx.x * per_block ... of
// the B * K.  units_per_row = side / U.
template <int NW>
__global__ void extract_kernel(const uint8_t* __restrict__ blurred,
                               const float* __restrict__ kps_xy, int8_t* __restrict__ out,
                               int H, int W, int K, int n_kp, int per_block, int side,
                               int half, int s2p, int units_per_row, size_t image_bytes) {
  constexpr int U = 4 * NW;
  const int kp0 = blockIdx.x * per_block;
  const int kp1 = min(kp0 + per_block, n_kp);
  for (int u = threadIdx.x; u * U < s2p; u += blockDim.x) {
    const int r = u / units_per_row;  // at or past side: the zero tail after side * side
    const int c0 = (u - r * units_per_row) * U;
    float2 xy = make_float2(kps_xy[2 * kp0], kps_xy[2 * kp0 + 1]);
    for (int kp = kp0; kp < kp1; ++kp) {
      const float2 cur = xy;  // the next keypoint is on its way while this one is copied
      if (kp + 1 < kp1) xy = make_float2(kps_xy[2 * kp + 2], kps_xy[2 * kp + 3]);
      uint32_t w[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) w[i] = 0;
      if (r < side) {
        // float -> int truncates toward zero, then clip (brief_pallas.py:133-134).
        const int xi = min(max((int)cur.x, 0), W - 1);
        const int yi = min(max((int)cur.y, 0), H - 1);
        gather_unit<NW>(blurred, image_bytes, kp / K, yi - half + r, xi - half + c0, H, W, w);
      }
      int8_t* dst = out + (size_t)kp * s2p + (size_t)u * U;
      if (NW == 4)
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    }
  }
}

// cp.async and mma.sync wrappers (sm_80+ PTX).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Pass 1, one block per frame: group the frame's keypoint rows by bin (bins
// in [0, bins), then every out-of-range bin as group `bins`).  Group j's
// rows go to order[j * n ...]: a shared-memory histogram, one global
// atomicAdd per group for the frame's place in it (group_size, zeroed by
// the caller, ends as each group's size), then each row takes the next slot.
// The order inside a group varies from run to run; the product does not
// depend on it (each row's dots are its own).
__global__ void __launch_bounds__(kSortThreads)
bin_sort_kernel(const int64_t* __restrict__ bin_idx, int K, int n, int bins,
                int32_t* __restrict__ order, int32_t* __restrict__ group_size) {
  __shared__ int count[kMaxBins + 1];
  const int groups = bins + 1;
  const int64_t* bins_b = bin_idx + (size_t)blockIdx.x * K;
  for (int j = threadIdx.x; j < groups; j += kSortThreads) count[j] = 0;
  __syncthreads();
  auto group_of = [&](int k) {
    const int64_t v = bins_b[k];
    return v >= 0 && v < bins ? (int)v : bins;
  };
  for (int k = threadIdx.x; k < K; k += kSortThreads) atomicAdd(&count[group_of(k)], 1);
  __syncthreads();
  for (int j = threadIdx.x; j < groups; j += kSortThreads)
    count[j] = count[j] ? atomicAdd(&group_size[j], count[j]) : 0;  // now: the frame's cursor
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kSortThreads) {
    const int g = group_of(k);
    order[(size_t)g * n + atomicAdd(&count[g], 1)] = blockIdx.x * K + k;
  }
}

// Pass 2: one block per (64-row slab of one group, 256 pairs); blocks past
// the last slab exit.
__global__ void __launch_bounds__(kDotThreads)
own_bin_kernel(const int8_t* __restrict__ patches, const int32_t* __restrict__ order,
               const int32_t* __restrict__ group_size, const int8_t* __restrict__ wt,
               int32_t* __restrict__ out, int n, int s2p, int P, int bins) {
  __shared__ __align__(16) int8_t a_s[kStages][kSlab][kRowPad];
  __shared__ __align__(16) int8_t b_s[kStages][kNTile][kRowPad];
  __shared__ int rows[kSlab];
  __shared__ int slab_of[3];  // group, first row in order, row count

  const int tid = threadIdx.x;
  if (tid == 0) {
    int first = -1, j = 0, count = 0;
    for (int acc = 0; j <= bins; ++j) {
      const int size = group_size[j];
      const int slabs = (size + kSlab - 1) / kSlab;
      if ((int)blockIdx.x < acc + slabs) {
        const int s = blockIdx.x - acc;
        first = j * n + s * kSlab;
        count = min(size - s * kSlab, kSlab);
        break;
      }
      acc += slabs;
    }
    slab_of[0] = j;
    slab_of[1] = first;
    slab_of[2] = count;
  }
  __syncthreads();
  const int bin = slab_of[0];
  const int count = slab_of[2];
  if (count <= 0) return;  // past the last slab
  if (tid < count) rows[tid] = order[slab_of[1] + tid];
  __syncthreads();

  const int n0 = blockIdx.y * kNTile;
  if (bin == bins) {  // keypoints whose bin is out of range: zero rows
    for (int i = tid; i < count * (kNTile / 4); i += kDotThreads) {
      const int r = i / (kNTile / 4);
      const int c = i - r * (kNTile / 4);
      reinterpret_cast<int4*>(out + (size_t)rows[r] * P + n0)[c] = make_int4(0, 0, 0, 0);
    }
    return;
  }

  // A = the slab's patch rows (padded with its first row), B = W[bin]^T.
  const int8_t* b_src = wt + ((size_t)bin * P + n0) * s2p;
  const int nk = s2p / kKChunk;
  auto load = [&](int kc) {
    const int stage = kc % kStages;
    const int k0 = kc * kKChunk;
    for (int i = tid; i < kSlab * (kKChunk / 16); i += kDotThreads) {
      const int r = i / (kKChunk / 16);
      const int c = (i - r * (kKChunk / 16)) * 16;
      cp_async16(&a_s[stage][r][c], patches + (size_t)rows[r < count ? r : 0] * s2p + k0 + c);
    }
    for (int i = tid; i < kNTile * (kKChunk / 16); i += kDotThreads) {
      const int r = i / (kKChunk / 16);
      const int c = (i - r * (kKChunk / 16)) * 16;
      cp_async16(&b_s[stage][r][c], b_src + (size_t)r * s2p + k0 + c);
    }
  };

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp / (kDotWarps / 2)) * 32;  // the warp's 32 x 64 tile
  const int wn = (warp % (kDotWarps / 2)) * 64;
  const int g = lane >> 2;
  const int t4 = (lane & 3) * 4;
  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

#pragma unroll
  for (int kc = 0; kc < kStages - 1; ++kc) {
    if (kc < nk) load(kc);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();  // chunk kc has landed
    __syncthreads();               // ... for every thread, and the stage of chunk kc - 1 is free
    if (kc + kStages - 1 < nk) load(kc + kStages - 1);
    cp_async_commit();
    const int st = kc % kStages;
#pragma unroll
    for (int ks = 0; ks < kKChunk; ks += 32) {
      uint32_t af[2][4], bf[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* r0 = &a_s[st][wm + mt * 16 + g][ks + t4];
        const int8_t* r8 = &a_s[st][wm + mt * 16 + g + 8][ks + t4];
        af[mt][0] = lds32(r0);
        af[mt][1] = lds32(r8);
        af[mt][2] = lds32(r0 + 16);
        af[mt][3] = lds32(r8 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* rn = &b_s[st][wn + nt * 8 + g][ks + t4];
        bf[nt][0] = lds32(rn);
        bf[nt][1] = lds32(rn + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

  // Row r of the slab: c0, c1 at (g, 2t..2t+1), c2, c3 at (g + 8, 2t..2t+1).
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm + mt * 16 + g + half * 8;
      if (r >= count) continue;
      int32_t* dst = out + (size_t)rows[r] * P + n0 + wn + t4 / 2;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<int2*>(dst + nt * 8) =
            make_int2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
  }
}

}  // namespace

extern "C" int tpuslam_extract_patches(const void* blurred, const void* kps_xy, void* out,
                                       int B, int H, int W, int K, int side, int half,
                                       int s2p, void* stream) {
  // a unit must not straddle a patch row or the end of a patch, and is stored aligned
  const int unit = side % 16 == 0 ? 16 : 8;
  if (side % 8 || s2p % unit || s2p < side * side || (uintptr_t)out % unit)
    return (int)cudaErrorInvalidValue;
  const int threads = min((s2p / unit + 31) / 32 * 32, 1024);
  auto kernel = unit == 16 ? extract_kernel<4> : extract_kernel<2>;
  int device = 0, sms = 0, blocks_per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  // as few keypoints a block as keep every block resident at once
  const int n_kp = B * K;
  const int resident = sms * blocks_per_sm;
  const int per_block = (n_kp + resident - 1) / resident;
  const int blocks = (n_kp + per_block - 1) / per_block;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blurred, (const float*)kps_xy, (int8_t*)out, H, W, K, n_kp, per_block, side,
      half, s2p, side / unit, (size_t)B * H * W);
  return (int)cudaGetLastError();
}

extern "C" int tpuslam_own_bin_dots(const void* patches, const void* bin_idx,
                                    const void* wt, void* out, void* order, void* group_size,
                                    int B, int K, int s2p, int P, int bins, void* stream) {
  if (s2p % kKChunk || P % kNTile || bins < 1 || bins > kMaxBins)
    return (int)cudaErrorInvalidValue;
  const int n = B * K;
  bin_sort_kernel<<<B, kSortThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)bin_idx, K, n, bins, (int32_t*)order, (int32_t*)group_size);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // sum over groups of ceil(size / 64) <= n / 64 + groups
  dim3 grid(n / kSlab + bins + 1, P / kNTile);
  own_bin_kernel<<<grid, kDotThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)patches, (const int32_t*)order, (const int32_t*)group_size,
      (const int8_t*)wt, (int32_t*)out, n, s2p, P, bins);
  return (int)cudaGetLastError();
}
