// Kernel 6: the batched Jacobi nullvector.
//
// Replaces no Pallas kernel: the JAX package leaves nullvec_jacobi
// (tpuslam/common/geometry.py) to XLA, which runs the whole fori_loop of one
// jitted call on the device.  On the card the eager port launched ~50
// operations a round of column pairs (index_select / index_copy_ over the
// whole rows tensor, sums and the rotation algebra): ~9,700 launches and
// ~221 device ms of a VO step of 32 x 16 frames on one H100.  Here one launch does every
// sweep, the column norms, the argmin and the store of the chosen column of V.
// Plain twin: tpuslam_torch/common/geometry.py::nullvec_jacobi_twin.
//
// out[b] = V[:, argmin_j |A_j|] after `sweeps` sweeps of one-sided Jacobi on
// A[b] (m x n, row-major): each round of _round_robin_schedule(n) rotates its
// disjoint column pairs (p, q) of A and V by the Givens rotation that zeroes
// (A^T A)[p, q], with the twin's formulas and its two eps guards; float32
// only, no convergence exit, ties of the argmin to the lowest index and NaN
// first, as torch.argmin.
//
// The twin's bits, not only its answer.  The benchmark's plain reference runs
// the twin's eager operations on the card, and a nullvector that moves by a
// rounding moves the LO refits' inlier weights and so the pose, by up to
// ~0.05 deg where the check allows 5e-3.  So every operation rounds as the
// twin's does: each product and sum of the rotation on its own (__fmul_rn,
// __fadd_rn, IEEE divides and square roots), and each column sum (app, aqq,
// apq, and vector_norm's) is added in the order torch's CUDA reduce kernel
// adds it (ATen/native/cuda/Reduce.cuh): a thread's four accumulators taking
// every step-th term in turn, then block_y_reduce's tree over `by` threads,
// then global_reduce over `ctas` blocks, with by and ctas worked out by the
// wrapper from the shape and the card as setReduceConfig does
// (kernels/jacobi.py::reduce_tree).  No atomics: two runs give the same bits.
//
// What bounds it on the H100: float32 operations.  A pair costs 12 m for
// its three sums and the rotation of A's two columns, 6 n for V's and 16 for
// the angle; at the cells' shapes that is 9.5 G operations (141 us at
// 67 TFLOP/s) for the 8-point hypotheses, (512, 1024, 8, 9) at 3 sweeps, and
// 4.6 G (68 us) for each of LO's three refits, (512, 4, 1024, 9) at 5,
// against 170 MB and 75 MB of rows read once (51 and 22 us).  The rotations
// are a chain of dependent rounds (each needs the last one's sums), and the
// sums must keep torch's order, so what bounds it in practice is a round's
// latency: its barriers and its shared-memory round trips.
//
// Design: [A; V] lives in registers for the whole call, split over a team of
// G lanes.  Lane l of a problem's team keeps rows l, l + G, ... of the
// (m + n) x n stack [A; I] (V's rows below A's, rotated alike), at most R a
// lane (R a template argument per n: 8 for n = 4, 5 for 9 and 12, what fits
// under the 128 registers a thread has in a block of 512 without spills), and
// G is the smallest power of two that holds the m + n rows, chosen by the
// wrapper from the shape alone (kernels/jacobi.py::team_lanes): the 8 x 9
// hypotheses take 4 lanes, the 4 x 4 triangulation and cheirality systems 1
// (a problem a thread), PnP's 12 x 12 8, several problems a block of 128
// threads; LO's 1024 x 9 takes 256 and PnP's 2N x 12 refits up to 512, a
// problem a block.  A round: each lane writes its rows' products (cp * cp,
// cq * cq, cp * cq, rounded) to the problem's shared memory; after a barrier
// the block's threads share out torch's thread sums, then its block trees
// and global_reduce's chains, then one task a pair finishes the pair's three
// totals and works out its c and s; after the last barrier every lane turns
// its own rows.  A problem too tall for that (more rows than 512 lanes hold,
// or sums that pass the block's shared memory) takes the wide form, R = 0:
// one problem a block of 512 lanes, [A; V] and its sums' slot in a global
// workspace the wrapper allocates, each lane looping over its rows l, l + G,
// ...; the same rounds, the same sums in the same order, so the same bits.
// The schedule is a
// template argument of each round's terms and turn (the rounds themselves a
// loop that picks its case), so every column index is a compile-time
// constant and the rows stay in registers.  At the end the same sums over
// the rotated A's entries (acc + x * x, fused as torch's norm kernel fuses
// it) give the column norms and the argmin.

#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int kMaxTeam = 512;     // lanes of one problem at most: a whole block
constexpr int kSmallBlock = 128;  // threads a block of teams no wider than a warp
constexpr long long kMaxShared = 232448;  // bytes of shared memory a block may take on the H100
constexpr float kEps = (float)1e-30;  // the twin's Python float, rounded to float32

// The player at position `pos` in round `r` of the circle method of
// _round_robin_schedule: position 0 keeps player 0, positions 1 .. P - 1
// rotate one place a round; with n odd, player n is the bye.
__host__ __device__ constexpr int rr_player(int P, int pos, int r) {
  return pos == 0 ? 0 : (pos - 1 - r + P - 1) % (P - 1) + 1;
}

template <int N>
struct Round {
  int p[N / 2];
  int q[N / 2];
};

// Round r of _round_robin_schedule(N): the pairs (pos i, pos P - 1 - i) in
// order of i, each as (min, max), the bye's pair left out.
template <int N>
__host__ __device__ constexpr Round<N> round_pairs(int r) {
  constexpr int P = N + (N & 1);
  Round<N> out{};
  int g = 0;
  for (int i = 0; i < P / 2; ++i) {
    const int a = rr_player(P, i, r);
    const int b = rr_player(P, P - 1 - i, r);
    if (a < N && b < N) {
      out.p[g] = a < b ? a : b;
      out.q[g] = a < b ? b : a;
      ++g;
    }
  }
  return out;
}

struct Team {
  int lane;   // this thread's lane in its problem's team
  int G;      // lanes a team: a power of two, at most kMaxTeam
  int m;      // rows of A
  int used;   // rows a lane holds: ceil((m + n) / G), the same for the whole team
};

// How torch's CUDA reduce kernel splits the terms of each output of a sum over the rows of a
// (..., m, inner) tensor (ATen/native/cuda/Reduce.cuh, setReduceConfig): `by` threads of a block
// (block_y_reduce) times `ctas` blocks (global_reduce); 1 and 1 where one thread adds them all.
// kernels/jacobi.py::reduce_tree works it out from the shape and the card.
struct Tree {
  int by;
  int ctas;
  __device__ __forceinline__ int step() const { return by * ctas; }
};

// One problem's part of the block's shared memory, in floats: kK = 3 n / 2 values (a round's sums,
// or the n column norms) of m terms each, value-major; kK x stride thread sums (then block sums, in
// place; block_sums finds them); each value's total; each pair's c and s.
struct Slots {
  float* terms;
  float* total;
  float* cs;
};

// The twin's rotation of the pair whose column sums are app, aqq and apq.
__device__ __forceinline__ void rotation(float app, float aqq, float apq, float& c, float& s) {
  const float den = __fmul_rn(2.0f, fabsf(apq) < kEps ? kEps : apq);
  const float tau = __fdiv_rn(__fsub_rn(aqq, app), den);
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
  float t = __fdiv_rn(sgn, __fadd_rn(fabsf(tau), __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)))));
  if (fabsf(apq) < __fmul_rn(kEps, __fadd_rn(__fadd_rn(app, aqq), kEps))) t = 0.0f;
  c = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
  s = __fmul_rn(t, c);
}

__device__ __forceinline__ float add_term(float acc, float x, bool square) {
  return square ? fmaf(x, x, acc) : __fadd_rn(acc, x);  // vector_norm's acc + x * x is contracted
}

// x[v] + x[v + step] + ... (x[0 .. m)) as one thread of torch's reduce kernel adds them: four
// accumulators take the terms in turn, whole groups of four first, then the last 0-3, and are then
// added left to right.
__device__ __forceinline__ float thread_sum(const float* x, int v, int step, int m, bool square) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int idx = v;
  for (; idx + 3 * step < m; idx += 4 * step) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = add_term(acc[i], x[idx + i * step], square);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (idx < m) acc[i] = add_term(acc[i], x[idx], square);
    idx += step;
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
}

// block_y_reduce over p[0 .. by): p[y] += p[y + offset] for offset = by / 2 .. 1; in place.
__device__ __forceinline__ float y_tree(float* p, int by) {
  for (int off = by >> 1; off > 0; off >>= 1)
    for (int y = 0; y < off; ++y) p[y] = __fadd_rn(p[y], p[y + off]);
  return p[0];
}

// The block's problems' sums of `count` values (of kK slots) over their m terms in shared memory,
// in torch's order.  Where the tree splits the terms (step > 1), stages with a barrier after each: the thread sums of every (value, thread); each block's
// tree (block_y_reduce); global_reduce's thread y adding blocks y, y + by, ... from zero.  Then one
// task a final: `pairs` > 0, a pair's three values, the last tree and the pair's c and s into cs;
// 0, a value's last tree into `total`.  Every thread of the block takes part.
template <int kK>
__device__ __forceinline__ void block_sums(float* smem, int slot, int problems, int m, const Tree& tr,
                                           int stride, bool square, int count, int pairs) {
  const int step = tr.step();
  if (step > 1) {
    for (int task = threadIdx.x; task < problems * count * step; task += blockDim.x) {
      const int p = task / (count * step), r = task - p * count * step, k = r / step, v = r - k * step;
      float* base = smem + p * slot;
      base[kK * m + k * stride + v] = thread_sum(base + k * m, v, step, m, square);
    }
    __syncthreads();
    if (tr.by > 1) {
      for (int task = threadIdx.x; task < problems * count * tr.ctas; task += blockDim.x) {
        const int p = task / (count * tr.ctas), r = task - p * count * tr.ctas, k = r / tr.ctas;
        const int c = r - k * tr.ctas;
        y_tree(smem + p * slot + kK * m + k * stride + tr.by * c, tr.by);
      }
      __syncthreads();
    }
    if (tr.ctas > 1) {  // block c's sum sits at slot by c; thread y's goes to slot y (no block's but 0's)
      for (int task = threadIdx.x; task < problems * count * tr.by; task += blockDim.x) {
        const int p = task / (count * tr.by), r = task - p * count * tr.by, k = r / tr.by, y = r - k * tr.by;
        float* q = smem + p * slot + kK * m + k * stride;
        float sum = 0.0f;
        for (int c = y; c < tr.ctas; c += tr.by) sum = __fadd_rn(sum, q[tr.by * c]);
        q[y] = sum;
      }
      __syncthreads();
    }
  }
  const int values = pairs ? 3 : 1;           // values a final task adds up
  const int finals = pairs ? pairs : count;   // final tasks a problem
  for (int task = threadIdx.x; task < problems * finals; task += blockDim.x) {
    const int p = task / finals, f = task - p * finals;
    float* base = smem + p * slot;
    float sum[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i < values) {
        const int k = f * values + i;
        float* q = base + kK * m + k * stride;
        sum[i] = step == 1 ? thread_sum(base + k * m, 0, 1, m, square) : tr.ctas > 1 ? y_tree(q, tr.by) : q[0];
      }
    }
    float* total = base + kK * m + kK * stride;
    if (pairs) {
      rotation(sum[0], sum[1], sum[2], total[kK + 2 * f], total[kK + 2 * f + 1]);
    } else {
      total[f] = sum[0];
    }
  }
  __syncthreads();
}

// Round Rnd's terms of this lane's rows of A: cp * cp, cq * cq, cp * cq of each pair, each product
// rounded, as the twin's.
template <int N, int R, int Rnd>
__device__ __forceinline__ void round_terms(const float (&a)[R][N], const Team& t, float* terms) {
  constexpr Round<N> pr = round_pairs<N>(Rnd);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int row = t.lane + k * t.G;
    if (row < t.m) {  // a row of A: V's rows take no part in the sums
#pragma unroll
      for (int g = 0; g < N / 2; ++g) {
        const float ap = a[k][pr.p[g]];
        const float aq = a[k][pr.q[g]];
        terms[(3 * g) * t.m + row] = __fmul_rn(ap, ap);
        terms[(3 * g + 1) * t.m + row] = __fmul_rn(aq, aq);
        terms[(3 * g + 2) * t.m + row] = __fmul_rn(ap, aq);
      }
    }
  }
}

// The wide form's: this lane's rows of A in the workspace, row-major.
template <int N, int R, int Rnd>
__device__ __forceinline__ void round_terms(const float* rows, const Team& t, float* terms) {
  constexpr Round<N> pr = round_pairs<N>(Rnd);
  for (int row = t.lane; row < t.m; row += t.G) {
    const float* x = rows + (size_t)row * N;
#pragma unroll
    for (int g = 0; g < N / 2; ++g) {
      const float ap = x[pr.p[g]];
      const float aq = x[pr.q[g]];
      terms[(3 * g) * t.m + row] = __fmul_rn(ap, ap);
      terms[(3 * g + 1) * t.m + row] = __fmul_rn(aq, aq);
      terms[(3 * g + 2) * t.m + row] = __fmul_rn(ap, aq);
    }
  }
}

// Round Rnd's rotations of this lane's rows of [A; V], each pair's c and s from cs.
template <int N, int R, int Rnd>
__device__ __forceinline__ void round_turn(float (&a)[R][N], const Team& t, const float (&cs)[2 * (N / 2)]) {
  constexpr Round<N> pr = round_pairs<N>(Rnd);
#pragma unroll
  for (int g = 0; g < N / 2; ++g) {
    const float c = cs[2 * g];
    const float s = cs[2 * g + 1];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k < t.used) {
        const float ap = a[k][pr.p[g]];
        const float aq = a[k][pr.q[g]];
        a[k][pr.p[g]] = __fsub_rn(__fmul_rn(c, ap), __fmul_rn(s, aq));
        a[k][pr.q[g]] = __fadd_rn(__fmul_rn(s, ap), __fmul_rn(c, aq));
      }
    }
  }
}

// The wide form's, in the workspace.
template <int N, int R, int Rnd>
__device__ __forceinline__ void round_turn(float* rows, const Team& t, const float (&cs)[2 * (N / 2)]) {
  constexpr Round<N> pr = round_pairs<N>(Rnd);
  for (int row = t.lane; row < t.m + N; row += t.G) {
    float* x = rows + (size_t)row * N;
#pragma unroll
    for (int g = 0; g < N / 2; ++g) {
      const float c = cs[2 * g];
      const float s = cs[2 * g + 1];
      const float ap = x[pr.p[g]];
      const float aq = x[pr.q[g]];
      x[pr.p[g]] = __fsub_rn(__fmul_rn(c, ap), __fmul_rn(s, aq));
      x[pr.q[g]] = __fadd_rn(__fmul_rn(s, ap), __fmul_rn(c, aq));
    }
  }
}

// Round r's part of either, the schedule's pairs compile-time constants in each case: the rounds
// run as a loop, so the block's sums between them are one copy of code.  `a` is the lane's
// registers, or the wide form's rows in the workspace.
template <int N, int R, typename Rows, int... Rnd>
__device__ __forceinline__ void terms_of(int r, const Rows& a, const Team& t, float* terms,
                                         std::integer_sequence<int, Rnd...>) {
  ((r == Rnd ? round_terms<N, R, Rnd>(a, t, terms) : void()), ...);
}

template <int N, int R, typename Rows, int... Rnd>
__device__ __forceinline__ void turn_of(int r, Rows& a, const Team& t, const float (&cs)[2 * (N / 2)],
                                        std::integer_sequence<int, Rnd...>) {
  ((r == Rnd ? round_turn<N, R, Rnd>(a, t, cs) : void()), ...);
}

// R: the rows of [A; V] a lane holds in registers; 0, the wide form (one problem a block, its rows and
// its sums' slot in `work`, (m + N) N + slot floats a problem).
template <int N, int R>
__global__ void __launch_bounds__(kMaxTeam)
jacobi_kernel(const float* __restrict__ A, float* __restrict__ out, long long batch, int m, int G,
              int sweeps, Tree sums, Tree norms, int stride, float* work) {
  constexpr int kK = 3 * (N / 2);
  constexpr bool kWide = R == 0;
  extern __shared__ float smem[];
  const int problems = blockDim.x / G;
  const int slot = kK * m + kK * stride + kK + 2 * (N / 2);
  const Team t{(int)(threadIdx.x % G), G, m, (m + N + G - 1) / G};
  const int p = threadIdx.x / G;
  const long long b = (long long)blockIdx.x * problems + p;
  const bool live = b < batch;  // problems past the batch run along (the barriers need them), store nothing
  const float* Ab = A + (live ? b : 0) * (long long)m * N;
  float* rows = kWide ? work + b * ((long long)(m + N) * N + slot) : nullptr;
  float* base = kWide ? rows + (long long)(m + N) * N : smem + p * slot;
  float* sums_at = kWide ? base : smem;  // the block's problems' slots, as block_sums finds them
  const Slots me{base, base + kK * m + kK * stride, base + kK * m + kK * stride + kK};

  float a[R ? R : 1][N];
  if constexpr (kWide) {
    for (int row = t.lane; row < m + N; row += G) {
#pragma unroll
      for (int j = 0; j < N; ++j) rows[(size_t)row * N + j] = row < m ? Ab[(size_t)row * N + j] : (row - m == j ? 1.0f : 0.0f);
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int row = t.lane + k * G;
#pragma unroll
      for (int j = 0; j < N; ++j)
        a[k][j] = row < m ? (live ? Ab[(size_t)row * N + j] : 0.0f) : (row - m == j ? 1.0f : 0.0f);
    }
  }

  constexpr int kRounds = N + (N & 1) - 1;
  using Rounds = std::make_integer_sequence<int, kRounds>;
  float cs[2 * (N / 2)];
  for (int s = 0; s < sweeps; ++s) {
#pragma unroll 1
    for (int r = 0; r < kRounds; ++r) {
      if constexpr (kWide) terms_of<N, R>(r, rows, t, me.terms, Rounds{});
      else terms_of<N, R>(r, a, t, me.terms, Rounds{});
      __syncthreads();
      block_sums<kK>(sums_at, slot, problems, m, sums, stride, false, kK, N / 2);
#pragma unroll
      for (int i = 0; i < 2 * (N / 2); ++i) cs[i] = me.cs[i];
      if constexpr (kWide) turn_of<N, R>(r, rows, t, cs, Rounds{});
      else turn_of<N, R>(r, a, t, cs, Rounds{});
    }
  }

  // the singular values: torch.linalg.vector_norm of the rotated A's columns
  if constexpr (kWide) {
    for (int row = t.lane; row < m; row += G) {
#pragma unroll
      for (int j = 0; j < N; ++j) me.terms[j * m + row] = rows[(size_t)row * N + j];
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int row = t.lane + k * G;
      if (row < m) {
#pragma unroll
        for (int j = 0; j < N; ++j) me.terms[j * m + row] = a[k][j];
      }
    }
  }
  __syncthreads();
  block_sums<kK>(sums_at, slot, problems, m, norms, stride, true, N, 0);
  int best = 0;
  float best_v = __fsqrt_rn(me.total[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const float v = __fsqrt_rn(me.total[j]);
    if (best_v == best_v && (v != v || v < best_v)) {  // torch.argmin: the first NaN, else the first least
      best = j;
      best_v = v;
    }
  }
  if (!live) return;
  if constexpr (kWide) {  // V's rows were last turned before the norms' barriers: any thread may read them
    for (int j = t.lane; j < N; j += G) out[b * N + j] = rows[(size_t)(m + j) * N + best];
    return;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int row = t.lane + k * G;
    if (row >= m && row < m + N) {
      float v = a[k][0];
#pragma unroll
      for (int j = 1; j < N; ++j)
        if (j == best) v = a[k][j];
      out[b * N + (row - m)] = v;
    }
  }
}

template <int N, int R>
int launch(const float* A, float* out, long long batch, int m, int G, int sweeps, Tree sums, Tree norms,
           float* work, long long work_floats, cudaStream_t stream) {
  constexpr int kK = 3 * (N / 2);
  if (G < 1 || G > kMaxTeam || (G & (G - 1)) || (R > 0 && (long long)G * R < (long long)m + N) ||
      (R == 0 && G != kMaxTeam) || sums.by < 1 || sums.ctas < 1 || norms.by < 1 || norms.ctas < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = G > 32 ? G : kSmallBlock;  // a team wider than a warp is the block
  const int stride = sums.by * sums.ctas > norms.by * norms.ctas ? sums.by * sums.ctas : norms.by * norms.ctas;
  const long long slot = (long long)kK * m + (long long)kK * stride + kK + 2 * (N / 2);
  const long long bytes = R ? sizeof(float) * slot * (threads / G) : 0;  // the wide form's slots are in `work`
  const long long blocks = (batch * G + threads - 1) / threads;
  if (blocks > 0x7fffffffLL || bytes > kMaxShared || slot > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (R == 0 && (work == nullptr || work_floats < batch * ((long long)(m + N) * N + slot)))
    return (int)cudaErrorInvalidValue;
  // above the 48 KB a kernel gets unasked; per device, so set on every call
  cudaError_t err = cudaFuncSetAttribute(jacobi_kernel<N, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  jacobi_kernel<N, R><<<(unsigned)blocks, threads, (size_t)bytes, stream>>>(A, out, batch, m, G, sweeps, sums,
                                                                           norms, stride, work);
  return (int)cudaGetLastError();
}

}  // namespace

// `work`: null, or the wide form's workspace of `work_floats` floats (kernels/jacobi.py::wide_floats).
extern "C" int tpuslam_jacobi_nullvec(const void* A, void* out, long long batch, int m, int n, int team,
                                      int sweeps, int sums_by, int sums_ctas, int norms_by, int norms_ctas,
                                      void* work, long long work_floats, void* stream) {
  if (batch < 1 || m < 1 || sweeps < 0) return (int)cudaErrorInvalidValue;
  const float* a = (const float*)A;
  float* o = (float*)out;
  float* w = (float*)work;
  const Tree sums{sums_by, sums_ctas}, norms{norms_by, norms_ctas};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {  // R, the rows a lane holds at most: kernels/jacobi.py::ROWS_PER_LANE; 0 the wide form
    case 4: return w ? launch<4, 0>(a, o, batch, m, team, sweeps, sums, norms, w, work_floats, s)
                     : launch<4, 8>(a, o, batch, m, team, sweeps, sums, norms, w, work_floats, s);
    case 9: return w ? launch<9, 0>(a, o, batch, m, team, sweeps, sums, norms, w, work_floats, s)
                     : launch<9, 5>(a, o, batch, m, team, sweeps, sums, norms, w, work_floats, s);
    case 12: return w ? launch<12, 0>(a, o, batch, m, team, sweeps, sums, norms, w, work_floats, s)
                      : launch<12, 5>(a, o, batch, m, team, sweeps, sums, norms, w, work_floats, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
