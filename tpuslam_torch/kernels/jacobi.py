"""Kernel 6 wrapper: the batched Jacobi nullvector (``csrc/jacobi.cu``).

Replaces no Pallas kernel (the JAX package leaves ``nullvec_jacobi`` to
XLA).  ``common/geometry.py::nullvec_jacobi`` hands every CUDA tensor to
:func:`jacobi_nullvec`, which launches the kernel on float32 rows of
n ∈ {4, 9, 12} columns and raises ``ValueError`` on any other CUDA tensor.
Inside a recorded step each call counts ``jacobi.kernel`` in
``utils/profiling.RECORDER``, booked to the innermost span.  On a CPU
tensor the eager twin runs and nothing is counted.

The launch geometry comes from the shape alone (:func:`launch_geometry`):
a problem's m + n rows are split over a team of lanes, a power of two, at
most ``ROWS_PER_LANE[n]`` rows a lane, all held in registers
(:func:`team_lanes`).  A problem too tall for that, or whose sums pass a
block's shared memory, takes the kernel's wide form: one problem a block of
``MAX_TEAM`` lanes, its rows and sums in a workspace of
:func:`wide_floats` floats a problem, in global memory.  The sums
over the rows are added in the order torch's CUDA reduce kernel adds the
twin's ``torch.sum`` and ``torch.linalg.vector_norm`` (:func:`reduce_tree`,
from the shape and the card's SM count), so the kernel gives the twin's
bits on the card: the benchmark's plain reference runs the twin's
operations, and a pose that moves by a rounding there moves its RANSAC.
"""

from __future__ import annotations

import functools

import torch

from tpuslam_torch.common.geometry import nullvec_jacobi_twin as jacobi_nullvec_reference
from tpuslam_torch.kernels.bounds import PEAK_F32_OPS, Work
from tpuslam_torch.kernels.build import library
from tpuslam_torch.utils import profiling

# csrc/jacobi.cu's template argument R for each n it is built for: the rows of [A; V] a lane holds.
ROWS_PER_LANE = {4: 8, 9: 5, 12: 5}
MAX_TEAM = 512  # lanes a problem at most: one block
SMALL_BLOCK = 128  # threads a block of teams no wider than a warp
MAX_SHARED = 232_448  # bytes of shared memory a block may take on the H100


def team_lanes(m: int, n: int) -> int | None:
    """Lanes of the team that solves one (m, n) problem: the smallest power of two that holds its
    m + n rows at ``ROWS_PER_LANE[n]`` a lane; None where the kernel does not take the shape."""
    rows_per_lane = ROWS_PER_LANE.get(n)
    if rows_per_lane is None or m < 1:
        return None
    team = 1
    while team * rows_per_lane < m + n:
        team *= 2
    return team if team <= MAX_TEAM else None


def _last_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def reduce_tree(outputs: int, m: int, inner: int, sms: int, threads_per_sm: int) -> tuple[int, int]:
    """How torch's CUDA reduce kernel splits each output's terms in a float32 sum over the rows of a
    contiguous (..., m, inner) tensor, ``outputs`` = (...) · inner: (threads of a block, blocks).

    ``ATen/native/cuda/Reduce.cuh::setReduceConfig`` where the reduced dimension is not the innermost:
    the outputs are vectorised by the largest of 4, 2, 1 dividing ``inner``; a thread takes all of an
    output's terms unless there are at least min(16 · block height, 256) of them, then the block's
    rows of threads split them, and blocks too where a thread would still add 256 or more and the
    grid is no larger than the card holds at once.
    """
    vec = 4
    while inner % vec:
        vec //= 2
    most = 512 // vec
    dim0 = outputs // vec
    dim0_pow2 = _last_pow2(dim0) if dim0 < most else most
    dim1_pow2 = _last_pow2(m) if m < most else most
    width = min(dim0_pow2, 32)
    height = min(dim1_pow2, most // width)
    width = min(dim0_pow2, most // height)
    if m < min(16 * height, 256):
        return 1, 1
    per_thread = -(-m // height)
    grid = -(-dim0 // width)
    target = sms * (threads_per_sm // (width * height))
    if per_thread < 256 or grid > target:
        return height, 1
    return height, max(min(-(-target // grid), -(-per_thread // 16)), -(-per_thread // 256))


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.max_threads_per_multi_processor


def launch_geometry(batch: int, m: int, n: int, sms: int, threads_per_sm: int):
    """(team lanes, the sums' tree, the norms' tree) of a call on ``batch`` (m, n) problems with [A; V]
    in registers, or None where no team holds them (see :func:`team_lanes`) or their sums would pass
    a block's shared memory: the wide form's calls (:func:`wide_floats`)."""
    team = team_lanes(m, n)
    if team is None:
        return None
    sums, norms, slot = _sums(batch, m, n, sms, threads_per_sm)
    problems = 1 if team > 32 else SMALL_BLOCK // team
    if 4 * slot * problems > MAX_SHARED:
        return None
    return team, sums, norms


def wide_floats(batch: int, m: int, n: int, sms: int, threads_per_sm: int) -> tuple[tuple, tuple, int]:
    """(the sums' tree, the norms' tree, floats of workspace a problem) of the kernel's wide form:
    [A; V], then the slot that ``csrc/jacobi.cu::jacobi_kernel`` keeps in shared memory otherwise."""
    sums, norms, slot = _sums(batch, m, n, sms, threads_per_sm)
    return sums, norms, (m + n) * n + slot


def _sums(batch: int, m: int, n: int, sms: int, threads_per_sm: int) -> tuple[tuple, tuple, int]:
    """The sums' tree, the norms' tree and a problem's slot in floats, as ``csrc/jacobi.cu::launch``
    counts it: 3 n/2 values of m terms, 3 n/2 times the larger tree's thread sums, the totals, each
    pair's c and s."""
    pairs = n // 2
    sums = reduce_tree(batch * pairs, m, pairs, sms, threads_per_sm)
    norms = reduce_tree(batch * n, m, n, sms, threads_per_sm)
    stride = max(sums[0] * sums[1], norms[0] * norms[1])
    return sums, norms, 3 * pairs * (m + stride + 1) + 2 * pairs


def jacobi_nullvec(A: torch.Tensor, sweeps: int) -> torch.Tensor:
    """(..., m, n) float rows → (..., n) right singular vectors of their smallest singular values."""
    if A.dim() < 2:
        raise ValueError(f"A must be (..., m, n), got {tuple(A.shape)}")
    if A.device.type == "cpu":
        return jacobi_nullvec_reference(A, sweeps)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    m, n = A.shape[-2:]
    if A.dtype != torch.float32 or n not in ROWS_PER_LANE or m < 1:
        raise ValueError(f"kernel 6 takes float32 rows (..., m, n) with m >= 1 and n in {sorted(ROWS_PER_LANE)}, "
                         f"got {A.dtype} {tuple(A.shape)}")
    batch = A.numel() // (m * n)
    a = A.contiguous()
    out = torch.empty((*A.shape[:-2], n), dtype=torch.float32, device=a.device)
    if batch:
        card = _card(a.device.index if a.device.index is not None else torch.cuda.current_device())
        geometry = launch_geometry(batch, m, n, *card)
        work = None
        if geometry is None:  # the wide form
            sums, norms, per_problem = wide_floats(batch, m, n, *card)
            team, work = MAX_TEAM, torch.empty(batch * per_problem, dtype=torch.float32, device=a.device)
        else:
            team, sums, norms = geometry
        with torch.cuda.device(a.device):
            library().call(
                "tpuslam_jacobi_nullvec", a.data_ptr(), out.data_ptr(), batch, m, n, team, sweeps, *sums, *norms,
                None if work is None else work.data_ptr(), 0 if work is None else work.numel(),
                torch.cuda.current_stream().cuda_stream,
            )
        jacobi_nullvec.launches += 1
    profiling.count("jacobi.kernel")
    return out


jacobi_nullvec.launches = 0


def jacobi_work(batch: int, m: int, n: int, sweeps: int) -> Work:
    """Bytes and float32 operations of one call (a fused multiply-add counts two).

    Each of a sweep's n(n − 1)/2 pairs: its three column sums (6 m), the
    rotation of A's two columns (6 m) and of V's (6 n), and the angle (16:
    the twin's arithmetic between the sums and c, s).  Then the norms (2 m n)
    and their square roots (n).  The rows read once, the n-vector written once.
    """
    pair = 12 * m + 6 * n + 16
    ops = batch * (sweeps * n * (n - 1) // 2 * pair + 2 * m * n + n)
    return Work(bytes=4 * batch * (m * n + n), ops=ops, peak=PEAK_F32_OPS)
