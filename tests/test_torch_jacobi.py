"""Kernel 6's wrapper (``tpuslam_torch/kernels/jacobi.py``) on the CPU: its routing and its geometry.

``common/geometry.py::nullvec_jacobi`` hands CUDA tensors to the wrapper;
a CPU tensor reaches the eager twin unchanged, bit for bit, without
building or loading the kernel library and without counting ``jacobi.*``
in a recorded step.  The team of lanes a problem takes, or the wide form
and its workspace, follows from its shape alone.  The kernel itself is held to the twin on the card, in
``tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpuslam_torch.common import geometry as tgeo
from tpuslam_torch.kernels import jacobi as kj
from tpuslam_torch.utils import profiling


@pytest.mark.parametrize("shape,dtype", [((6, 8, 9), torch.float32), ((3, 40, 9), torch.float32),
                                         ((2, 3, 4, 4), torch.float32), ((2, 24, 12), torch.float32),
                                         ((4, 6, 5), torch.float32), ((5, 8, 9), torch.float64)])
def test_cpu_tensors_reach_the_twin_unchanged(monkeypatch, shape, dtype):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(kj, "library", no_library)
    A = torch.randn(shape, generator=torch.Generator().manual_seed(sum(shape)), dtype=dtype)
    before = kj.jacobi_nullvec.launches
    with profile(activities=[ProfilerActivity.CPU]), profiling.RECORDER.step("t.jacobi"):
        got = tgeo.nullvec_jacobi(A, sweeps=3)
        wrapped = kj.jacobi_nullvec(A, 3)
    want = tgeo.nullvec_jacobi_twin(A, sweeps=3)
    assert torch.equal(got, want) and torch.equal(wrapped, want) and got.dtype == dtype
    assert kj.jacobi_nullvec.launches == before
    assert profiling.RECORDER.steps[-1].counters == {}


# (m, n) → lanes: the cells' hypotheses, LO refits and 4 x 4 systems, PnP's hypotheses and refits,
# the largest each n takes, and what no team takes (no rows, another n; more rows than 512 lanes hold,
# which take the kernel's wide form)
@pytest.mark.parametrize("m,n,lanes", [(8, 9, 4), (1024, 9, 256), (4, 4, 1), (12, 12, 8), (2048, 12, 512),
                                       (40, 9, 16), (2551, 9, 512), (4092, 4, 512), (2548, 12, 512),
                                       (0, 9, None), (8, 5, None), (2552, 9, None), (4093, 4, None),
                                       (2549, 12, None)])
def test_team_lanes_follow_the_shape(m, n, lanes):
    assert kj.team_lanes(m, n) == lanes
    if lanes is not None:
        assert lanes * kj.ROWS_PER_LANE[n] >= m + n and (lanes == 1 or (lanes // 2) * kj.ROWS_PER_LANE[n] < m + n)


# How torch's CUDA reduce kernel splits the twin's column sums on an H100 (132 SMs, 2,048 threads an SM),
# by Reduce.cuh's setReduceConfig: (outputs, m, inner) → (threads of a block, blocks) adding one output.
# The cells' hypotheses and 4 x 4 systems: one thread; LO's sums: 4 threads x 16 blocks; LO's norms:
# 16 threads; DLT-PnP's refits over 64 problems and over one.
@pytest.mark.parametrize("outputs,m,inner,tree", [
    (524288 * 4, 8, 4, (1, 1)), (524288 * 9, 8, 9, (1, 1)), (524288 * 2, 4, 2, (1, 1)), (524288 * 4, 4, 4, (1, 1)),
    (2048 * 4, 1024, 4, (4, 16)), (2048 * 9, 1024, 9, (16, 1)), (64 * 6, 2048, 6, (8, 16)),
    (64 * 12, 2048, 12, (4, 32)), (6, 2048, 6, (128, 1)), (12, 2048, 12, (64, 1)), (300 * 4, 333, 4, (4, 1))])
def test_reduce_tree_follows_torchs_reduce_config(outputs, m, inner, tree):
    assert kj.reduce_tree(outputs, m, inner, 132, 2048) == tree


def test_launch_geometry_refuses_what_its_shared_memory_cannot_hold():
    assert kj.launch_geometry(2048, 1024, 9, 132, 2048) == (256, (4, 16), (16, 1))
    assert kj.launch_geometry(1, 2548, 12, 132, 2048) is not None  # 188 KB for the largest 12-column problem
    assert kj.launch_geometry(1, 2551, 9, 132, 2048) is not None
    assert kj.launch_geometry(1, 4092, 4, 132, 2048) is not None
    assert kj.launch_geometry(1, 2552, 9, 132, 2048) is None  # more rows than 512 lanes hold: the wide form


# The wide form's workspace a problem: [A; V], then the slot csrc/jacobi.cu keeps in shared memory
# otherwise (3 n/2 values of m terms, 3 n/2 x the larger tree's thread sums, the totals, each pair's c, s).
@pytest.mark.parametrize("batch,m,n", [(8, 4000, 12), (2048, 3000, 9), (3, 5000, 4), (1, 2552, 9)])
def test_wide_floats_hold_the_rows_and_the_slot(batch, m, n):
    sums, norms, per_problem = kj.wide_floats(batch, m, n, 132, 2048)
    pairs = n // 2
    assert sums == kj.reduce_tree(batch * pairs, m, pairs, 132, 2048)
    assert norms == kj.reduce_tree(batch * n, m, n, 132, 2048)
    stride = max(sums[0] * sums[1], norms[0] * norms[1])
    assert per_problem == (m + n) * n + 3 * pairs * m + 3 * pairs * stride + 3 * pairs + 2 * pairs
