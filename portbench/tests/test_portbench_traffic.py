"""The fleet generator: the same plan for one seed, another for another seed, every seed the same sizes."""

import json

import numpy as np
import pytest
import torch

from portbench.core.cell import HERE
from portbench.core.traffic import exposure_bank, fleet_plan

TRAFFIC = json.loads((HERE / "workloads" / "vo-fleet.json").read_text())["params"]
SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_one_seed_repeats_exactly(seed):
    a, b = fleet_plan(TRAFFIC, 10, seed), fleet_plan(TRAFFIC, 10, seed)
    assert a == b
    assert np.array_equal(a.chunk_table(), b.chunk_table())


def test_seeds_differ_and_keep_the_sizes():
    plans = [fleet_plan(TRAFFIC, 10, s) for s in SEEDS]
    assert len({(p.gains, p.phases, p.directions, p.seeds) for p in plans}) == len(plans)
    shapes = {p.chunk_table().shape for p in plans}
    assert shapes == {(9, TRAFFIC["sequences"], TRAFFIC["chunk_frames"])}
    lo, hi = TRAFFIC["gain_range"]
    for p in plans:
        assert all(lo <= g < hi for g in p.gains) and set(p.directions) <= {-1, 1}
        assert all(0 <= x < 2**31 for x in p.seeds)


def test_ping_pong_path():
    p = fleet_plan(TRAFFIC, 10, 3)
    for s in range(p.sequences):
        path = [p.frame(s, t) for t in range(40)]
        assert all(0 <= f < 10 for f in path)
        assert all(abs(a - b) == 1 for a, b in zip(path, path[1:]))  # no frame repeats: the drive always moves
    table = p.chunk_table()
    assert np.array_equal(table[0, :, 0] % 10, [p.frame(s, 0) for s in range(p.sequences)])
    assert np.array_equal(table[1, 2], [2 * 10 + p.frame(2, 16 + b) for b in range(16)])


def test_exposure_bank():
    frames = torch.tensor([[[0, 100, 200, 255]]], dtype=torch.uint8)
    bank = exposure_bank(frames, (0.85, 1.15))
    assert bank.shape == (2, 1, 4) and bank.dtype == torch.uint8
    assert bank[0, 0].tolist() == [0, 85, 170, 217]
    assert bank[1, 0].tolist() == [0, 115, 230, 255]  # clipped
