"""The fleet traffic: S recorded drives, each the configuration's frames ping-pong tiled.

Made from ``--seed`` alone: each sequence's exposure gain (one exposure of
the frames per sequence, so no two sequences are the same bytes), its
start phase in the ping-pong cycle, its direction and its RANSAC seed.
Every seed gives the same sizes: S sequences of B-frame chunks of the same
frames.  Frame t of sequence s is the frame at position
(phase_s + direction_s · t) of the cycle 0, 1, …, n−1, n−2, …, 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import lcm

import numpy as np


@dataclass(frozen=True)
class FleetPlan:
    gains: tuple[float, ...]  # exposure gain of each sequence
    phases: tuple[int, ...]  # position of its frame 0 in the ping-pong cycle
    directions: tuple[int, ...]  # +1 or −1 along the cycle
    seeds: tuple[int, ...]  # its RANSAC seed
    n_frames: int  # distinct frames of a drive
    chunk: int  # frames of a sequence in one step

    @property
    def sequences(self) -> int:
        return len(self.gains)

    @property
    def cycle(self) -> int:
        return 2 * (self.n_frames - 1)

    def frame(self, s: int, t: int) -> int:
        """Which of the n frames sequence s shows at its frame t."""
        p = (self.phases[s] + self.directions[s] * t) % self.cycle
        return min(p, self.cycle - p)

    def period(self) -> int:
        """Steps after which the chunks repeat."""
        return lcm(self.cycle, self.chunk) // self.chunk

    def chunk_table(self) -> np.ndarray:
        """(period, S, B) int64 rows of the exposure bank (s · n + frame) that each step gathers."""
        n = self.n_frames
        return np.array([[[s * n + self.frame(s, k * self.chunk + b) for b in range(self.chunk)]
                          for s in range(self.sequences)] for k in range(self.period())], dtype=np.int64)


def fleet_plan(traffic: dict, n_frames: int, seed: int) -> FleetPlan:
    """The plan of ``traffic`` (a workload's ``params``) over ``n_frames`` distinct frames, from ``seed``."""
    s = traffic["sequences"]
    rng = np.random.default_rng(seed)
    lo, hi = traffic["gain_range"]
    gains = rng.uniform(lo, hi, size=s)
    cycle = 2 * (n_frames - 1)
    phases = rng.integers(0, cycle, size=s)
    directions = rng.choice([-1, 1], size=s)
    seeds = rng.integers(0, 2**31, size=s)
    return FleetPlan(tuple(float(g) for g in gains), tuple(int(p) for p in phases),
                     tuple(int(d) for d in directions), tuple(int(x) for x in seeds), n_frames, traffic["chunk_frames"])


def exposure_bank(frames, gains):
    """(S·n, H, W) uint8 on the frames' device: floor(frame · gain + ½), clipped, for each sequence's gain
    (float32, one call)."""
    import torch

    g = torch.tensor(gains, dtype=torch.float32, device=frames.device)[:, None, None, None]
    bank = torch.clamp(torch.floor(frames[None].to(torch.float32) * g + 0.5), 0, 255).to(torch.uint8)
    return bank.reshape(-1, *frames.shape[1:])
