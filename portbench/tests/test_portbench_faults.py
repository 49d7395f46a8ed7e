"""A run with the timed path broken underneath has to come out not correct; a sound one correct.

Each case drives the rest of a run (set-up, the window, the check against
the reference, the verdict under the cell's limits) on the CPU at a small
size, past the harness's look for a card.
"""

import time

import pytest

from portbench.core.vo_check import verdict
from portbench.tests.small import small_cell


class Broken:
    """The port's pipeline with one fault planted in its step."""

    def __init__(self, pipe, fault: str | None):
        self.pipe, self.fault = pipe, fault

    def initial_state(self):
        return self.pipe.initial_state()

    def process_chunks(self, frames, valid, states, seeds):
        if self.fault == "half_left_out":  # only the first half of the sequences run; the rest copy them
            h = len(states) // 2
            results, new = self.pipe.process_chunks(frames[:h], valid[:h], states[:h], seeds[:h])
            n = len(states) - h
            return results + results[:n], new + new[:n]
        results, new = self.pipe.process_chunks(frames, valid, states, seeds)
        if self.fault == "state_unchanged":
            return results, states
        if self.fault == "answer_altered":  # one frame's pose moved by a hundredth of a unit where it is made
            poses = results[0].poses.clone()
            poses[-1, 0, 3] += 0.01
            results[0] = results[0]._replace(poses=poses)
        return results, new


def _run(name: str, fault: str | None):
    cell = small_cell(name)
    drive = cell.driver()
    rec = drive.run(cell, 2**31 + 77, 0, False, "cpu", time.perf_counter(), steps=5,
                    make_pipeline=lambda c, d: Broken(drive.port_pipeline(c, d), fault), log=lambda m: None)
    return verdict(rec["numbers"], cell.workload["limits"])


@pytest.mark.parametrize("name", ["vo-fleet", "pyr-fleet"])
def test_a_sound_run_is_correct(name):
    ok, rows = _run(name, None)
    assert ok, rows


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_a_broken_step_is_not_correct(fault):
    ok, rows = _run("vo-fleet", fault)
    assert not ok, rows
