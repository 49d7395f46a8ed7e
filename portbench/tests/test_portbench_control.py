"""On the card: the control (the reference with bfloat16 hypothesis scores, in the program's place)
comes out not correct, and the port, on the same seeds, correct.  At 4 sequences of full 16-frame chunks, 6 steps: the size a test
run holds; ``portbench/tools/readings.py`` reads the same at the cells' own size."""

import time

import pytest

from portbench.core.control import ControlPipeline
from portbench.core.vo_check import verdict
from portbench.tests.small import small_cell

pytestmark = pytest.mark.card


def _run(card, name: str, seed: int, control: bool):
    cell = small_cell(name, sequences=4, chunk=16)
    drive = cell.driver()
    make = (lambda c, d: ControlPipeline(c, d, group=4)) if control else drive.port_pipeline
    rec = drive.run(cell, seed, 0, False, card, time.perf_counter(), steps=6, make_pipeline=make, log=lambda m: None)
    return verdict(rec["numbers"], cell.workload["limits"])


@pytest.mark.parametrize("name", ["vo-fleet", "pyr-fleet"])
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
def test_the_control_fails(card, name, seed):
    ok, rows = _run(card, name, seed, control=True)
    assert not ok, rows


@pytest.mark.parametrize("name", ["vo-fleet", "pyr-fleet"])
def test_the_port_passes(card, name):
    ok, rows = _run(card, name, 2**31 + 404, control=False)
    assert ok, rows
