"""A cell cut to a size a CPU test run can hold: 2 sequences of 2-frame chunks, the same code path."""

import copy
import dataclasses

from portbench.core.cell import load_cell


def small_cell(name: str = "vo-fleet", sequences: int = 2, chunk: int = 2):
    cell = load_cell(name)
    wl, cfg = copy.deepcopy(cell.workload), copy.deepcopy(cell.config)
    wl["params"].update(sequences=sequences, chunk_frames=chunk, warmup_steps=1, sample_steps=2,
                        check_group=sequences)
    cfg["params"]["batch_size"] = chunk
    return dataclasses.replace(cell, workload=wl, config=cfg)
