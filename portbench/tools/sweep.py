#!/usr/bin/env python3
"""The step at several fleet sizes, on the card: step time, device idle share and peak memory.

    python3 portbench/tools/sweep.py --workload vo-fleet --sequences 8,16,32 --seconds 15

Each size runs in a process of its own (the peak memory is a process's),
with the profiler over three steps; no check.
"""

import argparse
import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def one(workload: str, sequences: int, seconds: float) -> dict:
    import torch

    from portbench.core.cell import load_cell

    cell = load_cell(workload)
    wl = copy.deepcopy(cell.workload)
    wl["params"]["sequences"] = sequences
    cell = dataclasses.replace(cell, workload=wl)
    rec = cell.driver().run(cell, 12345, seconds, True, "cuda", time.perf_counter(), check=False,
                            log=lambda m: print(m, file=sys.stderr))
    t = rec["trace"]
    return {"workload": workload, "sequences": sequences, "steps": rec["steps"],
            "step_ms_median": statistics.median(rec["chunk_ms"]),
            "frames_per_s_untraced": 1e3 * rec["frames_per_step"] / statistics.fmean(rec["chunk_ms"]),
            "device_idle_pct": 100 * (1 - t["busy_s"] / t["window_s"]),
            "launches_per_step": t["launches"] / rec["traced_steps"],
            "memory_peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sequences", default="8,16,32")
    ap.add_argument("--seconds", type=float, default=15)
    ap.add_argument("--one", type=int)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.workload, args.one, args.seconds)), flush=True)
        return 0
    for s in args.sequences.split(","):
        subprocess.run([sys.executable, __file__, "--workload", args.workload, "--one", s,
                        "--seconds", str(args.seconds)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
