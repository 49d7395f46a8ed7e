#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card, in one process.

    python3 portbench/tools/readings.py --workload vo-fleet --seeds 1,2,3 --control-seeds 4,5,6 --steps 12

For each ``--seeds`` seed, a window of exactly ``--steps`` steps of the
port and the check's numbers; for each ``--control-seeds`` seed, the same
with the control (``core/control.py``: the reference in the program's
place, its hypothesis scores on bfloat16 operands).  One JSON line a run on standard output; the limits go
above the port's largest reading and below the control's smallest.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()

    import torch

    from portbench.core.cell import load_cell
    from portbench.core.control import ControlPipeline

    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    drive = cell.driver()
    group = cell.workload["params"]["check_group"]
    runs = [(int(s), "port") for s in args.seeds.split(",") if s]
    runs += [(int(s), "control") for s in args.control_seeds.split(",") if s]
    for seed, who in runs:
        t0 = time.perf_counter()
        make = drive.port_pipeline if who == "port" else (lambda c, d: ControlPipeline(c, d, group))
        rec = drive.run(cell, seed, 0, False, "cuda", t0, steps=args.steps, make_pipeline=make,
                        log=lambda m: print(m, file=sys.stderr, flush=True))
        print(json.dumps({"workload": args.workload, "who": who, "seed": seed, "steps": rec["steps"],
                          "numbers": rec["numbers"], "seconds": time.perf_counter() - t0,
                          "step_ms_median": sorted(rec["chunk_ms"])[len(rec["chunk_ms"]) // 2]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
