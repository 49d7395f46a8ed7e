#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result as the last line of standard output.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell's files are found by name (see
``portbench/README.md``).  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a run whose window is
followed by a few steps under ``torch.profiler``.  Every run ends with the comparison against
the plain reference that decides ``correct``; its numbers and limits are
the last lines of standard error and the last key of the result.  The run
exits non-zero, printing no result, without enough CUDA devices, or when
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)  # the harness's folders are reached as portbench.*, never as top-level names
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuslam")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared whole) is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program at a fixed place inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

    from portbench.core.cell import load_cell, load_json, metric_reader
    from portbench.core.vo_check import verdict

    bench = load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}[args.workload]
    cell = load_cell(args.workload, bench)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"this cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import tpuslam_torch  # noqa: F401  the system under test
    except ImportError as exc:
        err(f"the port is not in this checkout: {exc}")
        return 2

    record = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START, log=err)
    found = forbidden_modules()
    if found:
        err(f"the process loaded {', '.join(found)}: nothing the benchmark runs may import JAX or the JAX package")
        return 3

    metrics = {}
    for spec in cell.per_layer if args.trace else cell.end_to_end:
        value = metric_reader(spec["name"])(record)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    correct, rows = verdict(record["numbers"], cell.workload["limits"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": record["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": record["attempted"], "failed": 0, "metrics": metrics, "device": device}
    if args.trace:
        t = record["trace"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": t["top_ops"], "idle_gaps": t["top_idle"]}
    line["check"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}

    err(f"[card] {card_line()}; torch {torch.__version__}")
    err(f"[window] {record['steps']} steps of {record['frames_per_step']} frames in {record['window_s']:.3f} s "
        f"({len(record['chunk_ms'])} steps timed for the tails); set-up {record['setup_s']:.3f} s")
    if args.trace:
        from portbench.core.bounds import KERNELS
        from portbench.core.readers import kernel_seconds

        err(f"[kernels] {record['traced_steps']} traced steps: " + ", ".join(
            f"{k} {kernel_seconds(record, k)[0]} calls {1e3 * kernel_seconds(record, k)[1]:.3f} ms" for k in KERNELS))
    err(f"[numbers] {json.dumps(record['numbers'])}")
    for name, value, limit in rows:
        err(f"{name} {value!r} limit {limit!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
