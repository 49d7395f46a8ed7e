"""A cell by name: its workload file, its configuration file, and its metrics in ``BENCHMARK.json``.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own, found by the name that ``BENCHMARK.json`` gives:
``portbench/workloads/<cell>.json``, ``portbench/configs/<config>.json``,
``portbench/drivers/<driver>.py`` and ``portbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent  # the checkout


@dataclass(frozen=True)
class Cell:
    name: str
    workload: dict  # portbench/workloads/<name>.json
    config: dict  # portbench/configs/<config>.json
    end_to_end: list[dict]  # BENCHMARK.json metrics this cell reports, --trace 0
    per_layer: list[dict]  # and --trace 1

    @property
    def params(self) -> dict:
        return self.config["params"]

    def driver(self):
        return load_module("drivers", self.workload["driver"])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: dict | None = None) -> Cell:
    bench = benchmark if benchmark is not None else load_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    if workload["config"] != entry["config"] or workload["traffic"] != entry["traffic"]:
        raise ValueError(f"{name}: workload file and BENCHMARK.json disagree on config or traffic")
    return Cell(
        name=name, workload=workload, config=config,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def frame_paths(config: dict) -> list[Path]:
    """The configuration's frames, each checked against the SHA-256 its file states."""
    frames = config["frames"]
    paths = []
    for file, digest in sorted(frames["sha256"].items()):
        path = ROOT / frames["dir"] / file
        if hashlib.sha256(path.read_bytes()).hexdigest() != digest:
            raise ValueError(f"{path}: not the frame this configuration states")
        paths.append(path)
    return paths


def load_module(folder: str, name: str):
    """``portbench/<folder>/<name>.py`` as a module (a name may hold ``.`` and ``-``)."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name.replace('.', '_').replace('-', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """``read(record) -> float | None`` of ``portbench/metrics/<name>.py``."""
    return load_module("metrics", name).read
