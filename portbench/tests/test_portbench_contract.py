"""BENCHMARK.json against the benchmark's contract, and every file a cell needs."""

import json
import re

import pytest

from portbench.core.cell import HERE, ROOT, load_cell, metric_reader

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_size():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/") and (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"]), word


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_fields():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.add(m["layer"])
    assert len(layers) <= len(BENCH["per_layer"])


def test_configs():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files)) and 1 <= len(files) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["name"] == c["name"] and doc["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in doc["params"] for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    assert len({c["source"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_a_configuration_states_what_it_runs(name):
    """Every setting the harness lays over the port's config directory is stated under ``params``, and
    every stated setting has its origin: the source, a cut under ``reduced``, or a reason under ``assumed``."""
    doc = json.loads((HERE / "configs" / f"{name}.json").read_text())
    for group, values in doc.get("overrides", {}).items():
        assert all(doc["params"][group][k] == v for k, v in values.items())
    for key in ("max_keypoints", "brief_quantized_bins", "brief_seed", "num_hypotheses", "inlier_threshold_px"):
        assert key in doc["assumed"]


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_has_its_files(name):
    cell = load_cell(name, BENCH)
    assert (HERE / "drivers" / f"{cell.workload['driver']}.py").is_file()
    assert cell.workload["why"] == {w["name"]: w for w in BENCH["workloads"]}[name]["why"]
    assert [m["name"] for m in cell.end_to_end if m["name"] != "setup_s"]
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(metric_reader(m["name"]))
    assert cell.workload["params"]["chunk_frames"] == cell.params["batch_size"]
    assert cell.workload["limits"] and all(v >= 0 for v in cell.workload["limits"].values())
    moved = {m["moves"] for m in cell.per_layer}
    assert moved <= {m["name"] for m in cell.end_to_end}
