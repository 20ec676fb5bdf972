"""``BENCHMARK.json`` and the files it names: names, units and limits of
the benchmark's contract, and every file a cell needs present."""
from __future__ import annotations

import json
import re

import pytest

import bench_smoke
from bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = harness.benchmark(bench_smoke.ROOT)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) and not w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_check_fits_its_time():
    cells = 24  # later PRs may add cells up to the limit
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ("configs", "workloads", "end_to_end", "per_layer"))
def test_names_are_unique_and_allowed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_units_sources_and_bounds():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES, m
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_its_files_and_metrics(w):
    root = bench_smoke.ROOT
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert w["config"] in configs
    assert (root / configs[w["config"]]["file"]).is_file()
    cell = harness.load_cell(w["name"], 1, 1.0, False, root=root, device="cpu")
    assert (root / "bench" / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    e2e = {m["name"] for m in harness.metrics_for(cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.metrics_for(cell, "per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e
        assert (root / "bench" / "metrics" / f"{m['name']}.py").is_file()
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())


def test_configs_are_files_of_their_own_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert all(any(f.startswith(p.rstrip("/") + "/") for p in BENCH["paths"]) for f in files)
    for c in BENCH["configs"]:
        body = harness.load_json(bench_smoke.ROOT / c["file"])
        assert body["reduced"] == c["reduced"]


def test_files_under_paths_are_named_from_name_characters():
    root = bench_smoke.ROOT
    for p in BENCH["paths"]:
        for f in (root / p).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            rel = f.relative_to(root).as_posix()
            assert all(NAME.match(part) for part in rel.split("/")), rel
