"""A later PR adds a cell, a configuration or a per-layer metric by adding
files and entries: dropped into a copy of the benchmark, each runs with
no other edit."""
from __future__ import annotations

import json
import shutil

import bench_smoke
from bench import harness
from bench import run as bench_run


def _copy(tmp_path):
    shutil.copy(bench_smoke.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(bench_smoke.ROOT / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_a_new_cell_config_and_metric_are_data_and_files(tmp_path):
    bench = _copy(tmp_path)
    b = tmp_path / "bench"
    # a configuration: the seizure-shaped model (19 channels, 3 classes)
    cfg = json.loads((b / "configs" / "heartbeat-cnn1d-iot.json").read_text())
    cfg.update(name="seizure-cnn1d-iot", model=dict(cfg["model"], in_channels=19, n_classes=3, seq_len=178))
    (b / "configs" / "seizure-cnn1d-iot.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "seizure-cnn1d-iot", "source": "https://arxiv.org/abs/2107.06548",
                             "file": "bench/configs/seizure-cnn1d-iot.json", "reduced": [], "why": "a test"})
    # a traffic mix and its limits
    tr = json.loads((b / "traffic" / "iot-c4096.json").read_text())
    tr.update(clients=200, cohort=20, page_slots=200, page_chunk=64, test_per_class=30)
    (b / "traffic" / "iot-c20.json").write_text(json.dumps(tr))
    shutil.copy(b / "limits" / "hb-iot-c4096.json", b / "limits" / "sz-iot-c20.json")
    bench["workloads"].append({"name": "sz-iot-c20", "config": "seizure-cnn1d-iot", "traffic": "iot-c20",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "hb-iot-c4096" in m["workloads"]:
            m["workloads"].append("sz-iot-c20")
    # a per-layer metric with a reader of its own
    (b / "metrics" / "rounds_traced.py").write_text(
        "def read(ctx):\n    return ctx['counters'].get('traced_rounds')\n")
    bench["per_layer"].append({"name": "rounds_traced", "unit": "rounds", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "fl_clients_per_s",
                               "workloads": ["sz-iot-c20"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("sz-iot-c20", 5, 0.3, True, root=tmp_path, device="cpu")
    assert cell.config["model"]["in_channels"] == 19
    assert [m["name"] for m in harness.metrics_for(cell, "per_layer", root=tmp_path)] == ["rounds_traced"]
    drv = harness.driver_of(cell, root=tmp_path)
    fake = harness.Trace(1.0, [("k", 0.1, 0.2)], [("run(1)", 0.0, 0.5)])
    orig = harness.traced
    harness.traced = lambda fn: (fn(), fake)
    try:
        out = drv.run(cell)
    finally:
        harness.traced = orig
    assert out["checks"] and all(c["value"] >= 0 for c in out["checks"]), out["checks"]
    reader = harness.load_module(tmp_path / "bench" / "metrics" / "rounds_traced.py", "bench_metric_test")
    assert reader.read({"cell": cell, "trace": fake, "counters": out["counters"]}) == out["counters"]["traced_rounds"]


def test_the_cells_run_from_their_files_alone(tmp_path):
    """``execute`` finds a cell's driver, files and readers by name."""
    _copy(tmp_path)
    cell = bench_smoke.cell(bench_smoke.FL_CELL, root=tmp_path)
    result = bench_run.execute(cell)
    assert result["correct"] and set(result["metrics"]) == {"fl_clients_per_s", "latency_ms_p95", "peak_mem_gib",
                                                            "setup_s"}
