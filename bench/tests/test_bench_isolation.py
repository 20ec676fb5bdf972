"""What the harness and the reference load, and how a run behaves without
a card or without the program."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import bench_smoke

ROOT = bench_smoke.ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _python(code: str, cwd=ROOT) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys, json\n"
        "sys.path[:0] = ['bench/tests']\n"
        "import bench_smoke\n"
        "from bench import run\n"
        "for name in (bench_smoke.FL_CELL, bench_smoke.LM_CELL):\n"
        "    run.execute(bench_smoke.cell(name))\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))\n"
    )
    tops = _python(code)
    assert not set(tops) & set(FORBIDDEN), tops
    assert "repro_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys, json\n"
        "import bench.reference.fl, bench.reference.lm, bench.reference.sampling\n"
        "import bench.gen.health, bench.gen.lm, bench.gen.tokens, bench.roofline\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))\n"
    )
    tops = _python(code)
    assert not set(tops) & set(FORBIDDEN + ("repro_torch",)), tops


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", bench_smoke.FL_CELL, "--seed", "3",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == "", (out.returncode, out.stdout)


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", bench_smoke.FL_CELL, "--seed", "3",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_result_line_keys_and_compared_last():
    from bench import run as bench_run

    result = bench_run.execute(bench_smoke.cell(bench_smoke.FL_CELL))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert list(result)[-1] == "compared"
    assert all(set(v) == {"value", "limit"} for v in result["compared"].values())
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    json.dumps(result)
