"""The PyTorch port stands alone: no JAX, no reference package, no silent
CPU fallback."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    """No silent fallback: without CUDA, every entry point that defaults to
    the card raises and names the argument; device="cpu" runs."""
    from repro_torch.device import resolve_device
    from repro_torch.engine import AsyncHFLEngine, BatchedSyncEngine
    from repro_torch.faults import FaultSpec, FaultState
    from repro_torch.engine import StreamSyncEngine
    from repro_torch.federated import CohortSpec, HeteroHFLSimulation, HFLSimulation, build_scenario, centralized_baseline
    from repro_torch.federated.simulation import central_reference_step, pooled_dataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device="):
        resolve_device()
    with pytest.raises(RuntimeError, match="device="):
        build_scenario("heartbeat", scale=0.02, n_test_per_class=20)
    sc = build_scenario("heartbeat", scale=0.02, n_test_per_class=20, device="cpu")
    lam = sc.assign("dba", device="cpu").lam
    with pytest.raises(RuntimeError, match="device="):
        sc.assign("eara-sca")
    with pytest.raises(RuntimeError, match="device="):
        sc.simulate(lam, cloud_rounds=1)
    with pytest.raises(RuntimeError, match="device="):
        BatchedSyncEngine(sc.clients, lam, sc.program, sc.test)
    with pytest.raises(RuntimeError, match="device="):
        HFLSimulation(sc.clients, lam, sc.program, sc.test)
    with pytest.raises(RuntimeError, match="device="):
        HeteroHFLSimulation(sc.clients, lam, sc.test)
    with pytest.raises(RuntimeError, match="device="):
        build_scenario("heartbeat", model_mix={"cnn": 12, "mlp": 6}, scale=0.02, n_test_per_class=20)
    with pytest.raises(RuntimeError, match="device="):
        AsyncHFLEngine(sc.clients, lam, sc.program, sc.test, latency=sc.cost.latency)
    with pytest.raises(RuntimeError, match="device="):
        FaultState(FaultSpec(energy_uploads=2.0), sc.topo, sc.wp, sc.model_bits)  # prices round 1 on the card
    with pytest.raises(RuntimeError, match="device="):
        centralized_baseline(sc.clients, sc.program, sc.test, rounds=1)
    with pytest.raises(RuntimeError, match="device="):
        sc.centralized(1)
    params = sc.program.init(torch.Generator().manual_seed(0))
    data = pooled_dataset(sc.clients, sc.program.n_classes)
    with pytest.raises(RuntimeError, match="device="):
        central_reference_step(params, data, np.random.default_rng(0), 50, sc.program)
    with pytest.raises(ValueError, match="device"):
        resolve_device("meta")
    with pytest.raises(RuntimeError, match="device="):
        build_scenario("heartbeat", lazy=True, n_eus=40, n_test_per_class=2)
    lazy = build_scenario("heartbeat", lazy=True, n_eus=40, n_test_per_class=2, device="cpu")
    with pytest.raises(RuntimeError, match="device="):
        lazy.simulate(CohortSpec(size=4), cloud_rounds=1)
    with pytest.raises(RuntimeError, match="device="):
        StreamSyncEngine(lazy.source, lazy.edge_of, lazy.program, lazy.test, cohort=CohortSpec(size=4))

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as serve_launch
    from repro_torch.serving import ServeEngine

    cfg = get_smoke_config("qwen3-14b")
    with pytest.raises(RuntimeError, match="device="):
        ServeEngine(cfg, max_seq=16)
    with pytest.raises(RuntimeError, match="device="):
        serve_launch.main(["--batch", "1", "--prompt-len", "2", "--tokens", "1"])
    ServeEngine(cfg, max_seq=16, device="cpu")

    from repro_torch.serving import ServeTraffic, TrafficSpec

    with pytest.raises(RuntimeError, match="device="):
        ServeTraffic(TrafficSpec(), sc.clients, sc.program)
    with pytest.raises(RuntimeError, match="device="):
        sc.simulate(lam, cloud_rounds=1, serve=TrafficSpec())
    with pytest.raises(RuntimeError, match="device="):
        build_scenario("lm", scale=0.05, n_test_per_class=2)
    with pytest.raises(RuntimeError, match="device="):
        build_scenario("lm", lazy=True, n_eus=20, n_test_per_class=4)
    lm = build_scenario("lm", scale=0.05, n_test_per_class=2, device="cpu")
    with pytest.raises(RuntimeError, match="device="):
        lm.simulate(lm.assign("dba", device="cpu").lam, cloud_rounds=1)

    for name in ("mamba", "rwkv"):
        with pytest.raises(RuntimeError, match="device="):
            build_scenario("lm", model=name, scale=0.05, n_test_per_class=2)
        with pytest.raises(RuntimeError, match="device="):
            build_scenario("lm", lazy=True, n_eus=20, model=name, n_test_per_class=4)
    with pytest.raises(RuntimeError, match="device="):
        build_scenario("lm", model_mix={"lm": 6, "mamba": 3, "rwkv": 3}, scale=0.05, n_test_per_class=2)
    for arch in ("rwkv6-7b", "jamba-1.5-large-398b"):
        with pytest.raises(RuntimeError, match="device="):
            ServeEngine(get_smoke_config(arch), max_seq=16)
        with pytest.raises(RuntimeError, match="device="):
            serve_launch.main(["--arch", arch, "--batch", "1", "--prompt-len", "2", "--tokens", "1"])
        ServeEngine(get_smoke_config(arch), max_seq=16, device="cpu")
