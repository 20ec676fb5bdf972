#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch version;
2. the kernel build (``nvcc`` into ``build/repro_torch/``), with its seconds;
3. every kernel against its plain PyTorch version on the card, at the
   main path's shapes plus ragged and empty-segment cases, in fp32 (1e-5)
   and bf16 (2e-2); at the main path's shapes, the kernel's, the plain
   version's and one PyTorch library call's device times (CUDA events over
   back-to-back launches) beside the bound the card's memory rate sets, and
   the host's wall time per call of the kernel and of its public wrapper;
4. the port's sync engine on the card against the same engine on the CPU
   (heartbeat at scale 0.02, two cloud rounds, same seed and inputs);
5. the main path at full size: ``build_scenario("heartbeat")``,
   ``assign("eara-sca")``, ``simulate(engine="sync", pipeline="device",
   cloud_rounds=5)``, then one cloud round under ``assign("eara-dca")``;
   launch counts are zeroed just before and read just after;
6. two more SCA cloud rounds on a fresh engine, the second timed, then
   one under ``torch.profiler``: wall times, the card's busy share and the
   kernels that take the most device time.

The last lines are a JSON ``kernels`` record, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SOURCE = "src/repro_torch/kernels/csrc/aggregate.cu"
SEG_REPLACES = "src/repro/kernels/segment_aggregate.py:82"
AGG_REPLACES = "src/repro/kernels/hier_aggregate.py:45"

# device memory rate by card name (NVIDIA data sheets), bytes/s
_MEM_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _require(ok: bool, message: str) -> None:
    """Fail the phase (an ``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise AssertionError(message)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _mem_rate(name: str) -> float:
    for key, rate in _MEM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate known for card {name!r}")


def _device_ms(fn, iters: int = 200, warmup: int = 20):
    """(device ms, host ms) of one call of ``fn``, which must not synchronise.

    The host time is the wall clock of ``iters`` calls ending in a
    synchronise.  For the device time the stream is first held on a spin
    kernel for twice that long, so that all ``iters`` calls are queued
    before the first runs; CUDA events around them then time the card
    alone, back to back, and not the host's rate of issuing launches.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host * 2e9))  # cycles, at up to 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host * 1e3 / iters


def _host_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Wall-clock ms of one call of ``fn`` (which may synchronise)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _close(got, want, tol: float) -> float:
    """Max |got - want| in fp32; raises unless |got - want| <= tol + tol*|want|."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not bool(torch.isfinite(g).all()) or bool((err > tol + tol * w.abs()).any()):
        raise AssertionError(f"kernel disagrees with its plain version: max |err| {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def _timings(kernel, wrapper, plain, library, nbytes: int, rate: float) -> dict:
    """The timed numbers of one kernel at one shape (fp32)."""
    ms, kernel_host_ms = _device_ms(kernel)
    return {
        "ms": ms,
        "plain_ms": _device_ms(plain)[0],
        "library_ms": _device_ms(library)[0],
        "bound_ms": nbytes / rate * 1e3,
        "kernel_host_ms": kernel_host_ms,
        "wrapper_host_ms": _host_ms(wrapper),
    }


def _kernel_phase(rate: float, d_model: int) -> dict:
    """Phase 3: each kernel against its plain version on the card, and the
    timings at the main path's shapes."""
    import importlib

    import numpy as np
    import torch

    from repro_torch.kernels import (
        hier_aggregate,
        hier_aggregate_ref,
        hier_segment_aggregate,
        hier_segment_aggregate_ref,
    )

    # the modules, for their raw launches (the package re-exports the
    # wrappers under the same names)
    agg_mod = importlib.import_module("repro_torch.kernels.hier_aggregate")
    seg_mod = importlib.import_module("repro_torch.kernels.segment_aggregate")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # EARA-SCA: 18 membership pairs over 5 edges, in client-major pair order
    sca = rng.permutation(np.repeat(np.arange(5), [3, 4, 5, 3, 3]))
    # DCA starts: 21 pairs with segments = the 18 clients, 3 dual-homed
    dca = np.sort(np.concatenate([np.arange(18), [2, 7, 11]]))
    seg_cases = [
        ("edge FedAvg (SCA)", sca, 5, d_model, "main"),
        ("DCA starts", dca, 18, d_model, "timed"),
        ("ragged", np.array([0, 0, 0, 1, 3, 3, 3, 3, 4]), 5, 257, None),
        ("one segment", np.zeros(9, int), 1, 1000, None),
        ("own segment + empty", np.arange(9), 10, 1000, None),
    ]
    result = {"seg": {"max_abs_err": 0.0}, "agg": {"max_abs_err": 0.0}}
    for label, seg_np, e, d, timed in seg_cases:
        n = len(seg_np)
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL[str(dtype).split(".")[1]]
            x = torch.as_tensor(rng.standard_normal((n, d)), dtype=dtype, device=dev)
            w = torch.as_tensor(rng.uniform(0.05, 1.0, n), dtype=torch.float32, device=dev)
            seg = torch.as_tensor(seg_np, dtype=torch.int32, device=dev)
            got = hier_segment_aggregate(x, seg, w, e)
            want = hier_segment_aggregate_ref(x, seg, w, e)
            torch.cuda.synchronize()
            err = _close(got, want, tol)
            result["seg"]["max_abs_err"] = max(result["seg"]["max_abs_err"], err)
            counts = np.bincount(seg_np, minlength=e)
            for s in np.nonzero(counts == 0)[0]:
                _require(bool((got[s] == 0).all()), f"{label}: empty segment {s} is not exactly 0")
            for s in np.nonzero(counts == 1)[0]:
                row = int(np.nonzero(seg_np == s)[0][0])
                _require(torch.equal(got[s], x[row]), f"{label}: singleton segment {s} is not its row")
            line = f"kernel hier_segment_aggregate [{label}] N={n} D={d} E={e} {dtype}: max_abs_err={err:.3g}"
            if timed and dtype == torch.float32:
                seg64 = seg.long()
                wn = seg_mod._normalized_weights(seg64, w, e)
                rows, offs = seg_mod._segment_runs(seg64, e)
                wmat = torch.zeros((e, n), device=dev)
                wmat[seg64, torch.arange(n, device=dev)] = wn
                t = _timings(
                    kernel=lambda: seg_mod._launch(x, rows, offs, wn),
                    wrapper=lambda: hier_segment_aggregate(x, seg, w, e),
                    plain=lambda: hier_segment_aggregate_ref(x, seg, w, e),
                    library=lambda: wmat @ x,
                    nbytes=(n + e) * d * 4 + n * 8,
                    rate=rate,
                )
                if timed == "main":
                    result["seg"].update(t)
                line += " " + " ".join(f"{k}={v:.4g}" for k, v in t.items())
            print(line, flush=True)
    for n, d, timed in ((5, d_model, True), (4, 1000, False), (13, d_model, False), (32, 512, False)):
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL[str(dtype).split(".")[1]]
            x = torch.as_tensor(rng.standard_normal((n, d)), dtype=dtype, device=dev)
            w = torch.as_tensor(rng.uniform(0.05, 1.0, n), dtype=torch.float32, device=dev)
            got = hier_aggregate(x, w)
            want = hier_aggregate_ref(x, w)
            torch.cuda.synchronize()
            err = _close(got, want, tol)
            result["agg"]["max_abs_err"] = max(result["agg"]["max_abs_err"], err)
            line = f"kernel hier_aggregate [{'cloud reduce' if timed else 'sweep'}] N={n} D={d} {dtype}: max_abs_err={err:.3g}"
            if timed and dtype == torch.float32:
                wn = agg_mod._normalized_weights(w)
                t = _timings(
                    kernel=lambda: agg_mod._launch(x, wn),
                    wrapper=lambda: hier_aggregate(x, w),
                    plain=lambda: hier_aggregate_ref(x, w),
                    library=lambda: wn @ x,
                    nbytes=(n + 1) * d * 4 + n * 4,
                    rate=rate,
                )
                result["agg"].update(t)
                line += " " + " ".join(f"{k}={v:.4g}" for k, v in t.items())
            print(line, flush=True)
    return result


def _card_vs_cpu() -> None:
    """Phase 4: the sync engine on the card against the CPU, same inputs."""
    import numpy as np

    from repro_torch.federated import build_scenario
    from repro_torch.utils.tree import tree_leaves

    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=20, device="cpu")
    lam = sc.assign("eara-sca", device="cpu").lam
    runs = {d: sc.simulate(lam, cloud_rounds=2, seed=0, device=d) for d in ("cuda", "cpu")}
    gpu, cpu = runs["cuda"], runs["cpu"]
    one_sample = 1.0 / len(sc.test)
    for a, b in zip(gpu.history, cpu.history):
        print(f"card-vs-cpu round {a.cloud_round}: acc {a.test_acc:.6f} vs {b.test_acc:.6f}, "
              f"loss {a.mean_local_loss:.6f} vs {b.mean_local_loss:.6f}", flush=True)
        _require(abs(a.test_acc - b.test_acc) <= one_sample + 1e-6, "card and CPU accuracy disagree")
        _require(abs(a.mean_local_loss - b.mean_local_loss) <= 5e-3, "card and CPU loss disagree")
    diff = max(
        float(np.abs(p.cpu().numpy() - q.numpy()).max())
        for p, q in zip(tree_leaves(gpu.final_params), tree_leaves(cpu.final_params))
    )
    print(f"card-vs-cpu max |param diff| {diff:.3g}", flush=True)
    _require(diff <= 5e-3, "card and CPU parameters disagree")
    _require(gpu.accountant.totals() == cpu.accountant.totals(), "card and CPU accounting disagree")


def _main_path():
    """Phase 5: the paper's heartbeat experiment at full size on the card."""
    import torch

    from repro_torch.federated import build_scenario
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    sc = build_scenario("heartbeat")
    print(f"main: build_scenario heartbeat scale=1.0: {len(sc.clients)} EUs, {sc.n_edges} edges, "
          f"{sum(c.data_size for c in sc.clients)} samples, {time.perf_counter() - t0:.3f}s", flush=True)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sca = sc.assign("eara-sca")
    print(f"main: assign eara-sca {time.perf_counter() - t0:.3f}s per-edge EUs {sca.lam.sum(axis=0).tolist()}", flush=True)
    res = sc.simulate(sca.lam, cloud_rounds=5, engine="sync", pipeline="device")
    for h in res.history:
        print(f"main: sca round {h.cloud_round} acc {h.test_acc:.6f} loss {h.mean_local_loss:.6f} "
              f"seconds {h.wall_seconds:.4f}", flush=True)
    print(f"main: sca accountant {json.dumps(res.accountant.totals())}", flush=True)
    t0 = time.perf_counter()
    dca = sc.assign("eara-dca")
    print(f"main: assign eara-dca {time.perf_counter() - t0:.3f}s pairs {int(dca.lam.sum())}", flush=True)
    res_dca = sc.simulate(dca.lam, cloud_rounds=1, engine="sync", pipeline="device")
    h = res_dca.history[-1]
    print(f"main: dca round 1 acc {h.test_acc:.6f} loss {h.mean_local_loss:.6f} seconds {h.wall_seconds:.4f}", flush=True)
    print(f"main: dca accountant {json.dumps(res_dca.accountant.totals())}", flush=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"main: max_memory_allocated {torch.cuda.max_memory_allocated()} bytes", flush=True)
    for r in (res, res_dca):
        for leaf in tree_leaves(r.final_params):
            _require(bool(torch.isfinite(leaf).all()), "non-finite parameters")
    final = res.final_accuracy()
    _require(final > 0.4, f"final EARA-SCA accuracy {final} is not above 0.4 (twice chance)")
    for name, n in counts.items():
        _require(n > 0, f"kernel {name} was not launched on the main path")
    return counts, sc, sca.lam


def _profile_round(sc, lam) -> None:
    """Phase 6: SCA cloud rounds of the main path on a fresh engine: one to
    warm up, one timed, one under ``torch.profiler``.  Prints the rounds'
    wall times, the card's busy share (kernel time over wall time; the
    engine uses one stream) and the kernels that take the most device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import BatchedSyncEngine

    eng = BatchedSyncEngine(sc.clients, lam, sc.program, sc.test)
    eng.run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(1)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in device)
    launches = sum(e.count for e in device)
    walls = f"round wall {plain_wall:.4f}s unprofiled, {wall:.4f}s profiled"
    if busy_us <= 0:
        print(f"profile: {walls}; the trace holds no device time (not measured)", flush=True)
        return
    busy = busy_us / 1e6
    print(f"profile: {walls}; device busy {busy:.4f}s = {busy / plain_wall:.4f} of the unprofiled "
          f"round ({busy / wall:.4f} of the profiled one); device ops {launches}", flush=True)
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile: {e.self_device_time_total / 1e3:.3f} ms x{e.count} {e.key[:90]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails when the package is not beside the script)
    from repro_torch.kernels.build import build

    smi = _smi()
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    so, log = build()
    print(f"build: {so.name} in {time.perf_counter() - t0:.3f}s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}", flush=True)
    from repro_torch.federated.programs import CNNProgram
    from repro_torch.utils.tree import tree_num_params

    d_model = tree_num_params(CNNProgram().init(torch.Generator().manual_seed(0)))
    kern = _kernel_phase(_mem_rate(name), d_model)
    _card_vs_cpu()
    counts, sc, lam = _main_path()
    _profile_round(sc, lam)
    record = []
    for key, fn_name, replaces in (
        ("seg", "hier_segment_aggregate", SEG_REPLACES),
        ("agg", "hier_aggregate", AGG_REPLACES),
    ):
        k = kern[key]
        record.append({
            "name": fn_name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": counts[fn_name], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": "bytes",
            "library_ms": k["library_ms"],
        })
    print(json.dumps({"kernels": record}), flush=True)
    print(_smi(), flush=True)
    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
