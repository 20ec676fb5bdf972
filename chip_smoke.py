#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --segment-wrapper ROOT   # one wrapper's timings only

Phases, each of which raises (and the script exits non-zero) on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch version;
2. the kernel build (one ``nvcc`` per source, side by side, linked into
   ``build/repro_torch/librepro_torch-<hash>.so``), with its seconds,
   each kernel's registers and spills (every kernel must show 0 spills),
   the fp32 flash kernel's tile (must equal ``SIMT_TILE``), and the
   ``HGMMA`` (tensor-core) and ``UTMALDG`` (TMA load) instructions in the
   ``wgmma`` flash kernel's SASS;
3. every kernel against its plain PyTorch version on the card, with the
   kernel's, the plain version's and one PyTorch library call's device
   times (CUDA events over back-to-back launches) beside the least time the
   card could take (``bound_ms``): the FedAvg reductions at the heartbeat
   path's shapes (fp32 1e-5, bf16 2e-2), the segment kernel also with ids
   outside [0, E) (which belong to no segment on the card), its wrapper's
   whole calls (the card's time per call back to back, the device
   operations one call queues and their device time, the host time) and
   a run under ``torch.cuda.set_sync_debug_mode("error")``, beside
   ``hier_aggregate``'s kernel reading the same 18 rows (one level of
   loads: a floor for that call);
   flash attention, bf16 on the ``wgmma`` kernel, at the qwen3-14b serve
   prefill and at starcoder2-3b's widths with its 4096 window biting, fp32
   on the SIMT kernel at its own case and at phase 7's shape (with the name
   of the CUDA kernel the library call ran), plus untimed cases (d 96,
   windows below the tile, ragged lengths, a fused projection's views; fp32
   2e-5, bf16 2e-2), each checked to have launched its dtype's variant;
   top-k gating at the granite-moe router shape (1e-5);
4. card against CPU: the heartbeat sync engine (scale 0.02, two cloud
   rounds), and the qwen3-14b smoke config served with the same parameters
   (prefill logits 1e-4, identical greedy tokens);
5. the heartbeat path at full size: ``build_scenario("heartbeat")``,
   ``assign("eara-sca")``, ``simulate(engine="sync", pipeline="device",
   cloud_rounds=5)``, then one cloud round under ``assign("eara-dca")``;
   launch counts are zeroed just before and read just after;
6. two more SCA cloud rounds on a fresh engine, the second timed, then
   one under ``torch.profiler``: wall times, the card's busy share and the
   kernels that take the most device time;
7. serve exactness on the card at qwen3-14b widths cut to 2 layers in
   fp32: a uniform batch gives the same tokens with ``use_flash`` on and
   off, and a ragged batch the same tokens as its requests served alone
   (launch counts zeroed just before and read just after: one fp32 flash
   launch per layer of each uniform prefill);
8. the serving path at full width: ``ServeEngine`` on qwen3-14b (40
   layers, bf16, random weights from seed 0) with ``use_flash=True``, a
   uniform batch of 4 prompts of 2048 tokens with 32 new tokens each
   (launch counts zeroed just before and read just after: 40 flash
   launches, one per layer of the prefill, all of the ``wgmma`` variant,
   none in decode), then a ragged batch through the pad-mask path (no
   flash launch), then the same parameters with ``use_flash=False``
   (prefill-logit difference, token agreement), then one prefill and 4
   decode steps under ``torch.profiler``.

With ``--segment-wrapper ROOT`` the script times only the segment
wrapper's whole calls, for the port under ``ROOT/src``, and prints one JSON
line: run it on two trees in turns to compare them on one card.

The last lines are a JSON ``kernels`` record, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

AGG_SOURCE = "src/repro_torch/kernels/csrc/aggregate.cu"
SEG_REPLACES = "src/repro/kernels/segment_aggregate.py:82"
AGG_REPLACES = "src/repro/kernels/hier_aggregate.py:45"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
FLASH_SIMT_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:131"
TOPK_SOURCE = "src/repro_torch/kernels/csrc/topk_gating.cu"
TOPK_REPLACES = "src/repro/kernels/topk_gating.py:53"

# by card name (NVIDIA data sheets, dense rates): memory bytes/s, bf16
# tensor-core FLOP/s, fp32 (non-tensor) FLOP/s
_RATES = (
    ("H200", (4.8e12, 989e12, 67e12)),
    ("H100 NVL", (3.9e12, 835e12, 60e12)),
    ("H100 PCIe", (2.0e12, 756e12, 51e12)),
    ("H100", (3.35e12, 989e12, 67e12)),
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
HEARTBEAT_KERNELS = ("hier_segment_aggregate", "hier_aggregate")
# measured numbers a kernel record carries where its phase took them
_EXTRA_KEYS = ("tflops", "library_kernel", "library_fused_ms", "library_fused_err", "library_fused_kernel",
               "wrapper_host_ms", "wrapper_ms", "wrapper_device_ops", "wrapper_busy_ms")


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


def _rates(name: str):
    """(memory bytes/s, bf16 FLOP/s, fp32 FLOP/s) of the card."""
    for key, rates in _RATES:
        if key in name:
            return rates
    raise RuntimeError(f"no rates known for card {name!r}")


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


def _wrapper_work(fn) -> dict:
    """Whole calls of a wrapper: the card's time per call when calls run
    back to back (``_device_ms``; a wrapper that synchronises leaves the
    card idle while the host catches up, and that time counts), and from
    ``torch.profiler`` the device operations (kernels, copies, fills) one
    call queues and their summed device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    iters = 50
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in device)
    return {
        "wrapper_ms": _device_ms(fn, iters=100, warmup=10)[0],
        "wrapper_device_ops": sum(e.count for e in device) / iters,
        "wrapper_busy_ms": busy_us / iters / 1e3 if busy_us > 0 else "not measured",
    }


def _sca_inputs(d_model: int):
    """The SCA edge FedAvg's inputs (N 18 over E 5 segments, D d_model,
    fp32) on the card, from seed 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    seg = rng.permutation(np.repeat(np.arange(5), [3, 4, 5, 3, 3]))
    dev = torch.device("cuda")
    x = torch.as_tensor(rng.standard_normal((len(seg), d_model)), dtype=torch.float32, device=dev)
    w = torch.as_tensor(rng.uniform(0.05, 1.0, len(seg)), dtype=torch.float32, device=dev)
    return x, torch.as_tensor(seg, dtype=torch.int32, device=dev), w, 5


def _sync_free(fn) -> bool:
    """Run ``fn`` once under ``torch.cuda.set_sync_debug_mode("error")``:
    a call that makes the host wait for the card raises there."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return True


def _close(got, want, tol: float) -> float:
    """Max |got - want| in fp32; raises unless |got - want| <= tol + tol*|want|."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not bool(torch.isfinite(g).all()) or bool((err > tol + tol * w.abs()).any()):
        raise AssertionError(f"kernel disagrees with its plain version: max |err| {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def _fmt(t: dict) -> str:
    return " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in t.items())


def _timings(kernel, wrapper, plain, library, nbytes: int, rate: float) -> dict:
    """The timed numbers of one kernel at one shape (fp32)."""
    ms, kernel_host_ms = _device_ms(kernel)
    return {
        "ms": ms,
        "plain_ms": _device_ms(plain)[0],
        "library_ms": _device_ms(library)[0],
        "bound_ms": nbytes / rate * 1e3,
        "bound_by": "bytes",
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
                wn = hier_segment_aggregate_ref(torch.eye(n, device=dev), seg, w, e)  # (E, N) weights
                t = _timings(
                    kernel=lambda: seg_mod._launch(x, seg, w, e),
                    wrapper=lambda: hier_segment_aggregate(x, seg, w, e),
                    plain=lambda: hier_segment_aggregate_ref(x, seg, w, e),
                    library=lambda: wn @ x,
                    nbytes=(n + e) * d * 4 + n * 8,
                    rate=rate,
                )
                t["sync_free"] = _sync_free(lambda: hier_segment_aggregate(x, seg64, w.double(), e))
                if timed == "main":
                    t.update(_wrapper_work(lambda: hier_segment_aggregate(x, seg, w, e)))
                    result["seg"].update(t)
                line += " " + _fmt(t)
            print(line, flush=True)
    # ids outside [0, E) belong to no segment on the card: the same result as
    # the plain version on the rows that remain
    for e, ids in ((5, [0, 7, 0, -1, 3, 5, 3, 9, 3]), (18, [(i % 19) - 1 for i in range(21)]),
                   (11, [(i * 7 % 13) - 1 for i in range(70)])):  # N > 32: three ballots of ids
        ids_t = torch.tensor(ids, device=dev)
        keep = (ids_t >= 0) & (ids_t < e)
        x = torch.as_tensor(rng.standard_normal((len(ids), 1000)), dtype=torch.float32, device=dev)
        w = torch.as_tensor(rng.uniform(0.05, 1.0, len(ids)), dtype=torch.float32, device=dev)
        got = hier_segment_aggregate(x, ids_t, w, e)
        err = _close(got, hier_segment_aggregate_ref(x[keep], ids_t[keep], w[keep], e), TOL["float32"])
        result["seg"]["max_abs_err"] = max(result["seg"]["max_abs_err"], err)
        print(f"kernel hier_segment_aggregate [ids outside [0, E)] N={len(ids)} D=1000 E={e} torch.float32: "
              f"max_abs_err={err:.3g}", flush=True)
    for n, d, timed in ((5, d_model, True), (4, 1000, False), (13, d_model, False), (18, d_model, False),
                        (32, 512, False)):
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
            if n == 18 and dtype == torch.float32:
                # the SCA segment call's 18 rows of x read by one level of
                # loads with nothing before them: a floor for that call
                wn = agg_mod._normalized_weights(w)
                line += f" ms={_device_ms(lambda: agg_mod._launch(x, wn))[0]:.4g} (same rows as the SCA segment call)"
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
                line += " " + _fmt(t)
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
    for name in HEARTBEAT_KERNELS:
        _require(counts[name] > 0, f"kernel {name} was not launched on the heartbeat path")
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
    _report_profile(prof, plain_wall, wall, "profile: round")


def _report_profile(prof, plain_wall: float, wall: float, label: str) -> None:
    """The card's busy share (kernel time over wall time; one stream) and
    the kernels that take the most device time."""
    import torch

    device = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in device)
    launches = sum(e.count for e in device)
    walls = f"wall {plain_wall:.4f}s unprofiled, {wall:.4f}s profiled"
    if busy_us <= 0:
        print(f"{label} {walls}; the trace holds no device time (not measured)", flush=True)
        return
    busy = busy_us / 1e6
    print(f"{label} {walls}; device busy {busy:.4f}s = {busy / plain_wall:.4f} of the unprofiled "
          f"run ({busy / wall:.4f} of the profiled one); device ops {launches}", flush=True)
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"{label}: {e.self_device_time_total / 1e3:.3f} ms x{e.count} {e.key[:90]}", flush=True)


def _attention_work(b: int, s: int, hq: int, hkv: int, d: int, window, elt: int):
    """(operations, bytes) causal attention must do and move: 4 * d
    operations per visible (query, key) pair and head (q.k and p.v), and
    q, k, v read once and o written once."""
    w = s if window is None else min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w  # sum over q of min(q + 1, w)
    return 4 * b * hq * d * pairs, (2 * b * s * hq * d + 2 * b * s * hkv * d) * elt


def _bound(ops: float, nbytes: float, peak: float, rate: float):
    """(bound_ms, bound_by): the larger of the operations and bytes times."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _flash_phase(rates) -> dict:
    """Phase 3, flash attention: each case against the plain version on the
    card, having launched its dtype's variant (bf16 ``wgmma``, fp32
    ``simt``); device times of the ``wgmma`` kernel at (a) the qwen3-14b
    serve prefill and (b) starcoder2-3b's heads at 8192 tokens with its
    4096 window, and of the SIMT kernel at the "fp32" case and at phase 7's
    shape (qwen3-14b widths in fp32), with the name of the CUDA kernel that
    ``scaled_dot_product_attention`` ran for each fp32 case."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.flash_attention import VARIANTS, _launch, flash_attention, flash_attention_ref

    rate, peak_bf16, peak_f32 = rates
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # label, B, S, Hq, Hkv, D, window, dtype, timed
        ("qwen3-14b prefill", 4, 2048, 40, 8, 128, None, bf16, "wgmma"),
        ("starcoder2-3b window", 1, 8192, 24, 2, 128, 4096, bf16, "window"),
        ("fp32", 2, 1024, 16, 4, 128, None, f32, "simt"),
        ("fp32 qwen3-14b widths (phase 7)", 4, 1536, 40, 8, 128, None, f32, "simt_phase7"),
        ("fp32 window < tile", 2, 300, 8, 2, 64, 7, f32, None),
        ("fp32 ragged tail", 3, 77, 6, 3, 32, 100, f32, None),
        ("fp32 smoke heads", 2, 130, 8, 2, 16, None, f32, None),
        ("fp32 phi3-mini heads", 1, 300, 32, 32, 96, None, f32, None),
        ("bf16 MQA", 2, 515, 8, 1, 128, 64, bf16, None),
        ("bf16 phi3-mini heads", 1, 300, 32, 32, 96, None, bf16, None),
        ("bf16 d 96 window", 2, 300, 8, 1, 96, 50, bf16, None),
        ("bf16 window < tile", 1, 1000, 8, 2, 128, 7, bf16, None),
        ("bf16 S 1000", 2, 1000, 5, 1, 64, None, bf16, None),
        ("bf16 S 77", 3, 77, 4, 2, 128, None, bf16, None),
        ("bf16 fused projection", 2, 300, 8, 2, 128, None, bf16, None),
    ]
    result, errs = {}, {"wgmma": 0.0, "simt": 0.0}
    for label, b, s, hq, hkv, d, window, dtype, timed in cases:
        if "fused" in label:  # q, k, v as views of one (B, S, Hq + 2 Hkv, D) projection
            qkv = torch.randn((b, s, hq + 2 * hkv, d), generator=gen, device=dev).to(dtype)
            q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
        else:
            q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        variant = VARIANTS[dtype]
        reset_launch_counts()
        got = flash_attention(q, k, v, window=window)
        _require(flash_attention.launches_by_variant[variant] == 1 and flash_attention.launches == 1,
                 f"flash case {label}: not one launch of the {variant} kernel ({flash_attention.launches_by_variant})")
        want = flash_attention_ref(q, k, v, window=window)
        torch.cuda.synchronize()
        err = _close(got, want, FLASH_TOL[str(dtype).split(".")[1]])
        errs[variant] = max(errs[variant], err)
        line = (f"kernel flash_attention [{label}] variant={variant} B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
                f"window={window} {dtype}: max_abs_err={err:.3g}")
        if timed:
            _require(torch.equal(got, flash_attention(q, k, v, window=window)),
                     f"flash case {label}: two launches differ")
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if window is None:
                library = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            else:  # an explicit band mask; kv repeated beforehand, outside the timed call
                pos = torch.arange(s, device=dev)
                band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
                kr, vr = (t.repeat_interleave(hq // hkv, dim=1) for t in (kt, vt))
                library = lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=band)
            ops, nbytes = _attention_work(b, s, hq, hkv, d, window, q.element_size())
            bound_ms, bound_by = _bound(ops, nbytes, peak_bf16 if dtype == bf16 else peak_f32, rate)
            t = {
                "ms": _device_ms(lambda: _launch(q, k, v, True, window), iters=20, warmup=3)[0],
                "plain_ms": _device_ms(lambda: flash_attention_ref(q, k, v, window=window), iters=3, warmup=1)[0],
                "library_ms": _device_ms(library, iters=20, warmup=3)[0],
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            t["tflops"] = ops / t["ms"] / 1e9
            if dtype == f32:
                # the call above falls back to unfused math for fp32 GQA; beside
                # it, PyTorch's fused fp32 kernel (memory-efficient attention),
                # which takes no GQA: kv repeated outside the timed call
                t["library_kernel"] = _cuda_kernel_names(library)
                kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kt, vt))
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    fused = lambda: F.scaled_dot_product_attention(qt, kr, vr, is_causal=True)
                    t["library_fused_ms"] = _device_ms(fused, iters=20, warmup=3)[0]
                    t["library_fused_err"] = float((fused().transpose(1, 2) - want).abs().max())
                    t["library_fused_kernel"] = _cuda_kernel_names(fused)
                del kr, vr
            result[timed] = t
            line += " " + _fmt(t)
        print(line, flush=True)
    for variant, err in errs.items():  # the worst case of each variant
        result[variant]["max_abs_err"] = err
    return result


def _cuda_kernel_names(fn) -> str:
    """The CUDA kernels one call of ``fn`` runs, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    return "; ".join(n[:120] for n in names) or "not measured (the trace holds no device kernel)"


def _topk_phase(rate: float) -> dict:
    """Phase 3, top-k gating: the kernel against its plain version on the
    card (1e-5), timed at granite-moe-3b-a800m's router shape (E 40, k 8)
    for 8192 tokens.  No single PyTorch call computes it: no library time."""
    import torch

    from repro_torch.kernels.topk_gating import _launch, topk_gating, topk_gating_ref

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    ties = torch.zeros((4, 40), device=dev)
    ties[1, ::3] = 1.0
    ties[2, 5] = 300.0  # every other probability underflows to 0
    cases = [
        ("granite-moe router", torch.randn((8192, 40), generator=gen, device=dev) * 2, 8, "main"),
        ("bf16", (torch.randn((8192, 40), generator=gen, device=dev) * 2).to(torch.bfloat16), 8, None),
        ("E 1000", torch.randn((300, 1000), generator=gen, device=dev) * 2, 8, None),
        ("ties and underflow", ties, 8, None),
        ("k > E", torch.randn((64, 33), generator=gen, device=dev), 40, None),
    ]
    result = {"max_abs_err": 0.0}
    for label, x, k, timed in cases:
        got = topk_gating(x, k)
        want = topk_gating_ref(x, k)
        torch.cuda.synchronize()
        err = _close(got, want, 1e-5)
        result["max_abs_err"] = max(result["max_abs_err"], err)
        line = f"kernel topk_gating [{label}] T={x.shape[0]} E={x.shape[1]} k={k} {x.dtype}: max_abs_err={err:.3g}"
        if timed:
            t = {
                "ms": _device_ms(lambda: _launch(x, k))[0],
                "plain_ms": _device_ms(lambda: topk_gating_ref(x, k))[0],
                "library_ms": None,
                "bound_ms": x.numel() * (x.element_size() + 4) / rate * 1e3,
                "bound_by": "bytes",
            }
            result.update(t)
            line += " " + _fmt(t)
        print(line, flush=True)
    return result


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device) for v in tree)
    return tree.to(device)


def _serve_card_vs_cpu() -> None:
    """Phase 4, serving: the qwen3-14b smoke config with the same parameters
    on the card and on the CPU, with the flash branch off and on."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import prefill
    from repro_torch.serving import Request, ServeEngine

    params = init_params(torch.Generator().manual_seed(0), get_smoke_config("qwen3-14b"))
    prompts = np.random.default_rng(0).integers(0, 256, (3, 100))
    for use_flash in (False, True):
        cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), use_flash=use_flash)
        logits, outs = {}, {}
        for d in ("cuda", "cpu"):
            p = _tree_to(params, d)
            with torch.inference_mode():
                logits[d] = prefill(p, cfg, torch.as_tensor(prompts, device=d), max_seq=128)[0].cpu()
            eng = ServeEngine(cfg, params=p, max_seq=128, device=d)
            outs[d] = [r.out for r in eng.run([Request(x.astype(np.int32), max_new_tokens=16) for x in prompts])]
        diff = float((logits["cuda"] - logits["cpu"]).abs().max())
        same = all(np.array_equal(a, b) for a, b in zip(outs["cuda"], outs["cpu"]))
        print(f"card-vs-cpu serve {cfg.name} use_flash={use_flash}: prefill logits max |diff| {diff:.3g}, "
              f"greedy tokens identical {same}", flush=True)
        _require(diff <= 1e-4, "card and CPU prefill logits disagree")
        _require(same, "card and CPU greedy tokens disagree")


def _serve_exactness() -> dict:
    """Phase 7: qwen3-14b widths cut to 2 layers, fp32, on the card.  Launch
    counts are zeroed just before and read just after; returns the fp32
    flash launches by variant (one per layer of every uniform prefill: the
    batch and the four solo requests)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.serving import Request, ServeEngine

    cfg = dataclasses.replace(get_config("qwen3-14b"), n_layers=2, dtype="float32", use_flash=True)
    params = init_params(torch.Generator("cuda").manual_seed(1), cfg)
    rng = np.random.default_rng(1)

    def serve(engine, prompts):
        return [r.out for r in engine.run([Request(p, max_new_tokens=8) for p in prompts])]

    flash = ServeEngine(cfg, params=params, max_seq=1600, device="cuda")
    plain = ServeEngine(dataclasses.replace(cfg, use_flash=False), params=params, max_seq=1600, device="cuda")
    uniform = list(rng.integers(0, cfg.vocab_size, (4, 1536)).astype(np.int32))
    reset_launch_counts()
    a = serve(flash, uniform)
    _require(flash_attention.launches_by_variant["simt"] == cfg.n_layers,
             f"fp32 uniform prefill: flash launches by variant {flash_attention.launches_by_variant}, "
             f"not {cfg.n_layers} simt")
    b = serve(plain, uniform)
    same = all(np.array_equal(x, y) for x, y in zip(a, b))
    print(f"serve exact: {cfg.name} 2 layers fp32, uniform 4 x 1536: use_flash on/off tokens identical {same}", flush=True)
    _require(same, "use_flash on and off give different tokens in fp32")
    ragged = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (1536, 1000, 777, 1200)]
    batched = serve(flash, ragged)
    for i, p in enumerate(ragged):
        solo = serve(flash, [p])[0]
        _require(np.array_equal(batched[i], solo), f"ragged row {i} (len {len(p)}) differs from solo")
    variants = dict(flash_attention.launches_by_variant)
    print("serve exact: ragged batch (1536, 1000, 777, 1200) token-identical to each request served alone; "
          f"flash launches by variant {json.dumps(variants)}", flush=True)
    del flash, plain, params
    torch.cuda.empty_cache()
    return variants


def _serve_path():
    """Phase 8: qwen3-14b at full width through ServeEngine on the card."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, launch_counts, reset_launch_counts
    from repro_torch.models.transformer import prefill
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.telemetry import Telemetry

    cfg = dataclasses.replace(get_config("qwen3-14b"), use_flash=True)
    t0 = time.perf_counter()
    tel = Telemetry()
    engine = ServeEngine(cfg, max_seq=2080, seed=0, device="cuda", telemetry=tel)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(engine.params))
    print(f"serve: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} {cfg.dtype}, {n_params} parameters "
          f"drawn in {time.perf_counter() - t0:.3f}s; memory allocated {torch.cuda.memory_allocated()} bytes", flush=True)
    rng = np.random.default_rng(0)
    engine.run([Request(rng.integers(0, cfg.vocab_size, 64).astype(np.int32), max_new_tokens=2)])  # warm-up

    def spans():
        pre = [s for s in tel.tracer.spans if s.name == "prefill"][-1]
        dec = [s for s in tel.tracer.spans if s.name == "decode"][-1]
        return pre, dec

    prompts = rng.integers(0, cfg.vocab_size, (4, 2048)).astype(np.int32)
    reqs = [Request(p, max_new_tokens=32) for p in prompts]
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    engine.run(reqs)
    torch.cuda.synchronize()
    counts = launch_counts()
    variants = dict(flash_attention.launches_by_variant)
    pre, dec = spans()
    print(f"serve: uniform 4 x 2048, 32 new tokens: prefill {pre.duration:.4f}s, decode {dec.attrs['steps']} steps "
          f"{dec.duration:.4f}s = {dec.attrs['tokens'] / dec.duration:.2f} tok/s, all tokens "
          f"{(pre.attrs['tokens'] + dec.attrs['tokens']) / (pre.duration + dec.duration):.2f} tok/s; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes", flush=True)
    print(f"serve: launches {json.dumps(counts)}; flash by variant {json.dumps(variants)}", flush=True)
    _require(counts["flash_attention"] == cfg.n_layers,
             f"{counts['flash_attention']} flash launches, not one per layer of the prefill ({cfg.n_layers})")
    _require(variants["wgmma"] == cfg.n_layers, f"flash launches by variant {variants}: not all {cfg.n_layers} wgmma")
    for r in reqs:
        _require(r.out.shape == (32,) and 0 <= r.out.min() and r.out.max() < cfg.vocab_size, "bad tokens")

    lens = np.concatenate([[2048], rng.integers(1500, 2048, 3)])
    ragged = [Request(rng.integers(0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=32) for n in lens]
    reset_launch_counts()
    engine.run(ragged)
    torch.cuda.synchronize()
    pre, dec = spans()
    print(f"serve: ragged {lens.tolist()}, 32 new tokens: prefill {pre.duration:.4f}s, decode "
          f"{dec.attrs['tokens'] / dec.duration:.2f} tok/s; flash launches {launch_counts()['flash_attention']}", flush=True)
    _require(launch_counts()["flash_attention"] == 0, "the pad-mask prefill launched the flash kernel")

    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    toks = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        lf = prefill(engine.params, cfg, toks, max_seq=2048)[0]
        lp = prefill(engine.params, plain_cfg, toks, max_seq=2048)[0]
    _require(bool(torch.isfinite(lf).all() and torch.isfinite(lp).all()), "non-finite prefill logits")
    diff = float((lf - lp).abs().max())
    argmax_same = int((lf.argmax(-1) == lp.argmax(-1)).sum())
    del lf, lp
    plain = ServeEngine(plain_cfg, params=engine.params, max_seq=2080, device="cuda")
    plain_out = [r.out for r in plain.run([Request(p, max_new_tokens=32) for p in prompts])]
    agree = [int(np.sum(np.cumprod(a == b))) for a, b in zip((r.out for r in reqs), plain_out)]
    print(f"serve: bf16 use_flash on vs off, same params: prefill logits max |diff| {diff:.4g}, first tokens "
          f"equal {argmax_same}/4, leading tokens equal per row {agree} of 32", flush=True)

    short = [Request(p, max_new_tokens=5) for p in prompts]
    engine.run(short)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(short)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(short)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report_profile(prof, plain_wall, wall, "serve profile: prefill + 4 decode steps")
    return counts, variants


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _build_report(log: str, so) -> None:
    """Each kernel's registers and spills from ``-Xptxas=-v`` (every kernel
    must show 0 spills), the fp32 flash kernel's tile (must equal
    ``SIMT_TILE``), and the tensor-core (``HGMMA``) and TMA (``UTMALDG``,
    ``UTMASTG``) instructions in the ``wgmma`` flash kernel's SASS: both
    must be there."""
    from repro_torch.kernels.build import sass_instruction_counts
    from repro_torch.kernels.flash_attention import SIMT_TILE, simt_kernel_tile

    tile = simt_kernel_tile()
    print(f"build: flash_attention_kernel tile {tile} (query rows, key rows)", flush=True)
    _require(tile == SIMT_TILE, f"the fp32 flash kernel's tile {tile} is not SIMT_TILE {SIMT_TILE}")

    arg_names = {"13__nv_bfloat16": "bf16", "f": "f32", "i": "int32", "l": "int64"}
    name, checked = None, set()
    for line in log.splitlines():
        m = re.search(r"(segment_aggregate_kernel|aggregate_kernel|flash_attention_kernel|"
                      r"flash_attention_wgmma_kernel|topk_gating_kernel)I(.+?)E+v", line)
        if m:
            args = re.findall(r"13__nv_bfloat16|Li\d+|[fil]", m.group(2))
            name = f"{m.group(1)}<{','.join(arg_names.get(a, a[2:]) for a in args)}>"
        elif name and ("registers" in line or "spill" in line):
            print(f"build: {name}: {line.split(':', 1)[-1].strip()}", flush=True)
            if "spill" in line:
                _require(" 0 bytes spill stores, 0 bytes spill loads" in line, f"{name} spills registers")
                checked.add(name)
    simt = sorted(n for n in checked if n.startswith("flash_attention_kernel<"))
    _require(len(simt) == 5, f"spills checked for {simt}, not the 5 fp32 flash instantiations")
    counts = sass_instruction_counts(so, "flash_attention_wgmma_kernel", ("HGMMA", "UTMALDG", "UTMASTG"))
    _require(len(counts) == 3, f"expected 3 wgmma flash instantiations in the SASS, found {len(counts)}")
    for kernel, ops in counts.items():
        d = re.search(r"wgmma_kernelILi(\d+)E", kernel)
        print(f"build: flash_attention_wgmma_kernel<{d.group(1) if d else '?'}> SASS {json.dumps(ops)}", flush=True)
        _require(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0, f"{kernel}: no HGMMA or no UTMALDG in its SASS")


def _segment_wrapper_only(root: Path) -> int:
    """``--segment-wrapper ROOT``: only the segment wrapper's whole calls at
    the SCA edge FedAvg shape (``_wrapper_work`` and host ms), for the port
    under ``ROOT/src``, built there; prints one JSON line.  Alternating two
    trees (a parent commit unpacked under ``build/``, say) in one run
    compares them on one card."""
    import torch

    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch.federated.programs import CNNProgram
    from repro_torch.kernels import hier_segment_aggregate, hier_segment_aggregate_ref
    from repro_torch.utils.tree import tree_num_params

    _require(Path(repro_torch.__file__).resolve().is_relative_to(root), f"repro_torch not imported from {root}")
    d_model = tree_num_params(CNNProgram().init(torch.Generator().manual_seed(0)))
    x, seg, w, e = _sca_inputs(d_model)
    call = lambda: hier_segment_aggregate(x, seg, w, e)  # noqa: E731
    err = _close(call(), hier_segment_aggregate_ref(x, seg, w, e), TOL["float32"])
    record = {"segment_wrapper": str(root), "card": _smi(), "N": 18, "E": e, "D": d_model, "max_abs_err": err,
              **_wrapper_work(call), "wrapper_host_ms": _host_ms(call)}
    print(json.dumps(record), flush=True)
    return 0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    if argv:
        if len(argv) != 2 or argv[0] != "--segment-wrapper":
            print("usage: python3 chip_smoke.py [--segment-wrapper ROOT]", file=sys.stderr)
            return 2
        return _segment_wrapper_only(Path(argv[1]).resolve())
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails when the package is not beside the script)
    from repro_torch.kernels.build import build

    t_start = time.perf_counter()
    smi = _smi()
    name = torch.cuda.get_device_name(0)
    rates = _rates(name)
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    so, log = build()
    print(f"build: {so.name} in {time.perf_counter() - t0:.3f}s", flush=True)
    _build_report(log, so)
    from repro_torch.federated.programs import CNNProgram
    from repro_torch.utils.tree import tree_num_params

    d_model = tree_num_params(CNNProgram().init(torch.Generator().manual_seed(0)))
    kern = _kernel_phase(rates[0], d_model)
    kern["flash"] = _flash_phase(rates)
    kern["topk"] = _topk_phase(rates[0])
    _card_vs_cpu()
    _serve_card_vs_cpu()
    counts, sc, lam = _main_path()
    _profile_round(sc, lam)
    exact_variants = _serve_exactness()
    serve_counts, serve_variants = _serve_path()
    flash = kern["flash"]
    record = []
    for k, fn_name, source, replaces, launches, variant in (
        (kern["seg"], "hier_segment_aggregate", AGG_SOURCE, SEG_REPLACES, counts["hier_segment_aggregate"], None),
        (kern["agg"], "hier_aggregate", AGG_SOURCE, AGG_REPLACES, counts["hier_aggregate"], None),
        (flash["wgmma"], "flash_attention", FLASH_SOURCE, FLASH_REPLACES, serve_variants["wgmma"], "wgmma"),
        (flash["simt"], "flash_attention", FLASH_SIMT_SOURCE, FLASH_REPLACES, exact_variants["simt"], "simt"),
        (kern["topk"], "topk_gating", TOPK_SOURCE, TOPK_REPLACES, serve_counts["topk_gating"], None),
    ):
        if variant == "simt":  # timed at phase 7's shape, where its launches are counted
            k = {**flash["simt_phase7"], "max_abs_err": k["max_abs_err"]}
        entry = {
            "name": fn_name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        }
        if variant:
            entry["variant"] = variant
        entry.update({key: k[key] for key in _EXTRA_KEYS if key in k})
        if variant == "simt":
            entry["shape"] = "B 4, S 1536, Hq 40, Hkv 8, d 128, fp32 (phase 7)"
            entry["fp32_case"] = {
                "shape": "B 2, S 1024, Hq 16, Hkv 4, d 128, fp32",
                **{key: flash["simt"][key] for key in
                   ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", *_EXTRA_KEYS) if key in flash["simt"]},
            }
        record.append(entry)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all", flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(_smi(), flush=True)
    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
