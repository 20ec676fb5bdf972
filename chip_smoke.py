#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --wrappers ROOT   # the small kernels and their whole wrapper calls only
    python3 chip_smoke.py --adam            # the build and phase 3's adam_update line only

Phases, each of which raises (and the script exits non-zero) on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch version;
2. the kernel build (one ``nvcc`` per source, side by side, linked into
   ``build/repro_torch/librepro_torch-<hash>.so``), with its seconds,
   each kernel's registers and spills (every kernel must show 0 spills),
   the fp32 flash kernel's tile (must equal ``SIMT_TILE``),
   ``hier_aggregate``'s layout at phase 3's cloud-reduce shape (threads
   and blocks, columns per thread, rows whose loads are in flight
   together), and the ``HGMMA`` (tensor-core)
   and ``UTMALDG`` (TMA load) instructions in the ``wgmma`` flash kernel's
   SASS;
3. the launch floor (an empty launch, ``torch.cuda._sleep(0)``, timed as
   the kernels are), then every kernel against its plain PyTorch version
   on the card, with the kernel's, the plain version's and one PyTorch
   library call's device times (CUDA events over back-to-back launches)
   beside the least time the card could take (``bound_ms``): the FedAvg
   reductions at the heartbeat path's shapes, ``hier_aggregate`` at the
   cloud reduce (N 5), at the host pipeline's largest edge FedAvg (N = the
   most EUs on one edge under EARA-SCA) and at each async flush size (N 1-6)
   (fp32 1e-5, bf16 2e-2; zero
   total weight writes zeros), the segment kernel also with ids outside
   [0, E) (which belong to no segment on the card), both at the streaming
   engine's shapes (a cohort of N 256 into E 8; the cloud reduce at N 8)
   and at phase 6e's groups' shapes (the CNN's edge FedAvg N 12 and the
   MLP's N 6 into E 5, the MLP's cloud reduce N 5 at D 12,357), both
   wrappers' whole
   calls (the card's time per call back to back, the device operations
   one call queues and their device time, the host time) and a run under
   ``torch.cuda.set_sync_debug_mode("error")``;
   flash attention, bf16 on the ``wgmma`` kernel, at the qwen3-14b serve
   prefill, at starcoder2-3b's widths with its 4096 window biting and at
   granite-moe-3b-a800m's prefill (B 4, S 2048, Hq 24, Hkv 8, d 64), fp32
   on the SIMT kernel at its own case and at phase 7's shape (with the name
   of the CUDA kernel the library call ran), plus untimed cases (d 96,
   windows below the tile, ragged lengths, a fused projection's views; fp32
   2e-5, bf16 2e-2), each checked to have launched its dtype's variant;
   top-k gating (1e-5; bit for bit on ties and underflow and at phase 9's
   shapes) timed at the granite-moe router width (E 40, k 8) for phase
   9a's decode (T 4), phase 9b's prefill (T 2048) and 8192 tokens, and at E
   128 and 1000, beside softmax -> topk -> scatter -> divide as a
   yardstick; ``adam_update`` at phi3-mini's edge replica as the LM
   benchmark cell holds it (8 layers, 12 leaves, bf16 p and g, fp32
   moments): two steps of ``adam(1e-3).update_`` (one launch a leaf a
   step) against the plain version, 0 differing elements, then the (8,
   8192, 3072) MLP stack and the whole replica timed beside the bound (22
   bytes an element), the plain sliced version and ``torch._fused_adam_``;
4. card against CPU: the heartbeat sync engine (scale 0.02, two cloud
   rounds), the streaming engine (a lazy population of 120 over 4 edges, a
   cohort of 24, two rounds), and the qwen3-14b smoke config served with
   the same parameters (prefill logits 1e-4, identical greedy tokens);
5. the heartbeat path at full size: ``build_scenario("heartbeat")`` and
   ``assign("eara-sca")`` (built before phase 3), ``simulate(engine="sync",
   pipeline="device", cloud_rounds=5)``, then one cloud round under
   ``assign("eara-dca")``; launch counts are zeroed just before and read
   just after;
6. two more SCA cloud rounds on a fresh engine, the second timed, then
   one under ``torch.profiler``: wall times, the card's busy share and the
   kernels that take the most device time;
6b. the same scenario on every engine: ``engine="reference"`` (the
   readable simulator), ``engine="sync", pipeline="host"`` and
   ``pipeline="device"``, 2 cloud rounds each, each run's launch counts
   zeroed just before and read just after (none under the simulator;
   ``hier_aggregate`` once per edge FedAvg, DCA start and cloud reduce on
   the host pipeline; the segment kernel only on the device pipeline),
   per-round accuracy within 2 test samples, parameters within 5e-3 and
   equal accountant totals; one host-pipeline round under EARA-DCA; one
   round with ``track_divergence``; ``centralized(2)``; the MLP and
   16-bit FedSGD programs for one round on both pipelines (FedSGD's uplink
   half the CNN's);
6c. the async engine, compression and faults at full size (launch counts
   zeroed just before and read just after each run): async at
   ``quorum=1.0, staleness_decay=1.0`` for 2 rounds, held to the device
   pipeline (accuracy within 2 test samples, parameters within 5e-3); async
   at its defaults for 2 rounds of ``HFLSchedule(1, 2)`` (seconds per
   round, simulated seconds, ``hier_aggregate`` launches equal to the
   engine's own count of flushes, DCA starts and cloud reduces, the flush
   sizes, the weight uploads); top-k 5% for one round on every engine (the
   uplink is the spec's bits per upload, accuracy above chance); the chaos
   fault spec of ``tests/test_faults.py`` for 2 rounds on every engine (the
   simulator and both sync pipelines with identical accuracy and equal
   accountant totals, async with retried uploads);
6d. streaming populations at full width: ``build_scenario("heartbeat",
   lazy=True, n_eus=1_000_000, n_edges=8)`` (build seconds), one warm-up
   round, then 3 cloud rounds of ``StreamSyncEngine`` with
   ``CohortSpec(size=256, seed=0)`` (seconds per round, clients per
   second, page hits, misses and evictions, the paged store's device bytes,
   peak device memory above the run's baseline; launch counts zeroed just
   before and read just after: one segment and one ``hier_aggregate``
   launch a round), one more round timed for its paging seconds and one
   under ``torch.profiler`` (the card's busy share); the same
   at 100,000 clients (peak memory at 1M within 1.10x of it); the 1M run
   with ``page_slots=256`` (evictions, bit-identical result); at 2,048
   clients the stream engine against the sync device pipeline with
   ``cohort=`` on the materialized population (accuracy within 2 test
   samples, parameters within 1e-4, equal accounting); one sync-device
   round with ``server_momentum=0.9`` and ``cohort=``;
6e. heterogeneous models at full width: ``build_scenario("heartbeat",
   model_mix={"cnn": 12, "mlp": 6})`` (built before phase 3) and
   ``assign("eara-sca")``, each run's launch counts zeroed just before and
   read just after: the device pipeline for 1 round (held to the readable
   simulator's 1 round) and 2 timed rounds (held to the host pipeline's 2:
   accuracy within 2 test samples, parameters within 5e-3, equal
   accountant totals), 2 segment and 2 ``hier_aggregate`` launches a
   device round, one ``hier_aggregate`` per (group, edge) cell with
   uploads plus 2 a host round; async at ``quorum=1.0,
   staleness_decay=1.0`` and at its defaults for 1 round (its flushes
   plus 2 launches); ``final_params`` keyed ``{"cnn", "mlp"}``; the fuse
   timed by CUDA events inside every sync round, then alone on the card
   against the CPU (1e-5) and under ``torch.profiler`` (device ops); one
   device-pipeline round under ``torch.profiler`` (busy share);
6f. telemetry at full size (every number printed with the card's name and
   power limit): heartbeat EARA-SCA on the device pipeline with telemetry
   on, off and on again in turns (1 warm-up and 2 timed rounds each; launch
   counts zeroed just before each run and read just after): bit-equal
   parameters and equal accuracies, the five artifacts (``trace.json``,
   ``trace.jsonl``, ``rounds.jsonl``, ``metrics.json``, ``summary.txt``)
   with the reference's span names, the ``cohort_epoch_flat`` FLOPs equal
   to the count for the same shapes on the CPU, each round record's
   ``kernel_launches`` equal to phase 5's (1 segment and 1 aggregate a
   round), each round's span totals by name, the spans and metric updates
   a round, seconds per round on against off, and the host seconds
   ``jit_cost`` spends (the process's first count and a fresh count); one
   telemetry-on device round under ``torch.cuda.set_sync_debug_mode(
   "error")``; the mixed population for one round on the device pipeline
   and on async (the ``kd_fuse`` span, ``kd_loss``, the async engine's
   simulated-time track on pid 2); one 1M-client streaming round with the
   page gauges;
6g. serving under traffic and the LM population (every number printed
   with the card's name and power limit): heartbeat EARA-SCA on the device
   pipeline for 3 rounds with ``serve=TrafficSpec(queries=1024,
   batch=128)`` and without (bit-equal parameters and history, staleness 0,
   each round's ``serve_acc`` within 2/1024 of the same model served on
   the CPU; seconds a round on and off, ``serve_qps``), again with
   ``swap_every=2`` (staleness 0, 1, 0), one async round at its defaults
   serving; ``build_scenario("lm")`` at ``scale=1.0`` under EARA-SCA on
   the device pipeline for 3 rounds serving ``TrafficSpec(queries=256,
   batch=64)`` (launch counts zeroed just before and read just after: 1
   segment and 1 ``hier_aggregate`` a round; seconds a round), the same on
   the CPU (parameters within 5e-3, next-token accuracy within 1e-3), a
   telemetry-on run (span seconds of round 2) and a round under
   ``torch.profiler`` (busy share, top kernels), one host-pipeline round
   (``_expected_aggregates`` launches), and both
   FedAvg kernels at its shapes (segment N 12 into E 4, aggregate N 4,
   D 20,640 fp32) against their plain versions (1e-5), timed beside them
   and ``wmat @ x`` / ``wn @ x``;
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
   decode steps under ``torch.profiler``;
9. the MoE family, every number printed with the card's name and power
   limit, and the phase's seconds: (a) ``ServeEngine`` on
   granite-moe-3b-a800m at published widths (32 layers, d_model 1536,
   24/8 heads, 40 experts top-8, d_ff 512, vocab 49,155, bf16, random
   weights from seed 0, ``use_flash=True``; its parameter count and
   bytes): one 4 x 2048 prefill (launch counts zeroed just before and read
   just after: 32 ``wgmma`` flash launches, no ``topk_gating``, its 8,192
   tokens taking the capacity dispatch) and one decode step (32
   ``topk_gating``, no flash), then the uniform batch with 32 new tokens
   each (prefill seconds, decode tokens/s, peak memory; one flash launch a
   layer, one ``topk_gating`` a layer and decode step), ``use_flash=False``
   on the same parameters (prefill-logit difference, token agreement), and
   one prefill and 4 decode steps under ``torch.profiler``; (b) its widths
   cut to 2 layers in fp32: a uniform 4 x 512 batch (the dense dispatch)
   gives the same tokens with ``use_flash`` on and off (2 ``topk_gating``
   launches a prefill and a decode step), a ragged batch under 4096 tokens
   the same tokens as its requests alone; (c) the granite-moe and dbrx
   smoke configs served card against CPU (prefill logits 1e-4, identical
   greedy tokens), and ``MoEProgram.loss`` and its gradient (1e-5, 1e-4);
   (d) ``build_scenario("lm", model="moe")`` at ``scale=1.0`` under
   EARA-SCA, 3 device-pipeline rounds (1 segment and 1 ``hier_aggregate``
   launch a round; seconds a round) against the same 3 on the CPU
   (parameters 5e-3, next-token accuracy 1e-3, equal accounting), then
   ``model_mix={"lm": 8, "moe": 4}`` for 1 device round (2 + 2 launches)
   held to the host pipeline (accuracy within 2 test samples, parameters
   5e-3, equal accounting);
10. the recurrent families (Mamba and RWKV), every number printed with the
   card's name and power limit, and the phase's seconds: (a)
   ``ServeEngine`` on rwkv6-7b at published widths (32 layers, d_model
   4096, 64 heads of 64, d_ff 14,336, vocab 65,536, bf16, random weights
   from seed 0; its 6,997,811,200 parameters and their bytes): one 4 x
   2048 prefill and one decode step (launch counts zeroed just before and
   read just after: no flash, no ``topk_gating``), the uniform batch with
   32 new tokens each (prefill seconds, decode tokens/s, peak memory), a
   ragged batch of lengths that are multiples of 64 through the
   exact-length buckets (token-identical to each request alone), one
   prefill and 4 decode steps under ``torch.profiler``, one RWKV mixer
   layer and its decode step timed alone; (b) the jamba and rwkv6 smoke
   configs served card against CPU (prefill logits 1e-4, identical greedy
   tokens, uniform and ragged), jamba with ``use_flash=True`` (one fp32
   flash launch per attention layer and prefill bucket, one
   ``topk_gating`` per MoE layer and bucket or decode step); (c) one Mamba
   mixer at jamba-1.5-large-398b's widths (d_model 8192, d_state 16, bf16):
   a 1 x 2048 chunked prefill against stepping its decode step over the
   same tokens (outputs 2e-2, state 1e-3 relative), both timed; (d)
   ``build_scenario("lm", model="mamba" | "rwkv")`` at ``scale=1.0`` under
   EARA-SCA, 3 device-pipeline rounds each (1 segment and 1
   ``hier_aggregate`` launch a round; seconds a round), mamba's 3 and
   rwkv's first (its training amplifies rounding: ``CPU_ROUNDS``) against
   the same on the CPU (parameters 5e-3, next-token accuracy 1e-3, equal
   accounting), both FedAvg kernels at their shapes, then
   ``model_mix={"lm": 6, "mamba": 3, "rwkv": 3}`` for 1 device round (3 +
   3 launches) held to the host pipeline (accuracy within 2 test samples,
   parameters 5e-3, equal accounting);
11. encdec serving and LM training at full width, every number printed
   with the card's name and power limit, and the phase's seconds: (a)
   ``ServeEngine`` on whisper-tiny at published widths (4 + 4 layers,
   d_model 384, 6 heads of 64, vocab 51,865, 1500 audio frames, bf16,
   random weights from seed 0, ``use_flash=True``; its 36,448,128
   parameters and 72,896,256 bytes): a uniform batch of 4 prompts of 384
   tokens with 64 new each (launch counts zeroed just before and read just
   after: 4 ``wgmma`` flash launches, one per decoder layer of the prefill,
   none in the encoder or the decode; prefill seconds, decode tokens/s,
   peak memory, the serve spans' analytic FLOPs), ``use_flash=False`` on
   the same parameters (prefill-logit difference, token agreement), a
   ragged batch through the pad-mask path (no flash launch; each row's
   agreement with its request alone), one prefill and 4 decode steps
   under ``torch.profiler``, and the same weights in fp32 (flash on = off,
   ragged = solo, token for token); (b) whisper-tiny's smoke config card against
   CPU (prefill logits 1e-4, identical greedy tokens, uniform and ragged);
   (c) phi3-mini-3.8b at published widths (3,821,079,552 bf16 parameters)
   trained by ``make_train_step`` with the in-place ``adam`` for 3 steps
   of 1 x 1024 tokens (each step's seconds, loss and gradient norm, peak
   memory; no kernel launch), and one more under ``torch.profiler``; (d) ``make_train_step`` card against CPU on
   the qwen3-14b, granite-moe and whisper smoke configs (fp32, 3 steps,
   ``grad_accum=2``, ``remat=True``), a checkpoint round trip on the card
   (fp32 and bf16, bit-exact) and (e) the kernels' no-gradient guard on
   CUDA tensors; (f) ``launch.serve --arch whisper-tiny --full-config`` and
   ``launch.train --arch phi3-mini-3.8b --full-config --steps 3 --batch 1
   --seq 1024``, each in its own process;
12. the edge mesh, every number printed with the card's name and power
   limit, and the phase's seconds: (a) the heartbeat scenario of phase 5
   under EARA-SCA with ``HFLSchedule(1, 2)`` for 2 cloud rounds on the
   device pipeline and through ``simulate(engine="sync", pipeline="mesh",
   mesh=1)`` in this process (a one-rank NCCL group; launch counts zeroed
   just before and read just after each run): per-round accuracy and
   final parameters bit-equal, the same launches, equal to the engine's
   own count of edge FedAvg calls and cloud reduces, ``comm_report()``
   (no cross-edge byte), seconds a cloud round of both; (b) the same run
   at ``mesh=5``, one edge a rank, five ranks spawned on this card
   (``repro_torch.distributed.run_ranks``, gloo; they load the library
   phase 2 built): every rank's history and parameters identical, against
   (a) accuracy within 2 test samples and parameters within 1e-5, the
   ledger's structure (no collective byte in the edge programs, the cloud
   reduce once a cloud round, cross-edge bytes within 5% of one payload a
   cloud round and of half of it an edge round), each rank's peak memory
   and launches, seconds a cloud round (the ranks share one card: a
   topology and accounting check, not a speedup); (c)
   ``make_hfl_train_step`` (E 2, ``adam(1e-3)``) card against CPU on the
   phi3-mini smoke config (fp32; local, local, sync: parameters 5e-4,
   losses 1e-5, replicas equal after the sync, one ``hier_aggregate`` a
   leaf in the sync), then at phi3-mini-3.8b's widths cut to 4 layers
   (bf16, 1 x 512 tokens an edge): the seconds of a local and of a sync
   step, peak memory.

The serve phases (8, 9a, 10a, 11a) serve their timed shapes once before
timing them, so the serve spans' analytic cost (counted on meta copies
the first time a shape is seen, inside its span) is not in the times.

With ``--wrappers ROOT`` the script times only the launch floor and the
segment, aggregate and top-k kernels and their wrappers' whole calls, for
the port under ``ROOT/src``, and prints one JSON line: run it on two trees
in turns to compare them on one card.  With ``--paths ROOT`` it times only
the heartbeat round (phase 6's, telemetry off) and the full-width serve
(phase 8's uniform batch: prefill seconds, decode tokens per second) for
the port under ``ROOT/src``, and prints one JSON line, for the same use.

Each phase group's seconds are printed as it ends (``chip_smoke: phase ...``).
The last lines are a JSON ``kernels`` record, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
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
ADAM_SOURCE = "src/repro_torch/kernels/csrc/adam.cu"
ADAM_REPLACES = "none: the reference's Adam is jnp (src/repro/training/optimizers.py), fused by XLA"
# the in-place Adam at the benchmark's phi3 shapes: phi3-mini-3.8b cut to 8
# layers, one edge replica (12 leaves), bf16 parameters and gradients, fp32
# moments; its MLP stack (8, 8192, 3072) is the largest leaf
ADAM_LAYERS, ADAM_LEAVES, ADAM_PARAMS = 8, 12, 1_103_023_104
ADAM_STACK = (8, 8192, 3072)

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
# the async engine's flush sizes at heartbeat scale (anchor + up to 5 of an
# edge's reporters), timed in phase 3 beside the cloud reduce's N 5
ASYNC_FLUSH_NS = (1, 2, 3, 4, 5, 6)
# the streaming engine at full size (phase 6d): a cohort of 256 a round over
# 8 edges, so its edge FedAvg is one segment launch of N 256 into E 8 and
# its cloud reduce one hier_aggregate launch of N 8
STREAM_COHORT, STREAM_EDGES = 256, 8
# phase 6e's heterogeneous population: 12 CNN EUs and 6 MLP EUs
MIX = {"cnn": 12, "mlp": 6}
# measured numbers a kernel record carries where its phase took them
_EXTRA_KEYS = ("tflops", "library_kernel", "library_fused_ms", "library_fused_err", "library_fused_kernel",
               "wrapper_host_ms", "wrapper_ms", "wrapper_device_ops", "wrapper_busy_ms", "floor_ms", "floor_kind",
               "yardstick_ms", "other_shapes", "layout", "host_edge")


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


def _launch_floor() -> dict:
    """The device time of an empty launch back to back (``_device_ms``):
    PyTorch's one-thread spin kernel for 0 cycles, ``torch.cuda._sleep(0)``.
    No kernel can take less in this timing."""
    import torch

    return {"floor_ms": _device_ms(lambda: torch.cuda._sleep(0))[0], "floor_kind": "torch.cuda._sleep(0)"}


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


def _kernel_phase(rate: float, d_model: int, host_n: int, mix_ids) -> dict:
    """Phase 3: each kernel against its plain version on the card, and the
    timings at the main path's shapes (``hier_aggregate`` also at
    ``host_n`` rows, the host pipeline's largest edge FedAvg).  ``mix_ids``
    is ``((ids, D), ...)``: the segment ids (pair edges) and width of each
    architecture group of phase 6e's mixed population, whose edge FedAvg
    and cloud reduce (N 5) are timed at those shapes too."""
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
    # the streaming engine's edge FedAvg: a cohort of 256 rows into 8 edges
    stream_ids = rng.integers(0, STREAM_EDGES, STREAM_COHORT)
    seg_cases = [
        ("edge FedAvg (SCA)", sca, 5, d_model, "main"),
        ("DCA starts", dca, 18, d_model, "timed"),
        ("stream edge FedAvg", stream_ids, STREAM_EDGES, d_model, "stream"),
        # the edge mesh at MESH_RANKS ranks (phase 12b): one edge a rank, its largest membership into E 1
        ("mesh rank edge FedAvg", np.zeros(host_n, int), 1, d_model, "mesh"),
        *((f"mix group edge FedAvg (D {d})", ids, 5, d, "mix") for ids, d in mix_ids),
        ("ragged", np.array([0, 0, 0, 1, 3, 3, 3, 3, 4]), 5, 257, None),
        ("one segment", np.zeros(9, int), 1, 1000, None),
        ("own segment + empty", np.arange(9), 10, 1000, None),
    ]
    floor = _launch_floor()
    print(f"kernel launch floor: {_fmt(floor)}", flush=True)
    result = {"seg": {"max_abs_err": 0.0}, "agg": {"max_abs_err": 0.0}, "floor": floor}
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
                    t.update(floor)
                    t.update(_wrapper_work(lambda: hier_segment_aggregate(x, seg, w, e)))
                    result["seg"].update(t)
                elif timed == "stream":
                    result["seg"]["stream"] = {"N": n, "E": e, "D": d, "max_abs_err": err, **t}
                elif timed == "mesh":
                    result["seg"]["mesh"] = {"N": n, "E": e, "D": d, "max_abs_err": err, **t}
                elif timed == "mix":
                    result["seg"].setdefault("mix", []).append({"N": n, "E": e, "D": d, "max_abs_err": err, **t})
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
    flush_ns = [(n, d_model, "async flush") for n in ASYNC_FLUSH_NS if n not in (5, host_n)]
    for n, d, timed in ((5, d_model, "cloud reduce"), (host_n, d_model, "host edge FedAvg"), *flush_ns,
                        (STREAM_EDGES, d_model, "stream cloud reduce"),
                        *((5, d, "mix cloud reduce") for _, d in mix_ids if d != d_model),
                        (4, 1000, None), (9, d_model, None), (13, d_model, None),
                        (18, d_model, None), (32, 512, None), (40, 1000, None)):
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL[str(dtype).split(".")[1]]
            x = torch.as_tensor(rng.standard_normal((n, d)), dtype=dtype, device=dev)
            w = torch.as_tensor(rng.uniform(0.05, 1.0, n), dtype=torch.float32, device=dev)
            got = hier_aggregate(x, w)
            want = hier_aggregate_ref(x, w)
            torch.cuda.synchronize()
            err = _close(got, want, tol)
            result["agg"]["max_abs_err"] = max(result["agg"]["max_abs_err"], err)
            zero = hier_aggregate(x, torch.zeros_like(w))
            _require(bool((zero == 0).all()), f"hier_aggregate N={n}: zero total weight does not write zeros")
            line = f"kernel hier_aggregate [{timed or 'sweep'}] N={n} D={d} {dtype}: max_abs_err={err:.3g}"
            if timed and dtype == torch.float32:
                wn = w / w.sum().clamp_min(1e-30)
                t = _timings(
                    kernel=lambda: agg_mod._launch(x, w),
                    wrapper=lambda: hier_aggregate(x, w),
                    plain=lambda: hier_aggregate_ref(x, w),
                    library=lambda: wn @ x,
                    nbytes=(n + 1) * d * 4 + n * 4,
                    rate=rate,
                )
                t.update(floor)
                t["sync_free"] = _sync_free(lambda: hier_aggregate(x, w.double()))
                if timed == "cloud reduce":
                    t.update(_wrapper_work(lambda: hier_aggregate(x, w)))
                    result["agg"].update(t)
                elif timed == "host edge FedAvg":
                    result["agg"]["host_edge"] = {"N": n, "D": d, **t}
                elif timed == "stream cloud reduce":
                    result["agg"]["stream"] = {"N": n, "D": d, "max_abs_err": err, **t}
                elif timed == "mix cloud reduce":
                    result["agg"].setdefault("mix", []).append({"N": n, "D": d, "max_abs_err": err, **t})
                if timed in ("cloud reduce", "host edge FedAvg") or (n in ASYNC_FLUSH_NS and d == d_model):
                    by_n = result["agg"].setdefault("by_n", {})
                    by_n[n] = {"N": n, "D": d, **{k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}
                line += " " + _fmt(t)
            print(line, flush=True)
    return result


def _adam_scales(step: int, b1: float = 0.9, b2: float = 0.999):
    """(mh_scale, vh_scale) of ``adam``'s step ``step``, in float32 as
    ``training/optimizers.py`` computes them."""
    import numpy as np

    t = np.float32(step) + np.float32(1.0)
    return (float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** t)),
            float(np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** t)))


def _bits_differ(a, b) -> int:
    """Elements of ``a`` and ``b`` whose bits differ."""
    import torch

    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return int((a.view(ints[a.dtype]) != b.view(ints[b.dtype])).sum())


def _adam_phase(rate: float, smi: str) -> dict:
    """Phase 3, ``adam_update``: phi3-mini-3.8b's edge replica as the
    benchmark's LM cell holds it (``ADAM_LAYERS`` layers, 12 leaves, bf16
    parameters and gradients, fp32 moments).  ``adam(1e-3).update_`` takes
    two steps of the whole replica from moments that are not zero (one
    launch a leaf a step) and the plain version the same two steps on
    copies: the count of elements of p, m and v whose bits differ must be
    0.  Then, behind the spin kernel, the MLP stack ``ADAM_STACK`` alone
    and the whole replica: the kernel (its module's ``_launch``), the
    plain sliced version and ``torch._fused_adam_`` as the library's
    yardstick (timed only; its moments follow its parameters' dtype, so it
    runs on fp32 p, g, m and v of the same lengths, 28 bytes an element)
    beside the bound, 22 bytes an element at the card's memory rate."""
    import dataclasses
    import importlib

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import adam_update_, adam_update_ref_, launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.training import adam

    adam_mod = importlib.import_module("repro_torch.kernels.adam")
    card = f"[{smi}]"
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=ADAM_LAYERS)
    tree = init_params(torch.Generator("cuda").manual_seed(0), cfg)
    params = _leaves(tree)
    n_params = sum(p.numel() for p in params)
    _require(len(params) == ADAM_LEAVES and n_params == ADAM_PARAMS,
             f"adam: {len(params)} leaves, {n_params} parameters, not {ADAM_LEAVES} and {ADAM_PARAMS}")
    gen = torch.Generator("cuda").manual_seed(1)

    def draw(p, scale, dtype):
        return torch.randn(p.shape, generator=gen, device="cuda").mul_(scale).to(dtype)

    grads = [[draw(p, 1e-3, p.dtype) for p in params] for _ in range(2)]
    m = [draw(p, 1e-4, torch.float32) for p in params]
    v = [draw(p, 1e-3, torch.float32).square_() for p in params]
    copies = [[t.clone() for t in ts] for ts in (params, m, v)]
    unflat = lambda leaves: _tree_from_leaves(tree, iter(leaves))  # noqa: E731
    opt = adam(1e-3)
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, lr_t=1e-3, weight_decay=0.0)
    torch.cuda.synchronize()
    reset_launch_counts()
    for step in range(2):
        opt.update_(unflat(params), unflat(grads[step]), (unflat(m), unflat(v)), step)
        mh, vh = _adam_scales(step)
        for p, g, mm, vv in zip(*copies[:1], grads[step], *copies[1:], strict=True):
            adam_update_ref_(p, g, mm, vv, mh_scale=mh, vh_scale=vh, **hp)
    torch.cuda.synchronize()
    launches = launch_counts()["adam_update"]
    differ = sum(_bits_differ(a, b) for ts, cs in zip((params, m, v), copies) for a, b in zip(ts, cs, strict=True))
    print(f"kernel adam_update [phi3 replica, {ADAM_LAYERS} layers] {ADAM_LEAVES} leaves {n_params} parameters "
          f"bf16 p/g fp32 m/v, 2 steps: {launches} launches, differing elements {differ} {card}", flush=True)
    _require(launches == 2 * ADAM_LEAVES, f"adam: {launches} launches in 2 steps, not {2 * ADAM_LEAVES}")
    _require(differ == 0, f"adam: {differ} elements differ between the kernel and its plain version")
    mh, vh = _adam_scales(1)
    kw = dict(mh_scale=mh, vh_scale=vh, **hp)
    g = grads[1]
    del grads[0], copies
    torch.cuda.empty_cache()
    out = {"max_abs_err": 0.0, "differing_elements": differ, "launches_per_replica_step": launches // 2,
           "sync_free": _sync_free(lambda: adam_update_(params[0], g[0], m[0], v[0], **kw))}
    stack = next(i for i, p in enumerate(params) if tuple(p.shape) == ADAM_STACK)
    for label, idx in (("MLP stack", [stack]), ("phi3 replica", range(len(params)))):
        quads = [(params[i], g[i], m[i], v[i]) for i in idx]
        numel = sum(q[0].numel() for q in quads)
        f32 = [[torch.zeros(q[0].shape, device="cuda") for q in quads] for _ in range(4)]
        steps = [torch.ones((), device="cuda") for _ in quads]
        iters = 20 if label == "MLP stack" else 5
        t = {
            "elements": numel,
            "ms": _device_ms(lambda: [adam_mod._launch(*q, **kw) for q in quads], iters=iters, warmup=2)[0],
            "plain_ms": _device_ms(lambda: [adam_update_ref_(*q, **kw) for q in quads], iters=3, warmup=1)[0],
            "library_ms": _device_ms(lambda: torch._fused_adam_(
                *f32, [], steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
                maximize=False), iters=iters, warmup=2)[0],
            "library_bytes": 28 * numel,
            "bound_ms": 22 * numel / rate * 1e3,
            "bound_by": "bytes",
        }
        t["roofline_pct"] = 100 * t["bound_ms"] / t["ms"]
        del f32
        torch.cuda.empty_cache()
        print(f"kernel adam_update [{label}] {_fmt(t)} {card}", flush=True)
        out["stack" if label == "MLP stack" else "replica"] = t
    out.update({k: out["stack"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    return out


def _adam_only() -> int:
    """``--adam``: the kernels' build, ``adam_update``'s registers and
    spills, then phase 3's ``adam_update`` line (``_adam_phase``) alone;
    prints one JSON line."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.build import build

    smi = _smi()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    so, log = build()
    print(f"build: {so.name} in {time.perf_counter() - t0:.3f}s", flush=True)
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "adam_update_kernel" in line:
            print(f"build: {line.strip()}", flush=True)
            for follow in lines[i + 1:i + 4]:
                if "registers" in follow or "spill" in follow:
                    print(f"build:   {follow.strip()}", flush=True)
                    if "spill" in follow:
                        _require(" 0 bytes spill stores, 0 bytes spill loads" in follow, "adam_update spills")
    out = _adam_phase(_rates(torch.cuda.get_device_name(0))[0], smi)
    print(json.dumps({"adam_update": out, "card": smi}), flush=True)
    return 0


def _card_vs_cpu() -> None:
    """Phase 4: the sync engine on the card against the CPU, same inputs."""
    import numpy as np

    from repro_torch.federated import build_scenario
    from repro_torch.utils.tree import tree_leaves

    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=20, device="cpu")
    lam = sc.assign("eara-sca", device="cpu").lam
    runs = {d: sc.simulate(lam, cloud_rounds=2, seed=0, engine="sync", device=d) for d in ("cuda", "cpu")}
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


def _stream_card_vs_cpu() -> None:
    """Phase 4: ``StreamSyncEngine`` on the card against the CPU, same
    initial parameters: M 120 over 4 edges, a cohort of 24, 2 rounds."""
    from repro_torch.federated import CohortSpec, build_scenario

    sc = build_scenario("heartbeat", lazy=True, n_eus=120, n_edges=4, seed=3, n_test_per_class=20, device="cpu")
    runs = [sc.simulate(CohortSpec(size=24, seed=9), cloud_rounds=2, seed=0, device=d) for d in ("cuda", "cpu")]
    one_sample = 1.0 / len(sc.test)
    for a, b in zip(*(r.history for r in runs)):
        print(f"card-vs-cpu stream round {a.cloud_round}: acc {a.test_acc:.6f} vs {b.test_acc:.6f}, "
              f"loss {a.mean_local_loss:.6f} vs {b.mean_local_loss:.6f}", flush=True)
        _require(abs(a.test_acc - b.test_acc) <= one_sample + 1e-6, "stream: card and CPU accuracy disagree")
        _require(abs(a.mean_local_loss - b.mean_local_loss) <= 5e-3, "stream: card and CPU loss disagree")
    diff = float((_flat_row(runs[0].final_params).cpu() - _flat_row(runs[1].final_params)).abs().max())
    print(f"card-vs-cpu stream max |param diff| {diff:.3g}", flush=True)
    _require(diff <= 5e-3, "stream: card and CPU parameters disagree")
    _require(runs[0].accountant.totals() == runs[1].accountant.totals(), "stream: card and CPU accounting disagree")


def _heartbeat_scenario():
    """The full-size heartbeat scenario and its EARA-SCA assignment, built
    before phase 3 (which times ``hier_aggregate`` at the assignment's
    largest edge)."""
    from repro_torch.federated import build_scenario

    t0 = time.perf_counter()
    sc = build_scenario("heartbeat")
    print(f"main: build_scenario heartbeat scale=1.0: {len(sc.clients)} EUs, {sc.n_edges} edges, "
          f"{sum(c.data_size for c in sc.clients)} samples, {time.perf_counter() - t0:.3f}s", flush=True)
    t0 = time.perf_counter()
    sca = sc.assign("eara-sca")
    print(f"main: assign eara-sca {time.perf_counter() - t0:.3f}s per-edge EUs {sca.lam.sum(axis=0).tolist()}", flush=True)
    return sc, sca.lam


def _main_path(sc, sca_lam):
    """Phase 5: the paper's heartbeat experiment at full size on the card."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.utils.tree import tree_leaves

    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = sc.simulate(sca_lam, cloud_rounds=5, engine="sync", pipeline="device")
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
    return counts


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


def _warm_serve_cost(engine, prompts, **kw) -> None:
    """Serve ``prompts`` once for 2 tokens, so the telemetry's analytic
    cost of the serve spans (``jit_cost``, counted on meta copies the
    first time each shape is seen, inside its span) is cached before the
    timed run of the same shapes."""
    from repro_torch.serving import Request

    engine.run([Request(p, max_new_tokens=2) for p in prompts], **kw)


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


def _flat_row(params):
    import torch

    from repro_torch.utils.tree import tree_leaves

    return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(params)])


def _expected_aggregates(lam, edge_rounds: int, cloud_rounds: int) -> int:
    """``hier_aggregate`` launches of the host pipeline at full
    participation: per edge round one per edge with members and one per
    dual-connected client (its start average); one per cloud reduce."""
    per_edge_round = int((lam.sum(axis=0) > 0).sum()) + int((lam.sum(axis=1) > 1).sum())
    return edge_rounds * per_edge_round + cloud_rounds


def _run_counted(sc, lam, label: str, **kw):
    """One ``simulate`` call with the launch counts zeroed just before and
    read just after; prints each round and the counts."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.utils.tree import tree_leaves

    torch.cuda.synchronize()
    reset_launch_counts()
    res = sc.simulate(lam, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    for h in res.history:
        print(f"engines: {label} round {h.cloud_round} acc {h.test_acc:.6f} loss {h.mean_local_loss:.6f} "
              f"seconds {h.wall_seconds:.4f} divergence {h.divergence:.6g}", flush=True)
    print(f"engines: {label} launches {json.dumps(counts)} accountant {json.dumps(res.accountant.totals())}",
          flush=True)
    for leaf in tree_leaves(res.final_params):
        _require(bool(torch.isfinite(leaf).all()), f"{label}: non-finite parameters")
    return res, counts


def _agree(label: str, a, b, acc_tol: float, totals: bool = True) -> None:
    """Per-round accuracy within ``acc_tol``, final parameters within 5e-3
    (the reference's own engine tolerance) and, with ``totals``, equal
    accountant totals."""
    for ha, hb in zip(a.history, b.history):
        _require(abs(ha.test_acc - hb.test_acc) <= acc_tol + 1e-6,
                 f"{label}: round {ha.cloud_round} accuracy {ha.test_acc} vs {hb.test_acc}")
    diff = float((_flat_row(a.final_params) - _flat_row(b.final_params)).abs().max())
    print(f"engines: {label} max |param diff| {diff:.3g}", flush=True)
    _require(diff <= 5e-3, f"{label}: parameters differ by {diff}")
    _require(not totals or a.accountant.totals() == b.accountant.totals(), f"{label}: accountant totals differ")


def _engines_phase(sc, sca_lam) -> dict:
    """Phase 6b: the heartbeat path at full size on every engine.  The
    readable simulator, the host pipeline and the device pipeline for 2
    cloud rounds each (launch counts zeroed before each run, read after:
    none under the simulator, ``hier_aggregate`` once per edge FedAvg, DCA
    start and cloud reduce on the host pipeline, the segment kernel only on
    the device pipeline), held to one another; one host-pipeline round
    under EARA-DCA; divergence tracking and the centralized baseline; the
    MLP and FedSGD (16-bit) programs on both pipelines.  Returns the host
    pipeline's ``hier_aggregate`` launches."""
    import numpy as np

    from repro_torch.federated import build_scenario

    acc_tol = 2.0 / len(sc.test)
    runs = {}
    for label, kw in (("reference", {"engine": "reference"}),
                      ("sync-host", {"engine": "sync", "pipeline": "host"}),
                      ("sync-device", {"engine": "sync", "pipeline": "device"})):
        runs[label] = _run_counted(sc, sca_lam, label, cloud_rounds=2, **kw)
    (ref, ref_counts), (host, host_counts), (dev, dev_counts) = runs.values()
    _agree("sync-host vs reference", host, ref, acc_tol)
    _agree("sync-device vs reference", dev, ref, acc_tol)
    _require(not any(ref_counts.values()), f"a kernel launched under the readable simulator: {ref_counts}")
    want = _expected_aggregates(sca_lam, 2, 2)
    _require(host_counts["hier_aggregate"] == want,
             f"host pipeline: {host_counts['hier_aggregate']} hier_aggregate launches, expected {want}")
    _require(host_counts["hier_segment_aggregate"] == 0, "the segment kernel launched on the host pipeline")
    _require(dev_counts["hier_segment_aggregate"] == 2 and dev_counts["hier_aggregate"] == 2,
             f"device pipeline launches {dev_counts}")
    launches = {"sca_2_rounds": host_counts["hier_aggregate"]}

    dca = sc.assign("eara-dca").lam
    dual = int((dca.sum(axis=1) > 1).sum())
    _, dca_counts = _run_counted(sc, dca, "sync-host dca", cloud_rounds=1, engine="sync", pipeline="host")
    want = _expected_aggregates(dca, 1, 1)
    _require(dca_counts["hier_aggregate"] == want,
             f"host pipeline under DCA ({dual} dual-connected EUs): {dca_counts['hier_aggregate']} "
             f"hier_aggregate launches, expected {want}")
    launches["dca_1_round"] = dca_counts["hier_aggregate"]

    div, _ = _run_counted(sc, sca_lam, "reference divergence", cloud_rounds=1, engine="reference",
                          track_divergence=True)
    d = div.history[-1].divergence
    _require(bool(np.isfinite(d)) and d > 0, f"divergence {d} is not finite and positive")
    t0 = time.perf_counter()
    central = sc.centralized(2)
    print("engines: centralized " + ", ".join(
        f"round {h.cloud_round} acc {h.test_acc:.6f} loss {h.mean_local_loss:.6f}" for h in central)
        + f" in {time.perf_counter() - t0:.3f}s", flush=True)
    _require(all(np.isfinite(h.test_acc) for h in central), "centralized accuracy is not finite")

    cnn_up_per_round = host.accountant.totals()["eu_up_bits"] / 2
    for name, kw in (("mlp", {"model": "mlp"}), ("fedsgd-16", {"fedsgd": True, "grad_bits": 16})):
        other = build_scenario("heartbeat", **kw)
        pair = [_run_counted(other, sca_lam, f"{name} {p}", cloud_rounds=1, engine="sync", pipeline=p)[0]
                for p in ("host", "device")]
        _agree(f"{name} device vs host", pair[1], pair[0], acc_tol)
        if name == "fedsgd-16":
            up = pair[0].accountant.totals()["eu_up_bits"]
            _require(up == cnn_up_per_round / 2, f"FedSGD 16-bit eu_up_bits {up} is not half the CNN's "
                                                 f"{cnn_up_per_round}")
    return launches


def _async_phase(sc, sca_lam) -> dict:
    """Phase 6c: the async engine, uplink compression and the fault layer
    at full size, each run's launch counts zeroed just before and read just
    after.  Returns the async defaults run's ``hier_aggregate`` launches,
    flush-size histogram and weight uploads."""
    import numpy as np
    import torch

    from repro_torch.core import CompressionSpec, HFLSchedule
    from repro_torch.engine import AsyncHFLEngine
    from repro_torch.faults import FaultSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.utils.tree import tree_leaves

    acc_tol = 2.0 / len(sc.test)
    # the sync corner: quorum 1, no decay -> FedAvg, as the device pipeline
    corner, corner_counts = _run_counted(sc, sca_lam, "async corner", cloud_rounds=2, engine="async",
                                         quorum=1.0, staleness_decay=1.0)
    dev, _ = _run_counted(sc, sca_lam, "sync-device beside the corner", cloud_rounds=2, engine="sync")
    _agree("async corner vs sync-device", corner, dev, acc_tol, totals=False)
    _require(corner_counts["hier_segment_aggregate"] == 0, "the segment kernel launched on the async engine")

    # the defaults, through the engine for its own counts
    eng = AsyncHFLEngine(sc.clients, sca_lam, sc.program, sc.test, latency=sc.cost.latency, schedule=HFLSchedule(1, 2))
    torch.cuda.synchronize()
    reset_launch_counts()
    res = eng.run(2)
    torch.cuda.synchronize()
    counts = launch_counts()
    for h in res.history:
        print(f"async: defaults round {h.cloud_round} acc {h.test_acc:.6f} loss {h.mean_local_loss:.6f} "
              f"seconds {h.wall_seconds:.4f} simulated {h.sim_seconds:.6f}", flush=True)
    hist = dict(sorted(eng.flush_rows.items()))
    print(f"async: defaults wall_seconds (simulated) {res.wall_seconds:.6f} aggregates {json.dumps(eng.aggregates)} "
          f"launches {json.dumps(counts)} flush N histogram {json.dumps(hist)} weight uploads {eng.weight_uploads} "
          f"accountant {json.dumps(res.accountant.totals())}", flush=True)
    _require(counts["hier_aggregate"] == sum(eng.aggregates.values()),
             f"async: {counts['hier_aggregate']} hier_aggregate launches, the engine counts {eng.aggregates}")
    _require(counts["hier_segment_aggregate"] == 0, "the segment kernel launched on the async engine")
    for leaf in tree_leaves(res.final_params):
        _require(bool(torch.isfinite(leaf).all()), "async defaults: non-finite parameters")
    _require(res.final_accuracy() > 0.2, f"async defaults accuracy {res.final_accuracy()} is not above chance")
    out = {"launches_2_rounds": counts["hier_aggregate"], "aggregates": dict(eng.aggregates),
           "flush_rows": hist, "weight_uploads": eng.weight_uploads,
           "seconds_per_round": [h.wall_seconds for h in res.history], "wall_seconds": res.wall_seconds}

    # top-k 5%: one round on every engine; the uplink is the spec's bits per upload
    spec = CompressionSpec("topk", fraction=0.05)
    uploads = int(sca_lam.any(axis=1).sum())
    params = sc.program.init(torch.Generator().manual_seed(0))
    flat_bits = spec.bits(torch.zeros(sum(p.numel() for p in tree_leaves(params))))
    edges = int(sca_lam.any(axis=0).sum())
    # (hier_segment_aggregate, hier_aggregate) launches of one round: none
    # under the simulator; the host pipeline one per edge and the reduce;
    # the device pipeline one of each; async one flush per edge and the reduce
    want_launches = {"reference": (0, 0), "sync-host": (0, _expected_aggregates(sca_lam, 1, 1)),
                     "sync-device": (1, 1), "async": (0, edges + 1)}
    for label, kw, bits in (("reference", {"engine": "reference"}, spec.bits(params)),
                            ("sync-host", {"engine": "sync", "pipeline": "host"}, flat_bits),
                            ("sync-device", {"engine": "sync", "pipeline": "device"}, flat_bits),
                            ("async", {"engine": "async"}, flat_bits)):
        run, launched = _run_counted(sc, sca_lam, f"topk {label}", cloud_rounds=1, compression=spec, **kw)
        got = (launched["hier_segment_aggregate"], launched["hier_aggregate"])
        _require(got == want_launches[label], f"topk {label}: launches {got}, expected {want_launches[label]}")
        up = run.accountant.totals()["eu_up_bits"]
        _require(up == bits * uploads, f"topk {label}: eu_up_bits {up} != {bits} x {uploads} uploads")
        acc = run.final_accuracy()
        _require(bool(np.isfinite(acc)) and acc > 0.2, f"topk {label}: accuracy {acc} is not above chance")

    # the chaos spec of tests/test_faults.py: the simulator and both sync
    # pipelines hold to one another; async retries
    chaos = FaultSpec(seed=3, p_drop=0.25, p_rejoin=0.5, p_fail=0.2, max_retries=2, backoff_s=0.1,
                      energy_uploads=6.0, refade_rounds=1, drift_rate=0.05)
    runs = {}
    for label, kw in (("reference", {"engine": "reference"}), ("sync-host", {"engine": "sync", "pipeline": "host"}),
                      ("sync-device", {"engine": "sync", "pipeline": "device"}), ("async", {"engine": "async"})):
        runs[label], launched = _run_counted(sc, sca_lam, f"chaos {label}", cloud_rounds=2, faults=chaos, **kw)
        # the kernels of each path ran (how often depends on the churn)
        uses = {"reference": (False, False), "sync-device": (True, True)}.get(label, (False, True))
        got = (launched["hier_segment_aggregate"] > 0, launched["hier_aggregate"] > 0)
        _require(got == uses, f"chaos {label}: launches {launched}")
    accs = {k: [h.test_acc for h in r.history] for k, r in runs.items()}
    totals = {k: r.accountant.totals() for k, r in runs.items()}
    _require(accs["reference"] == accs["sync-host"] == accs["sync-device"], f"chaos: accuracies differ {accs}")
    _require(totals["reference"] == totals["sync-host"] == totals["sync-device"], f"chaos: totals differ {totals}")
    _require(totals["reference"]["dropped_uploads"] > 0, "chaos: no upload was dropped")
    _require(totals["async"]["retried_uploads"] > 0, "chaos: the async engine retried nothing")
    for label in ("sync-host", "sync-device"):
        _agree(f"chaos {label} vs reference", runs[label], runs["reference"], 0.0)
    return out


def _stream_run(sc, label: str, rounds: int, **kw):
    """A fresh ``StreamSyncEngine`` over ``sc`` for ``rounds`` cloud rounds
    of a cohort of ``STREAM_COHORT`` (seed 0), launch counts and peak
    memory reset just before it is built and read just after it ran.  The
    peak returned is the run's own: ``max_memory_allocated`` less what was
    allocated when the peak was reset (earlier phases' tensors)."""
    import torch

    from repro_torch.engine import StreamSyncEngine
    from repro_torch.federated import CohortSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng = StreamSyncEngine(sc.source, sc.edge_of, sc.program, sc.test, cohort=CohortSpec(size=STREAM_COHORT, seed=0),
                           n_edges=sc.n_edges, **kw)
    res = eng.run(rounds)
    torch.cuda.synchronize()
    counts, peak = launch_counts(), torch.cuda.max_memory_allocated() - base
    st = eng.store
    for h in res.history:
        print(f"stream: {label} round {h.cloud_round} acc {h.test_acc:.6f} loss {h.mean_local_loss:.6f} "
              f"seconds {h.wall_seconds:.4f} clients/s {STREAM_COHORT / h.wall_seconds:.1f}", flush=True)
    print(f"stream: {label} pages hits {st.hits} misses {st.misses} evictions {st.evictions} "
          f"device_bytes {st.device_bytes} peak memory above the {base}-byte baseline {peak} "
          f"launches {json.dumps(counts)}", flush=True)
    for leaf in _leaves(res.final_params):
        _require(bool(torch.isfinite(leaf).all()), f"stream {label}: non-finite parameters")
    return res, eng, counts, peak


def _stream_profile(eng) -> None:
    """Where a streaming round goes: one more round of ``eng`` timed, with
    the host's seconds in ``store.ensure`` (shard synthesis and the miss
    batch's upload), then one under ``torch.profiler`` (the card's busy
    share and its top kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    real, spent = eng.store.ensure, [0.0]

    def timed_ensure(cids):
        t0 = time.perf_counter()
        out = real(cids)
        spent[0] += time.perf_counter() - t0
        return out

    eng.store.ensure = timed_ensure
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(1)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    print(f"stream: profile round: paging (store.ensure) {spent[0]:.4f}s of {plain_wall:.4f}s", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.store.ensure = real
    _report_profile(prof, plain_wall, wall, "stream: profile round")


def _stream_phase() -> dict:
    """Phase 6d: streaming populations at full size.  The lazy heartbeat
    population of 1,000,000 clients over 8 edges: one warm-up round, then 3
    cloud rounds of a cohort of 256 (one segment and one ``hier_aggregate``
    launch a round at ``HFLSchedule(1, 1)``); the same at 100,000 clients,
    whose peak device memory the 1M run must hold within 1.10x; the 1M run
    again with ``page_slots`` = the cohort (heavy eviction, bit-identical
    result); at 2,048 clients the stream engine against the sync device
    pipeline with ``cohort=`` on the materialized population (accuracy
    within 2 test samples, parameters within 1e-4); one sync-device round
    with ``server_momentum=0.9`` and ``cohort=``."""
    import torch

    from repro_torch.engine import BatchedSyncEngine
    from repro_torch.federated import CohortSpec, build_scenario

    out = {}
    peaks = {}
    for m in (1_000_000, 100_000):
        t0 = time.perf_counter()
        sc = build_scenario("heartbeat", lazy=True, n_eus=m, n_edges=STREAM_EDGES)
        build_s = time.perf_counter() - t0
        print(f"stream: build_scenario lazy n_eus={m} n_edges={STREAM_EDGES}: {build_s:.3f}s, "
              f"kld {sc.kld_total():.6g}, samples {int(sc.source.sizes.sum())}", flush=True)
        if m == 1_000_000:
            _stream_run(sc, f"M={m} warm-up", 1)
        res, eng, counts, peaks[m] = _stream_run(sc, f"M={m}", 3)
        _require(counts["hier_segment_aggregate"] == 3 and counts["hier_aggregate"] == 3,
                 f"stream M={m}: launches {counts}, expected 1 segment and 1 hier_aggregate a round")
        rec = {"M": m, "build_s": build_s, "seconds_per_round": [h.wall_seconds for h in res.history],
               "hits": eng.store.hits, "misses": eng.store.misses, "evictions": eng.store.evictions,
               "device_bytes": eng.store.device_bytes, "peak_memory": peaks[m],
               "acc": [h.test_acc for h in res.history],
               "launches_per_round": {k: v / len(res.history) for k, v in counts.items()}}
        out[m] = rec
        if m == 1_000_000:
            _stream_profile(eng)
            small, small_eng, _, _ = _stream_run(sc, f"M={m} page_slots={STREAM_COHORT}", 3, page_slots=STREAM_COHORT)
            _require(small_eng.store.evictions > 0, "stream: page_slots = cohort evicted nothing")
            _require([h.test_acc for h in small.history] == [h.test_acc for h in res.history]
                     and torch.equal(_flat_row(small.final_params), _flat_row(res.final_params)),
                     "stream: the page_slots = cohort run is not bit-identical to the default run")
            rec["evictions_at_cohort_slots"] = small_eng.store.evictions
    ratio = peaks[1_000_000] / peaks[100_000]
    print(f"stream: peak device memory 1M / 100k = {ratio:.4f}", flush=True)
    _require(ratio <= 1.10, f"stream: peak device memory at 1M is {ratio:.4f}x the 100k run's")
    out["peak_ratio"] = ratio

    sc = build_scenario("heartbeat", lazy=True, n_eus=2048, n_edges=STREAM_EDGES)
    stream, _, _, _ = _stream_run(sc, "M=2048", 2)
    clients, lam = list(sc.clients()), sc.assignment_matrix()
    spec = CohortSpec(size=STREAM_COHORT, seed=0)
    sync = BatchedSyncEngine(clients, lam, sc.program, sc.test, cohort=spec).run(2)
    acc_tol = 2.0 / len(sc.test)
    for a, b in zip(stream.history, sync.history):
        print(f"stream: M=2048 round {a.cloud_round} stream acc {a.test_acc:.6f} sync-device acc {b.test_acc:.6f}",
              flush=True)
        _require(abs(a.test_acc - b.test_acc) <= acc_tol + 1e-6, "stream vs sync-device: accuracy differs")
    diff = float((_flat_row(stream.final_params) - _flat_row(sync.final_params)).abs().max())
    print(f"stream: M=2048 stream vs sync-device max |param diff| {diff:.3g}", flush=True)
    _require(diff <= 1e-4, f"stream vs sync-device: parameters differ by {diff}")
    _require(stream.accountant.totals() == sync.accountant.totals(), "stream vs sync-device: accounting differs")
    out["stream_vs_sync_param_diff"] = diff
    mom = BatchedSyncEngine(clients, lam, sc.program, sc.test, cohort=spec, server_momentum=0.9).run(1)
    h = mom.history[-1]
    print(f"stream: sync-device server_momentum=0.9 cohort=256 round 1 acc {h.test_acc:.6f} "
          f"loss {h.mean_local_loss:.6f}", flush=True)
    for leaf in _leaves(mom.final_params):
        _require(bool(torch.isfinite(leaf).all()), "sync-device with server momentum: non-finite parameters")
    return out


def _mix_scenario():
    """Phase 6e's population, built before phase 3 (which times the FedAvg
    kernels at its groups' shapes): ``build_scenario("heartbeat",
    model_mix={"cnn": 12, "mlp": 6})`` at full size and its EARA-SCA
    assignment, with each group's pair edges (its segment ids) and width."""
    import numpy as np

    from repro_torch.engine import pack_for
    from repro_torch.federated import build_scenario, group_clients

    t0 = time.perf_counter()
    sc = build_scenario("heartbeat", model_mix=MIX)
    build_s = time.perf_counter() - t0
    lam = sc.assign("eara-sca").lam
    programs, group_of = group_clients(sc.clients)
    pc, pe = np.nonzero(lam)
    ids = [(pe[group_of[pc] == g], pack_for(p).dim) for g, p in enumerate(programs)]
    print(f"mix: build_scenario heartbeat model_mix={MIX}: {sc.name}, {len(sc.clients)} EUs, {sc.n_edges} edges, "
          f"public {[len(d) for d in sc.public]}, widths {[d for _, d in ids]}, model_bits {sc.model_bits}, "
          f"{build_s:.3f}s; per-edge EUs by group {[np.bincount(i, minlength=sc.n_edges).tolist() for i, _ in ids]}",
          flush=True)
    return sc, lam, ids


def _mix_phase(sc, lam) -> dict:
    """Phase 6e: the mixed population at full size on every engine.  The
    device pipeline for 1 round (warm-up, held to the readable simulator's
    1 round) and then 2 timed rounds (held to the host pipeline's 2), async
    at the sync corner and at its defaults for 1 round each; each run's
    launch counts zeroed just before and read just after.  The fuse is
    timed by CUDA events inside every sync round; it is then checked on the
    card against the CPU (1e-5) and profiled alone (device ops), and one
    device-pipeline round is profiled (busy share).  Returns the counts and
    times for the kernels line."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import AsyncHFLEngine, BatchedSyncEngine, distill_fuse_flat
    from repro_torch.kernels import launch_counts, reset_launch_counts

    smi = _smi()
    acc_tol = 2.0 / len(sc.test)
    real_fuse = BatchedSyncEngine._kd_fuse_device
    fuse_events = []

    def timed_fuse(self, edge_mats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_fuse(self, edge_mats)
        end.record()
        fuse_events.append((start, end))
        return out

    BatchedSyncEngine._kd_fuse_device = timed_fuse
    try:
        runs = {}
        for label, kw in (("sync-device warm-up", {"engine": "sync", "cloud_rounds": 1}),
                          ("reference", {"engine": "reference", "cloud_rounds": 1}),
                          ("sync-device", {"engine": "sync", "cloud_rounds": 2}),
                          ("sync-host", {"engine": "sync", "pipeline": "host", "cloud_rounds": 2})):
            fuse_events.clear()
            runs[label] = _run_counted(sc, lam, f"mix {label}", **kw)
            torch.cuda.synchronize()
            fuse_s = [s.elapsed_time(e) / 1e3 for s, e in fuse_events]
            rounds = runs[label][0].history
            print(f"mix: {label} seconds per cloud round {[h.wall_seconds for h in rounds]}; fuse seconds per "
                  f"cloud round (CUDA events) {fuse_s} [{smi}]", flush=True)
            runs[label] += (fuse_s,)
    finally:
        BatchedSyncEngine._kd_fuse_device = real_fuse
    (warm, warm_counts, _), (ref, ref_counts, _), (dev, dev_counts, dev_fuse), (host, host_counts, host_fuse) = (
        runs.values())
    for r in (warm, ref, dev, host):
        _require(set(r.final_params) == {"cnn", "mlp"}, f"mix: final_params keys {set(r.final_params)}")
    # each group's parameters within 5e-3: the rows hold both groups' trees
    _agree("mix sync-device vs reference (1 round)", warm, ref, acc_tol)
    _agree("mix sync-host vs sync-device (2 rounds)", host, dev, acc_tol)
    _require(not any(ref_counts.values()), f"mix: a kernel launched under the readable simulator: {ref_counts}")
    _require(dev_counts["hier_segment_aggregate"] == 2 * 2 and dev_counts["hier_aggregate"] == 2 * 2,
             f"mix sync-device: launches {dev_counts}, expected 2 segment and 2 hier_aggregate a round")
    groups = np.array([0] * MIX["cnn"] + [1] * MIX["mlp"])
    cells = sum(int((lam[groups == g].sum(axis=0) > 0).sum()) for g in range(2))
    _require(host_counts["hier_aggregate"] == 2 * (cells + 2) and host_counts["hier_segment_aggregate"] == 0,
             f"mix sync-host: launches {host_counts}, expected {cells} (group, edge) cells + 2 a round")
    _require(len(dev_fuse) == 2 and len(host_fuse) == 2, "mix: the fuse did not run once a cloud round")

    out = {"seconds_per_round": {}, "fuse_s": dev_fuse, "card": smi,
           "launches": {"sync-device, 2 rounds": dev_counts, "sync-host, 2 rounds": host_counts}}
    out["seconds_per_round"]["sync-device"] = [h.wall_seconds for h in dev.history]
    out["seconds_per_round"]["sync-host"] = [h.wall_seconds for h in host.history]
    out["seconds_per_round"]["reference"] = [h.wall_seconds for h in ref.history]
    for label, kw in (("async corner", {"quorum": 1.0, "staleness_decay": 1.0}), ("async defaults", {})):
        eng = AsyncHFLEngine(sc.clients, lam, sc.program, sc.test, latency=sc.cost.latency,
                             public_shards=sc.public, distill=sc.distill, **kw)
        torch.cuda.synchronize()
        reset_launch_counts()
        res = eng.run(1)
        torch.cuda.synchronize()
        counts = launch_counts()
        h = res.history[-1]
        print(f"mix: {label} round 1 acc {h.test_acc:.6f} loss {h.mean_local_loss:.6f} seconds {h.wall_seconds:.4f} "
              f"simulated {h.sim_seconds:.6f} aggregates {json.dumps(eng.aggregates)} launches {json.dumps(counts)} "
              f"accountant {json.dumps(res.accountant.totals())} [{smi}]", flush=True)
        _require(set(res.final_params) == {"cnn", "mlp"}, f"mix {label}: final_params {set(res.final_params)}")
        _require(counts["hier_aggregate"] == eng.aggregates["flush"] + 2 == sum(eng.aggregates.values())
                 and counts["hier_segment_aggregate"] == 0, f"mix {label}: launches {counts}, {eng.aggregates}")
        for leaf in _leaves(res.final_params):
            _require(bool(torch.isfinite(leaf).all()), f"mix {label}: non-finite parameters")
        out["seconds_per_round"][label] = [h.wall_seconds for h in res.history]
        out["launches"][f"{label}, 1 round"] = counts
        if label == "async corner":
            _agree("mix async corner vs sync-device (1 round)", res, warm, acc_tol, totals=False)

    # the fuse alone at the engines' shapes: card against CPU, then its device ops
    eng = BatchedSyncEngine(sc.clients, lam, sc.program, sc.test, public_shards=sc.public, distill=sc.distill)
    rng = np.random.default_rng(0)
    mats = [torch.as_tensor(rng.standard_normal((sc.n_edges, pk.dim)) * 0.05, dtype=torch.float32, device="cuda")
            for pk in eng.packs]
    idx = rng.integers(0, 15, (sc.n_edges, sc.distill.steps, sc.distill.batch))
    xb = eng.public_store.gather(np.arange(sc.n_edges), idx)[0]
    specs = [pk.spec for pk in eng.packs]
    card, card_losses = distill_fuse_flat(eng.groups, specs, mats, xb, sc.distill)
    cpu, cpu_losses = distill_fuse_flat(eng.groups, specs, [m.cpu() for m in mats], xb.cpu(), sc.distill)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(card, cpu))
    print(f"mix: distill_fuse_flat card vs CPU max |diff| {err:.3g}, losses {[float(v) for v in card_losses]} vs "
          f"{[float(v) for v in cpu_losses]}", flush=True)
    _require(err <= 1e-5, f"mix: the fuse on the card differs from the CPU by {err}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        distill_fuse_flat(eng.groups, specs, mats, xb, sc.distill)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    ops = sum(e.count for e in device)
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in device)
    print(f"mix: distill_fuse_flat device ops {ops}, device time {busy_us / 1e3:.3f} ms [{smi}]", flush=True)
    out.update(fuse_device_ops=ops, fuse_device_ms=busy_us / 1e3 if busy_us > 0 else "not measured",
               fuse_card_vs_cpu=err)

    # one device-pipeline round under the profiler: the card's busy share
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
    _report_profile(prof, plain_wall, wall, f"mix: profile sync-device round [{smi}]")
    return out


TELEMETRY_SPANS = ("assignment", "cohort_epoch", "edge_aggregate", "cloud_reduce", "eval", "cloud_round")
TELEMETRY_ARTIFACTS = ("trace.json", "trace.jsonl", "rounds.jsonl", "metrics.json", "summary.txt")


def _timed_telemetry(out_dir=None):
    """A ``Telemetry`` that counts its metric updates (``metrics.updates``)
    and the host seconds ``jit_cost`` spends counting each key
    (``cost_seconds``)."""
    from repro_torch.telemetry import Telemetry
    from repro_torch.telemetry.metrics import MetricsRegistry

    class CountingMetrics(MetricsRegistry):
        updates = 0

        def inc(self, name, v=1.0):
            self.updates += 1
            super().inc(name, v)

        def set_gauge(self, name, v):
            self.updates += 1
            super().set_gauge(name, v)

        def observe(self, name, v):
            self.updates += 1
            super().observe(name, v)

    class TimedTelemetry(Telemetry):
        def __init__(self, out_dir=None):
            super().__init__(out_dir)
            self.metrics = CountingMetrics()
            self.cost_seconds = {}

        def _analyze(self, key, fn, args, kwargs):
            t0 = time.perf_counter()
            out = super()._analyze(key, fn, args, kwargs)
            self.cost_seconds[key] = self.cost_seconds.get(key, 0.0) + time.perf_counter() - t0
            return out

    return TimedTelemetry(out_dir)


def _telemetry_phase(sc, lam, mix_sc, mix_lam, smi: str) -> dict:
    """Phase 6f: telemetry at full size.  Heartbeat EARA-SCA on the device
    pipeline with telemetry on, off and on again (1 warm-up and 2 timed
    rounds each, launch counts zeroed just before each run and read just
    after): bit-equal parameters, equal accuracies, the five artifacts with
    the reference's span names, ``cohort_epoch_flat``'s FLOPs equal to the
    CPU's count at the same shapes, 1 segment and 1 aggregate launch in
    every round record (phase 5's count); one telemetry-on device round
    under sync-debug "error"; the mixed population on the device pipeline
    and async; one 1M-client streaming round.  Every line carries the
    card's name and power limit."""
    import tempfile

    import torch

    from repro_torch.engine import BatchedSyncEngine, FlatPack
    from repro_torch.engine.cohort import _cohort_epoch_flat
    from repro_torch.federated import CohortSpec, build_scenario
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.telemetry import Telemetry

    t_phase = time.perf_counter()
    card = f"[{smi}]"
    # earlier phases may have imported PyTorch's compile stack, which the
    # first meta pass of a process otherwise imports (``--paths`` times that)
    stack = "already imported" if "torch._dynamo" in sys.modules else "not yet imported"
    per_round = {"hier_segment_aggregate": 1, "hier_aggregate": 1, "flash_attention": 0, "topk_gating": 0}
    out, runs = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for i, mode in enumerate(("on", "off", "on")):
            tel = _timed_telemetry(Path(tmp) / f"run{i}") if mode == "on" else None
            torch.cuda.synchronize()
            reset_launch_counts()
            res = sc.simulate(lam, cloud_rounds=3, engine="sync", pipeline="device", telemetry=tel)
            torch.cuda.synchronize()
            counts = launch_counts()
            runs.append(res)
            print(f"telemetry: heartbeat device pipeline, telemetry {mode}: seconds per round "
                  f"{[round(h.wall_seconds, 4) for h in res.history]} (round 1 warm-up), accuracy "
                  f"{[h.test_acc for h in res.history]}, launches {json.dumps(counts)} {card}", flush=True)
            _require(counts["hier_segment_aggregate"] == 3 and counts["hier_aggregate"] == 3,
                     f"telemetry {mode}: launches {counts}, expected 1 segment and 1 aggregate a round")
            if tel is None:
                continue
            _require(res.telemetry is tel, "simulate did not return its Telemetry")
            which = f"this process's first counts, compile stack {stack}" if i == 0 else "a fresh Telemetry"
            print(f"telemetry: jit_cost host seconds by key {json.dumps(tel.cost_seconds)} ({which}) {card}",
                  flush=True)
            for rec in tel.rounds:
                totals = {k: round(v["total_s"], 6) for k, v in rec["spans"].items()}
                n_spans = sum(v["count"] for v in rec["spans"].values())
                print(f"telemetry: round {rec['round']} span seconds by name {json.dumps(totals)}, {n_spans} spans, "
                      f"kernel launches {json.dumps(rec['kernel_launches'])} {card}", flush=True)
                _require(rec["kernel_launches"] == per_round,
                         f"round {rec['round']} record's launches {rec['kernel_launches']}, phase 5's are {per_round}")
            print(f"telemetry: {tel.metrics.updates / len(tel.rounds):.1f} metric updates and "
                  f"{len(tel.tracer.spans) / len(tel.rounds):.1f} spans a round {card}", flush=True)
            for name in TELEMETRY_ARTIFACTS:
                _require((tel.out_dir / name).exists(), f"telemetry: {name} not written")
            doc = json.loads((tel.out_dir / "trace.json").read_text())
            names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
            _require(set(TELEMETRY_SPANS) <= names, f"telemetry: trace.json spans {sorted(names)}")
            rounds = [json.loads(line) for line in (tel.out_dir / "rounds.jsonl").read_text().splitlines()]
            _require([r["round"] for r in rounds] == [1, 2, 3], "telemetry: rounds.jsonl")
            out.setdefault("spans_per_round", len(tel.tracer.spans) / len(tel.rounds))
            out.setdefault("metric_updates_per_round", tel.metrics.updates / len(tel.rounds))
            out.setdefault("jit_cost_first_s", sum(tel.cost_seconds.values()))
            out["jit_cost_fresh_s"] = sum(tel.cost_seconds.values())
    on, off, again = runs
    for other, label in ((off, "off"), (again, "on again")):
        _require([h.test_acc for h in on.history] == [h.test_acc for h in other.history],
                 f"telemetry on vs {label}: accuracies differ")
        _require(torch.equal(_flat_row(on.final_params), _flat_row(other.final_params)),
                 f"telemetry on vs {label}: parameters are not bit-equal")
    on_s = [h.wall_seconds for r in (on, again) for h in r.history[1:]]
    off_s = [h.wall_seconds for h in off.history[1:]]
    mean_on, mean_off = sum(on_s) / len(on_s), sum(off_s) / len(off_s)
    print(f"telemetry: timed rounds on {[round(x, 4) for x in on_s]} off {[round(x, 4) for x in off_s]}: mean "
          f"{mean_on:.4f}s on vs {mean_off:.4f}s off, {mean_on - mean_off:+.4f}s "
          f"({(mean_on / mean_off - 1) * 100:+.2f}%) {card}", flush=True)
    epoch = next(sp for sp in on.telemetry.tracer.spans if sp.name == "cohort_epoch")
    c, steps, batch = epoch.attrs["clients"], epoch.attrs["steps"], epoch.attrs["batch"]
    pack = FlatPack(sc.program.init(torch.Generator().manual_seed(0)))
    cpu = Telemetry().jit_cost(
        "cohort_epoch_flat", _cohort_epoch_flat, torch.zeros((c, pack.dim)),
        torch.zeros((c, steps, batch, *sc.program.feat_shape)), torch.zeros((c, steps, batch), dtype=torch.int64),
        pack.spec, sc.program, steps, sc.clients[0].lr,
    )
    print(f"telemetry: cohort_epoch_flat C {c} S {steps} B {batch}: {epoch.attrs['flops']:.0f} FLOPs, "
          f"{epoch.attrs['bytes_moved']:.0f} bytes in the card's run; the CPU's count {cpu['flops']:.0f} FLOPs "
          f"{card}", flush=True)
    _require(epoch.attrs["flops"] == cpu["flops"], "telemetry: cohort_epoch_flat FLOPs differ from the CPU's count")
    out.update(seconds_on=mean_on, seconds_off=mean_off, cohort_epoch_flops=epoch.attrs["flops"],
               cohort_epoch_bytes=epoch.attrs["bytes_moved"])

    # one telemetry-on device round under sync-debug "error"
    eng = BatchedSyncEngine(sc.clients, lam, sc.program, sc.test, telemetry=Telemetry())
    real, calls = eng._edge_round_device, []

    def round_without_sync(edge_mats):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            result = real(edge_mats)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(len(edge_mats))
        return result

    eng._edge_round_device = round_without_sync
    res = eng.run(1)
    _require(calls == [1] and len(eng.tel.rounds) == 1, "telemetry: the sync-debug round did not run")
    print(f"telemetry: a telemetry-on device edge round (its jit_cost included) ran under sync-debug \"error\": "
          f"acc {res.history[-1].test_acc:.6f} {card}", flush=True)

    # the mixed population: the fuse's span and losses, async's simulated-time track
    for engine in ("sync", "async"):
        res = mix_sc.simulate(mix_lam, cloud_rounds=1, engine=engine, telemetry=True)
        tel = res.telemetry
        fuse = [sp for sp in tel.tracer.spans if sp.name == "kd_fuse"]
        kd = tel.metrics.hists.get("kd_loss")
        sim = [sp for sp in tel.tracer.spans if sp.track == "sim"]
        _require(len(fuse) == 1 and kd is not None and kd.count == 2, f"mix {engine}: kd_fuse span or kd_loss missing")
        print(f"telemetry: mix {engine}: kd_fuse {fuse[0].duration:.4f}s ({fuse[0].attrs.get('flops', 0):.0f} FLOPs), "
              f"kd_loss {[round(v, 6) for v in kd.samples]}, simulated-time spans {len(sim)} {card}", flush=True)
        if engine == "async":
            with tempfile.TemporaryDirectory() as tmp:
                doc = json.loads(tel.tracer.write_chrome_trace(Path(tmp) / "trace.json").read_text())
            pid2 = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["pid"] == 2]
            _require(pid2 and any(e["name"] == "upload" for e in pid2), "mix async: no simulated-time track on pid 2")

    # one 1M-client streaming round with the page gauges
    ssc = build_scenario("heartbeat", lazy=True, n_eus=1_000_000, n_edges=STREAM_EDGES)
    res = ssc.simulate(CohortSpec(size=STREAM_COHORT, seed=0), cloud_rounds=1, telemetry=True)
    tel = res.telemetry
    gauges = {k: tel.metrics.gauges[k] for k in ("participating", "page_hits", "page_misses", "page_evictions")}
    totals = {k: round(v["total_s"], 6) for k, v in tel.rounds[0]["spans"].items()}
    print(f"telemetry: stream M=1,000,000 round 1 {res.history[-1].wall_seconds:.4f}s, gauges {json.dumps(gauges)}, "
          f"span seconds {json.dumps(totals)}, launches {json.dumps(tel.rounds[0]['kernel_launches'])} {card}",
          flush=True)
    _require(gauges["page_misses"] == STREAM_COHORT and set(TELEMETRY_SPANS) <= set(totals),
             "stream: page gauges or spans missing")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"telemetry: phase 6f {out['phase_s']:.1f}s {card}", flush=True)
    return out


# phase 6g: serving under traffic on the heartbeat path, and the LM population
HEARTBEAT_TRAFFIC = dict(queries=1024, batch=128, seed=0)
LM_TRAFFIC = dict(queries=256, batch=64, seed=0)


def _served_params():
    """A patch of ``ServeTraffic.on_round`` that keeps a CPU copy of the
    model each round swaps in (``params_fn``'s tree), by round, outside the
    ``serve_qps`` timer; returns (the copies, a function that undoes the
    patch)."""
    from repro_torch.serving import ServeTraffic
    from repro_torch.utils.tree import tree_map

    real, kept = ServeTraffic.on_round, {}

    def on_round(self, cloud_round, params_fn):
        def keep():
            params = params_fn()
            kept[cloud_round] = tree_map(lambda t: t.detach().cpu(), params)
            return params

        return real(self, cloud_round, keep)

    ServeTraffic.on_round = on_round
    return kept, lambda: setattr(ServeTraffic, "on_round", real)


def _lm_kernels(lm_sc, lm_lam, rate: float, smi: str, label: str = "the LM shape", group=None) -> dict:
    """Both FedAvg kernels at a token population's shapes (the edge FedAvg
    of its EARA-SCA pairs, N 12 into E 4 for the LM, and the cloud reduce
    over the edges, N 4, D 20,640 fp32 for the LM), each against its plain
    version (1e-5) and timed beside it and the library call (``wmat @ x``,
    ``wn @ x``) in this call.  ``group`` (an index of ``group_clients``)
    takes one group of a mixed population: its program's width, its
    clients' pairs and their data sizes."""
    import importlib

    import numpy as np
    import torch

    from repro_torch.federated import group_clients
    from repro_torch.kernels import (
        hier_aggregate,
        hier_aggregate_ref,
        hier_segment_aggregate,
        hier_segment_aggregate_ref,
    )
    from repro_torch.utils.tree import tree_num_params

    agg_mod = importlib.import_module("repro_torch.kernels.hier_aggregate")
    seg_mod = importlib.import_module("repro_torch.kernels.segment_aggregate")
    dev = torch.device("cuda")
    sizes = np.asarray([c.data_size for c in lm_sc.clients], np.float32)
    if group is None:
        program, member = lm_sc.program, np.ones(len(sizes), bool)
    else:
        programs, group_of = group_clients(lm_sc.clients)
        program, member = programs[group], np.asarray(group_of) == group
    d = tree_num_params(program.init(torch.Generator().manual_seed(0)))
    pc, pe = np.nonzero(lm_lam * member[:, None])
    n, e = len(pc), lm_lam.shape[1]
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32, device=dev)
    seg = torch.as_tensor(pe, dtype=torch.int32, device=dev)
    w = torch.as_tensor(sizes[pc], dtype=torch.float32, device=dev)
    err = _close(hier_segment_aggregate(x, seg, w, e), hier_segment_aggregate_ref(x, seg, w, e), TOL["float32"])
    wmat = hier_segment_aggregate_ref(torch.eye(n, device=dev), seg, w, e)
    seg_t = {"N": n, "E": e, "D": d, "max_abs_err": err, **_timings(
        kernel=lambda: seg_mod._launch(x, seg, w, e), wrapper=lambda: hier_segment_aggregate(x, seg, w, e),
        plain=lambda: hier_segment_aggregate_ref(x, seg, w, e), library=lambda: wmat @ x,
        nbytes=(n + e) * d * 4 + n * 8, rate=rate)}
    xa = torch.as_tensor(rng.standard_normal((e, d)), dtype=torch.float32, device=dev)
    wa = torch.as_tensor(lm_lam.T.astype(np.float32) @ (sizes * member), device=dev)
    err = _close(hier_aggregate(xa, wa), hier_aggregate_ref(xa, wa), TOL["float32"])
    wn = wa / wa.sum().clamp_min(1e-30)
    agg_t = {"N": e, "D": d, "max_abs_err": err, **_timings(
        kernel=lambda: agg_mod._launch(xa, wa), wrapper=lambda: hier_aggregate(xa, wa),
        plain=lambda: hier_aggregate_ref(xa, wa), library=lambda: wn @ xa, nbytes=(e + 1) * d * 4 + e * 4, rate=rate)}
    for name, t in (("hier_segment_aggregate", seg_t), ("hier_aggregate", agg_t)):
        print(f"lm: kernel {name} at {label} {_fmt(t)} [{smi}]", flush=True)
    return {"hier_segment_aggregate": seg_t, "hier_aggregate": agg_t}


def _serve_lm_phase(sc, lam, rate: float, smi: str) -> dict:
    """Phase 6g: serving under traffic, and the LM population.

    Heartbeat EARA-SCA at full size on the device pipeline, 3 cloud rounds
    with ``serve=TrafficSpec(queries=1024, batch=128)`` and without:
    bit-equal parameters and history, staleness 0 every round, each
    round's ``serve_acc`` within 2/1024 of the same model served on the CPU;
    then ``swap_every=2`` (staleness 0, 1, 0) and one async round at its
    defaults, serving.  The LM population (``build_scenario("lm")`` at
    ``scale=1.0``, EARA-SCA): 3 device-pipeline rounds serving
    ``TrafficSpec(queries=256, batch=64)`` (launch counts zeroed just before
    and read just after: 1 segment and 1 ``hier_aggregate`` a round), the
    same on the CPU (parameters within 5e-3, next-token accuracy within
    1e-3), a telemetry-on run (round 2's span seconds) and a round under
    ``torch.profiler`` (the card's busy share), one host-pipeline round
    (``_expected_aggregates`` launches), and both kernels at its shapes.
    Every line carries the card's name and power limit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import BatchedSyncEngine
    from repro_torch.federated import build_scenario
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ServeTraffic, TrafficSpec

    t_phase = time.perf_counter()
    card = f"[{smi}]"
    out = {}

    # heartbeat: serve on and off, 3 device rounds each
    kept, restore = _served_params()
    try:
        on = sc.simulate(lam, cloud_rounds=3, engine="sync", pipeline="device", serve=TrafficSpec(**HEARTBEAT_TRAFFIC))
    finally:
        restore()
    off = sc.simulate(lam, cloud_rounds=3, engine="sync", pipeline="device")
    _require(torch.equal(_flat_row(on.final_params), _flat_row(off.final_params)),
             "serve: parameters with serve on and off are not bit-equal")
    _require([(h.test_acc, h.mean_local_loss) for h in on.history] == [
        (h.test_acc, h.mean_local_loss) for h in off.history], "serve: histories with serve on and off differ")
    _require([r["serve_staleness_rounds"] for r in on.serve_history] == [0.0] * 3, "serve: staleness is not 0")
    cpu = ServeTraffic(TrafficSpec(**HEARTBEAT_TRAFFIC), sc.clients, sc.program, device="cpu")
    gaps = []
    for rec in on.serve_history:
        b = rec["round"]
        gaps.append(abs(cpu.on_round(b, lambda b=b: kept[b])["serve_acc"] - rec["serve_acc"]))
        _require(gaps[-1] <= 2 / 1024 + 1e-9, f"serve: round {b} serve_acc card vs CPU differs by {gaps[-1]}")
    on_s, off_s = [h.wall_seconds for h in on.history], [h.wall_seconds for h in off.history]
    print(f"serve: heartbeat device pipeline seconds a round on {[round(x, 4) for x in on_s]} off "
          f"{[round(x, 4) for x in off_s]} (round 1 warm-up); serve_qps "
          f"{[round(r['serve_qps']) for r in on.serve_history]}, serve_acc "
          f"{[round(r['serve_acc'], 6) for r in on.serve_history]}, card vs CPU gaps {gaps}; parameters bit-equal "
          f"{card}", flush=True)
    out["heartbeat"] = {"seconds_on": on_s, "seconds_off": off_s, "serve_acc_gaps": gaps,
                        "serve_qps": [r["serve_qps"] for r in on.serve_history]}

    stale = sc.simulate(lam, cloud_rounds=3, engine="sync", pipeline="device",
                        serve=TrafficSpec(**HEARTBEAT_TRAFFIC, swap_every=2))
    st = [r["serve_staleness_rounds"] for r in stale.serve_history]
    _require(st == [0.0, 1.0, 0.0], f"serve: swap_every=2 staleness {st}")
    res = sc.simulate(lam, cloud_rounds=1, engine="async", serve=TrafficSpec(**HEARTBEAT_TRAFFIC))
    rec = res.serve_history[0]
    print(f"serve: swap_every=2 staleness {st}; async round 1 {res.history[0].wall_seconds:.4f}s serve_qps "
          f"{rec['serve_qps']:.0f} serve_acc {rec['serve_acc']:.6f} {card}", flush=True)

    # the LM population
    t0 = time.perf_counter()
    lm_sc = build_scenario("lm", scale=1.0)
    lm_lam = lm_sc.assign("eara-sca").lam
    print(f"lm: build_scenario lm scale=1.0 and eara-sca {time.perf_counter() - t0:.3f}s: {len(lm_sc.clients)} EUs, "
          f"{lm_sc.n_edges} edges, {sum(c.data_size for c in lm_sc.clients)} sequences, per-edge EUs "
          f"{lm_lam.sum(axis=0).tolist()} {card}", flush=True)
    traffic = TrafficSpec(**LM_TRAFFIC)
    torch.cuda.synchronize()
    reset_launch_counts()
    gpu = lm_sc.simulate(lm_lam, cloud_rounds=3, engine="sync", pipeline="device", serve=traffic)
    torch.cuda.synchronize()
    counts = launch_counts()
    _require(counts["hier_segment_aggregate"] == 3 and counts["hier_aggregate"] == 3,
             f"lm: device launches {counts}, expected 1 segment and 1 aggregate a round")
    cpu_run = lm_sc.simulate(lm_lam, cloud_rounds=3, engine="sync", pipeline="device", serve=traffic, device="cpu")
    acc_gap = max(abs(a.test_acc - b.test_acc) for a, b in zip(gpu.history, cpu_run.history))
    param_gap = float((_flat_row(gpu.final_params).cpu() - _flat_row(cpu_run.final_params)).abs().max())
    serve_gap = max(abs(a["serve_acc"] - b["serve_acc"]) for a, b in zip(gpu.serve_history, cpu_run.serve_history))
    print(f"lm: device pipeline seconds a round {[round(h.wall_seconds, 4) for h in gpu.history]} (serving "
          f"{LM_TRAFFIC['queries']} queries), next-token accuracy {[round(h.test_acc, 6) for h in gpu.history]}, "
          f"loss {[round(h.mean_local_loss, 6) for h in gpu.history]}, serve_qps "
          f"{[round(r['serve_qps']) for r in gpu.serve_history]}, launches {json.dumps(counts)}; card vs CPU: "
          f"accuracy {acc_gap:.3g}, parameters {param_gap:.3g}, serve_acc {serve_gap:.3g} {card}", flush=True)
    _require(acc_gap <= 1e-3, f"lm: card and CPU accuracy differ by {acc_gap}")
    _require(param_gap <= 5e-3, f"lm: card and CPU parameters differ by {param_gap}")
    _require(gpu.accountant.totals() == cpu_run.accountant.totals(), "lm: card and CPU accounting differ")
    # where an LM round's time goes: round 2 of a telemetry-on run (round 1
    # pays the first counts of jit_cost), then one round under torch.profiler
    tel = lm_sc.simulate(lm_lam, cloud_rounds=2, engine="sync", pipeline="device", serve=traffic,
                         telemetry=True).telemetry
    rec = tel.rounds[-1]
    totals = {k: round(v["total_s"], 6) for k, v in rec["spans"].items()}
    cohorts = [(sp.attrs["clients"], sp.attrs["steps"]) for sp in tel.tracer.spans
               if sp.name == "cohort_epoch" and sp.attrs["round"] == 2]
    print(f"lm: telemetry round 2 {rec['wall_s']:.4f}s, span seconds by name {json.dumps(totals)}, cohorts "
          f"(clients, steps) {cohorts}, analytic FLOPs of a cohort epoch "
          f"{tel.metrics.gauges.get('analytic_flops/cohort_epoch_flat', 'not counted')} {card}", flush=True)
    eng = BatchedSyncEngine(lm_sc.clients, lm_lam, lm_sc.program, lm_sc.test)
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
    _report_profile(prof, plain_wall, wall, f"lm: profile round {card}")
    host, host_counts = _run_counted(lm_sc, lm_lam, "lm sync-host", cloud_rounds=1, engine="sync", pipeline="host")
    _require(host_counts["hier_aggregate"] == _expected_aggregates(lm_lam, 1, 1),
             f"lm: host launches {host_counts}, expected {_expected_aggregates(lm_lam, 1, 1)} hier_aggregate")
    out["lm"] = {"launches": counts, "seconds_per_round": [h.wall_seconds for h in gpu.history],
                 "acc_gap": acc_gap, "param_gap": param_gap, "kernels": _lm_kernels(lm_sc, lm_lam, rate, smi)}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serve: phase 6g {out['phase_s']:.1f}s {card}", flush=True)
    return out


def _paths_only(root: Path) -> int:
    """``--paths ROOT``: for the port under ``ROOT/src``, the heartbeat
    device-pipeline round (phase 6's: a fresh engine, one warm-up round,
    then 3 timed rounds, telemetry off) and the full-width serve (phase 8's
    uniform batch of 4 x 2048 tokens + 32 new, after a warm-up), then
    ``jit_cost`` of the heartbeat cohort epoch (C 18, S 128) twice (the
    process's first count pays PyTorch's one-time imports, the second is a
    fresh ``Telemetry``'s; a tree whose ``jit_cost`` counts nothing returns
    ``None`` at once), then 3 more timed rounds of the same engine: prints
    one JSON line.  Alternating two trees in one run compares them on one
    card."""
    import dataclasses

    import numpy as np
    import torch

    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.engine import BatchedSyncEngine, FlatPack
    from repro_torch.engine.cohort import _cohort_epoch_flat
    from repro_torch.federated import CNNProgram, build_scenario
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.telemetry import Telemetry

    _require(Path(repro_torch.__file__).resolve().is_relative_to(root), f"repro_torch not imported from {root}")
    record = {"tree": str(root), "card": _smi()}
    sc = build_scenario("heartbeat")
    lam = sc.assign("eara-sca").lam
    eng = BatchedSyncEngine(sc.clients, lam, sc.program, sc.test)
    eng.run(1)

    def rounds():
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(1)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return secs

    record["heartbeat_round_s"] = rounds()
    cfg = dataclasses.replace(get_config("qwen3-14b"), use_flash=True)
    tel = Telemetry()
    engine = ServeEngine(cfg, max_seq=2080, seed=0, device="cuda", telemetry=tel)
    rng = np.random.default_rng(0)
    engine.run([Request(rng.integers(0, cfg.vocab_size, 64).astype(np.int32), max_new_tokens=2)])
    prompts = rng.integers(0, cfg.vocab_size, (4, 2048)).astype(np.int32)
    _warm_serve_cost(engine, prompts)
    engine.run([Request(p, max_new_tokens=32) for p in prompts])
    torch.cuda.synchronize()
    pre = [sp for sp in tel.tracer.spans if sp.name == "prefill"][-1]
    dec = [sp for sp in tel.tracer.spans if sp.name == "decode"][-1]
    record.update(prefill_s=pre.duration, decode_tok_s=dec.attrs["tokens"] / dec.duration)
    del engine
    prog = CNNProgram()
    pack = FlatPack(prog.init(torch.Generator().manual_seed(0)))
    args = (torch.zeros((18, pack.dim)), torch.zeros((18, 128, 10, *prog.feat_shape)),
            torch.zeros((18, 128, 10), dtype=torch.int64), pack.spec, prog, 128, 1e-3)
    record["compile_stack_imported_before"] = "torch._dynamo" in sys.modules
    for key in ("jit_cost_first_s", "jit_cost_fresh_s"):
        t0 = time.perf_counter()
        record["jit_cost"] = Telemetry().jit_cost("cohort_epoch_flat", _cohort_epoch_flat, *args)
        record[key] = time.perf_counter() - t0
    record["heartbeat_round_after_s"] = rounds()
    print(json.dumps(record), flush=True)
    return 0


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
    serve prefill, (b) starcoder2-3b's heads at 8192 tokens with its
    4096 window and (c) the granite-moe-3b-a800m prefill of phase 9a (Hq
    24, Hkv 8, d 64) and (d) whisper-tiny's decoder prefill of phase 11a (B 4,
    S 384, Hq 6, Hkv 6, d 64), and of the SIMT kernel at the "fp32" case, at phase 7's
    shape (qwen3-14b widths in fp32) and at phase 9b's (granite-moe widths
    in fp32: B 4, S 512, Hq 24, Hkv 8, d 64), with the name of the CUDA kernel that
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
        ("granite-moe-3b-a800m prefill (phase 9a)", 4, 2048, 24, 8, 64, None, bf16, "granite"),
        ("whisper-tiny decoder prefill (phase 11a)", WHISPER_B, WHISPER_S, 6, 6, 64, None, bf16, "whisper"),
        ("starcoder2-3b window", 1, 8192, 24, 2, 128, 4096, bf16, "window"),
        ("fp32", 2, 1024, 16, 4, 128, None, f32, "simt"),
        ("fp32 qwen3-14b widths (phase 7)", 4, 1536, 40, 8, 128, None, f32, "simt_phase7"),
        ("fp32 granite-moe-3b-a800m widths (phase 9b)", 4, 512, 24, 8, 64, None, f32, "simt_granite"),
        ("fp32 jamba-1.5-large-398b smoke prefill (phase 10b)", JAMBA_SMOKE_B, JAMBA_SMOKE_S, 8, 2, 16, None, f32,
         "simt_jamba"),
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
            t["max_abs_err"] = err  # a variant's main case takes its worst case's below
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


def _topk_phase(rate: float, floor: dict) -> dict:
    """Phase 3, top-k gating: the kernel against its plain version on the
    card (1e-5; bit for bit on ties and underflow and at the two shapes of
    phase 9's path), timed at granite-moe-3b-a800m's router width (E 40, k
    8) at the decode shape of phase 9a (T 4, the record's main shape), at
    phase 9b's dense prefill (T 2048) and for 8192 tokens, and at E 128 and
    1000.  No single PyTorch call computes it, so there is no library time;
    beside it, as a yardstick only, softmax -> topk -> scatter -> divide."""
    import torch

    from repro_torch.kernels.topk_gating import _launch, topk_gating, topk_gating_ref

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)

    def logits(t, e, dtype=torch.float32):
        return (torch.randn((t, e), generator=gen, device=dev) * 2).to(dtype)

    ties = torch.full((6, 65), -200.0, device=dev)  # every -200 underflows to probability 0
    ties[0, [64, 32, 1]] = 0.0   # a three-way tie over three register slots
    ties[1, [32, 31]] = 0.0      # the lowest index sits on the highest lane
    ties[2, 64] = 0.0            # one expert holds all the mass
    ties[3] = 0.0                # all equal
    ties[4] = 0.0
    ties[4, ::3] = 1.0           # a sum whose bits depend on its order: torch.softmax's
    ties[5, 5] = 300.0
    cases = [
        # label, logits, k, timed, bit for bit
        ("granite-moe decode, phase 9a", logits(4, 40), 8, "main", True),
        ("granite-moe prefill, phase 9b", logits(2048, 40), 8, "timed", True),
        ("granite-moe router", logits(8192, 40), 8, "timed", False),
        ("jamba smoke decode, phase 10b", logits(JAMBA_SMOKE_B, 4), 2, "timed", False),
        ("jamba smoke prefill, phase 10b", logits(JAMBA_SMOKE_B * JAMBA_SMOKE_S, 4), 2, "timed", False),
        ("E 128", logits(8192, 128), 8, "timed", False),
        ("E 1000", logits(8192, 1000), 8, "timed", False),
        ("bf16", logits(8192, 40, torch.bfloat16), 8, None, False),
        *((f"E {e}", logits(300, e, dtype), 8, None, False)
          for e in (32, 33, 56, 57, 64, 65, 1024) for dtype in (torch.float32, torch.bfloat16)),
        ("ties and underflow", ties, 8, None, True),
        ("ties and underflow, k 1", ties, 1, None, True),
        ("k > E", logits(64, 33), 40, None, False),
        ("k 0", logits(64, 40), 0, None, False),
    ]
    result = {"max_abs_err": 0.0, "other_shapes": []}
    for label, x, k, timed, exact in cases:
        got = topk_gating(x, k)
        want = topk_gating_ref(x, k)
        torch.cuda.synchronize()
        if exact:
            _require(torch.equal(got, want), f"topk_gating [{label}]: not bit for bit the plain version")
        err = _close(got, want, 1e-5)
        result["max_abs_err"] = max(result["max_abs_err"], err)
        line = f"kernel topk_gating [{label}] T={x.shape[0]} E={x.shape[1]} k={k} {x.dtype}: max_abs_err={err:.3g}"
        if timed in ("main", "timed"):
            def yardstick(x=x, k=k):
                probs = torch.softmax(x.float(), dim=-1)
                top, idx = torch.topk(probs, k, dim=-1)
                return torch.zeros_like(probs).scatter_(-1, idx, top) / top.sum(-1, keepdim=True).clamp_min(1e-9)

            t = {
                "ms": _device_ms(lambda: _launch(x, k))[0],
                "plain_ms": _device_ms(lambda: topk_gating_ref(x, k))[0],
                "library_ms": None,
                "bound_ms": x.numel() * (x.element_size() + 4) / rate * 1e3,
                "bound_by": "bytes",
                "yardstick_ms": _device_ms(yardstick)[0],
                **floor,
            }
            if timed == "main":
                result.update(t)
            else:
                result["other_shapes"].append({"T": x.shape[0], "E": x.shape[1], "k": k, **t})
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
    _warm_serve_cost(engine, prompts)
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


# phase 9: the MoE family
MOE_ARCH = "granite-moe-3b-a800m"
MOE_MIX = {"lm": 8, "moe": 4}


def _moe_serve(smi: str) -> dict:
    """Phase 9a: granite-moe-3b-a800m at published widths (bf16, random
    weights from seed 0, ``use_flash=True``) through ``ServeEngine``.  One
    prefill of 4 x 2048 tokens and one decode step, each with the launch
    counts zeroed just before and read just after (the prefill: one bf16
    ``wgmma`` flash launch per layer and no ``topk_gating``, its 8,192
    tokens taking the capacity dispatch; a decode step: one ``topk_gating``
    per layer and no flash); then the uniform batch served with 32 new
    tokens each (counts zeroed just before and read just after: one flash
    launch per layer, one ``topk_gating`` per layer and decode step);
    ``use_flash=False`` on the same parameters (prefill-logit difference,
    token agreement); one prefill and 4 decode steps under
    ``torch.profiler``."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, launch_counts, reset_launch_counts
    from repro_torch.models.transformer import decode_step, prefill
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.telemetry import Telemetry

    card = f"[{smi}]"
    cfg = dataclasses.replace(get_config(MOE_ARCH), use_flash=True)
    n_layers = cfg.n_layers
    t0 = time.perf_counter()
    tel = Telemetry()
    engine = ServeEngine(cfg, max_seq=2080, seed=0, device="cuda", telemetry=tel)
    torch.cuda.synchronize()
    leaves = _leaves(engine.params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"moe: {cfg.name} {n_layers} layers d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} experts "
          f"{cfg.moe.n_experts} top-{cfg.moe.top_k} d_ff {cfg.d_ff} vocab {cfg.vocab_size} {cfg.dtype}: {n_params} "
          f"parameters, {n_bytes} bytes, drawn in {time.perf_counter() - t0:.3f}s {card}", flush=True)
    rng = np.random.default_rng(0)
    engine.run([Request(rng.integers(0, cfg.vocab_size, 64).astype(np.int32), max_new_tokens=2)])  # warm-up
    prompts = rng.integers(0, cfg.vocab_size, (4, 2048)).astype(np.int32)
    _warm_serve_cost(engine, prompts)
    toks = torch.as_tensor(prompts, device="cuda")

    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launch_counts()
        logits, cache = prefill(engine.params, cfg, toks, max_seq=2080)
        torch.cuda.synchronize()
        pre_counts, pre_variants = launch_counts(), dict(flash_attention.launches_by_variant)
        reset_launch_counts()
        decode_step(engine.params, cfg, logits[:, -1].argmax(-1)[:, None], cache,
                    torch.full((4,), 2048, device="cuda"))
        torch.cuda.synchronize()
        step_counts = launch_counts()
    del logits, cache
    print(f"moe: one prefill 4 x 2048 launches {json.dumps(pre_counts)} flash by variant {json.dumps(pre_variants)}; "
          f"one decode step launches {json.dumps(step_counts)} {card}", flush=True)
    _require(pre_counts["flash_attention"] == n_layers and pre_variants["wgmma"] == n_layers,
             f"moe prefill: flash launches {pre_counts} {pre_variants}, not {n_layers} wgmma")
    _require(pre_counts["topk_gating"] == 0, "moe prefill: 8,192 tokens a call launched topk_gating")
    _require(step_counts["topk_gating"] == n_layers and step_counts["flash_attention"] == 0,
             f"moe decode step: launches {step_counts}, not {n_layers} topk_gating and no flash")

    def spans():
        pre = [s for s in tel.tracer.spans if s.name == "prefill"][-1]
        dec = [s for s in tel.tracer.spans if s.name == "decode"][-1]
        return pre, dec

    reqs = [Request(p, max_new_tokens=32) for p in prompts]
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    engine.run(reqs)
    torch.cuda.synchronize()
    counts, variants = launch_counts(), dict(flash_attention.launches_by_variant)
    pre, dec = spans()
    out = {"launches": counts["topk_gating"], "decode_steps": dec.attrs["steps"], "prefill_s": pre.duration,
           "decode_tok_s": dec.attrs["tokens"] / dec.duration, "peak_bytes": torch.cuda.max_memory_allocated(),
           "n_params": n_params, "n_bytes": n_bytes, "flash_wgmma": variants["wgmma"]}
    print(f"moe: uniform 4 x 2048, 32 new tokens: prefill {pre.duration:.4f}s, decode {dec.attrs['steps']} steps "
          f"{dec.duration:.4f}s = {out['decode_tok_s']:.2f} tok/s; max_memory_allocated {out['peak_bytes']} bytes; "
          f"launches {json.dumps(counts)} flash by variant {json.dumps(variants)} {card}", flush=True)
    _require(counts["flash_attention"] == n_layers and variants["wgmma"] == n_layers,
             f"moe serve: flash launches {counts} {variants}, not {n_layers} wgmma")
    _require(counts["topk_gating"] == n_layers * dec.attrs["steps"],
             f"moe serve: {counts['topk_gating']} topk_gating launches, not {n_layers} per decode step")
    for r in reqs:
        _require(r.out.shape == (32,) and 0 <= r.out.min() and r.out.max() < cfg.vocab_size, "moe: bad tokens")

    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    with torch.inference_mode():
        lf = prefill(engine.params, cfg, toks, max_seq=2048)[0]
        lp = prefill(engine.params, plain_cfg, toks, max_seq=2048)[0]
    _require(bool(torch.isfinite(lf).all() and torch.isfinite(lp).all()), "moe: non-finite prefill logits")
    out["flash_vs_plain_logits"] = float((lf - lp).abs().max())
    argmax_same = int((lf.argmax(-1) == lp.argmax(-1)).sum())
    del lf, lp
    plain = ServeEngine(plain_cfg, params=engine.params, max_seq=2080, device="cuda")
    plain_out = [r.out for r in plain.run([Request(p, max_new_tokens=32) for p in prompts])]
    out["leading_tokens_equal"] = [int(np.sum(np.cumprod(a == b))) for a, b in zip((r.out for r in reqs), plain_out)]
    print(f"moe: bf16 use_flash on vs off, same params: prefill logits max |diff| {out['flash_vs_plain_logits']:.4g}, "
          f"first tokens equal {argmax_same}/4, leading tokens equal per row {out['leading_tokens_equal']} of 32 "
          f"{card}", flush=True)

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
    _report_profile(prof, plain_wall, wall, f"moe profile: prefill + 4 decode steps {card}")
    del engine, plain
    torch.cuda.empty_cache()
    return out


def _moe_exactness(smi: str) -> dict:
    """Phase 9b: granite-moe widths cut to 2 layers, fp32, on the card.  A
    uniform 4 x 512 batch (2,048 tokens: the dense dispatch, so
    ``topk_gating`` runs in the prefill too) gives the same tokens with
    ``use_flash`` on and off; a ragged batch under 4096 tokens gives the
    same tokens as its requests served alone.  Launch counts are zeroed
    just before and read just after the uniform batch: 2 ``topk_gating`` a
    prefill and 2 a decode step, 2 fp32 flash launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.serving import Request, ServeEngine

    card = f"[{smi}]"
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=2, dtype="float32", use_flash=True)
    params = init_params(torch.Generator("cuda").manual_seed(1), cfg)
    rng = np.random.default_rng(1)
    new = 8

    def serve(engine, prompts):
        return [r.out for r in engine.run([Request(p, max_new_tokens=new) for p in prompts])]

    flash = ServeEngine(cfg, params=params, max_seq=600, device="cuda")
    plain = ServeEngine(dataclasses.replace(cfg, use_flash=False), params=params, max_seq=600, device="cuda")
    uniform = list(rng.integers(0, cfg.vocab_size, (4, 512)).astype(np.int32))
    torch.cuda.synchronize()
    reset_launch_counts()
    a = serve(flash, uniform)
    torch.cuda.synchronize()
    counts, variants = launch_counts(), dict(flash_attention.launches_by_variant)
    want = cfg.n_layers * new  # one prefill and new - 1 decode steps
    _require(counts["topk_gating"] == want, f"moe exact: {counts['topk_gating']} topk_gating launches, not {want}")
    _require(variants["simt"] == cfg.n_layers, f"moe exact: flash launches by variant {variants}")
    b = serve(plain, uniform)
    same = all(np.array_equal(x, y) for x, y in zip(a, b))
    print(f"moe exact: {cfg.name} 2 layers fp32, uniform 4 x 512: use_flash on/off tokens identical {same}; "
          f"launches {json.dumps(counts)} flash by variant {json.dumps(variants)} {card}", flush=True)
    _require(same, "moe exact: use_flash on and off give different tokens in fp32")
    ragged = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (512, 300, 411, 200)]
    batched = serve(flash, ragged)
    for i, p in enumerate(ragged):
        _require(np.array_equal(batched[i], serve(flash, [p])[0]), f"moe exact: ragged row {i} differs from solo")
    print(f"moe exact: ragged batch (512, 300, 411, 200) token-identical to each request served alone {card}",
          flush=True)
    del flash, plain, params
    torch.cuda.empty_cache()
    return {"topk_gating": counts["topk_gating"], "flash_simt": variants["simt"]}


def _moe_card_vs_cpu(smi: str) -> None:
    """Phase 9c: one bf16 MoE layer at granite-moe-3b-a800m's published
    widths (phase 9a's layer: random weights from seed 0) through the
    dispatches that 9a runs, the capacity dispatch (prefill) and the dense
    dispatch with ``topk_gating``'s combine (decode), and the training
    forward's dense dispatch, on the card (bf16 products with fp32
    outputs) and on the CPU (the same products upcast): outputs within
    2e-2; then the granite-moe and dbrx smoke configs served with the same
    parameters on the card and on the CPU (prefill logits 1e-4, identical
    greedy tokens), and ``MoEProgram.loss`` and its gradient on one batch
    (loss 1e-5, gradient 1e-4)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.federated import PROGRAMS
    from repro_torch.models import init_params, moe
    from repro_torch.models.transformer import prefill
    from repro_torch.serving import Request, ServeEngine

    card = f"[{smi}]"
    rng = np.random.default_rng(0)
    cfg = get_config(MOE_ARCH)
    _require(cfg.param_dtype == torch.bfloat16, f"{cfg.name} is not bf16")
    layer = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    on_card = _tree_to(layer, "cuda")
    gen = torch.Generator().manual_seed(1)
    for label, fn, shape in (
        ("capacity dispatch (9a prefill)", lambda p, h: moe.moe_mlp_grouped(p, cfg, h)[0], (2, 256)),
        ("dense dispatch, topk_gating combine (9a decode)", lambda p, h: moe.moe_mlp_serve(p, cfg, h), (4, 32)),
        ("dense dispatch, router_topk combine (training)", lambda p, h: moe.moe_mlp(p, cfg, h)[0], (4, 32)),
    ):
        x = torch.randn((*shape, cfg.d_model), generator=gen).to(torch.bfloat16)
        with torch.inference_mode():
            want, got = fn(layer, x), fn(on_card, x.to("cuda"))
        _require(got.dtype == torch.bfloat16 and got.shape == x.shape,
                 f"moe bf16 layer {label}: {got.dtype} {tuple(got.shape)}")
        diff = float((got.float().cpu() - want.float()).abs().max())
        print(f"moe card-vs-cpu bf16 layer {cfg.name} d {cfg.d_model} E {cfg.moe.n_experts} top-{cfg.moe.top_k} "
              f"{label}, {shape[0]} x {shape[1]} tokens: max |diff| {diff:.3g} {card}", flush=True)
        _require(diff <= 2e-2, f"moe bf16 layer {label}: card and CPU differ by {diff}")
    del layer, on_card
    for arch in (MOE_ARCH, "dbrx-132b"):
        cfg = get_smoke_config(arch)
        params = init_params(torch.Generator().manual_seed(0), cfg)
        prompts = rng.integers(0, cfg.vocab_size, (3, 100))
        logits, outs = {}, {}
        for d in ("cuda", "cpu"):
            p = _tree_to(params, d)
            with torch.inference_mode():
                logits[d] = prefill(p, cfg, torch.as_tensor(prompts, device=d), max_seq=128)[0].cpu()
            eng = ServeEngine(cfg, params=p, max_seq=128, device=d)
            outs[d] = [r.out for r in eng.run([Request(x.astype(np.int32), max_new_tokens=16) for x in prompts])]
        diff = float((logits["cuda"] - logits["cpu"]).abs().max())
        same = all(np.array_equal(a, b) for a, b in zip(outs["cuda"], outs["cpu"]))
        print(f"moe card-vs-cpu serve {cfg.name}: prefill logits max |diff| {diff:.3g}, greedy tokens identical "
              f"{same} {card}", flush=True)
        _require(diff <= 1e-4, f"{cfg.name}: card and CPU prefill logits disagree")
        _require(same, f"{cfg.name}: card and CPU greedy tokens disagree")

    prog = PROGRAMS.get("moe")()
    params = prog.init(torch.Generator().manual_seed(0))
    x = torch.as_tensor(rng.integers(0, 128, (16, 32)))
    loss, grads = {}, {}
    for d in ("cuda", "cpu"):
        leaves = _leaves(_tree_to(params, d))
        for leaf in leaves:
            leaf.requires_grad_(True)
        p = _tree_from_leaves(params, iter(leaves))
        value = prog.loss(p, x.to(d), torch.zeros(16, dtype=torch.int64, device=d))
        grads[d] = torch.cat([g.reshape(-1).cpu() for g in torch.autograd.grad(value, leaves)])
        loss[d] = float(value.detach())
    loss_gap, grad_gap = abs(loss["cuda"] - loss["cpu"]), float((grads["cuda"] - grads["cpu"]).abs().max())
    print(f"moe card-vs-cpu MoEProgram.loss {loss['cuda']:.6f} vs {loss['cpu']:.6f} (|diff| {loss_gap:.3g}), "
          f"gradient max |diff| {grad_gap:.3g} over {grads['cpu'].numel()} parameters {card}", flush=True)
    _require(loss_gap <= 1e-5, "MoEProgram.loss: card and CPU disagree")
    _require(grad_gap <= 1e-4, "MoEProgram gradient: card and CPU disagree")


def _tree_from_leaves(tree, leaves):
    """``tree``'s nesting with its leaves taken in order from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _tree_from_leaves(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_from_leaves(v, leaves) for v in tree)
    return next(leaves)


def _moe_population(rate: float, smi: str) -> dict:
    """Phase 9d: ``build_scenario("lm", model="moe")`` at ``scale=1.0`` (the
    reference's defaults, nothing cut) under EARA-SCA on the device
    pipeline for 3 rounds (launch counts zeroed just before and read just
    after: 1 segment and 1 ``hier_aggregate`` a round; seconds a round),
    the same on the CPU (parameters within 5e-3, next-token accuracy within
    1e-3, equal accounting); then ``model_mix={"lm": 8, "moe": 4}`` for 1
    round on the device pipeline (2 segment and 2 ``hier_aggregate``
    launches) held to the host pipeline (accuracy within 2 test samples,
    parameters within 5e-3, equal accounting).  Both FedAvg kernels are held
    to their plain versions at the population's shapes and at each group's
    of the mix, and timed there."""
    import torch

    from repro_torch.federated import build_scenario
    from repro_torch.kernels import launch_counts, reset_launch_counts

    card = f"[{smi}]"
    t0 = time.perf_counter()
    sc = build_scenario("lm", model="moe", scale=1.0)
    lam = sc.assign("eara-sca").lam
    print(f"moe: build_scenario lm model=moe scale=1.0 and eara-sca {time.perf_counter() - t0:.3f}s: "
          f"{len(sc.clients)} EUs, {sc.n_edges} edges, {sum(c.data_size for c in sc.clients)} sequences, "
          f"{int(sc.model_bits) // 32} parameters {card}", flush=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    gpu = sc.simulate(lam, cloud_rounds=3, engine="sync", pipeline="device")
    torch.cuda.synchronize()
    counts = launch_counts()
    _require(counts["hier_segment_aggregate"] == 3 and counts["hier_aggregate"] == 3 and counts["topk_gating"] == 0,
             f"moe population: device launches {counts}, expected 1 segment and 1 aggregate a round")
    t0 = time.perf_counter()
    cpu = sc.simulate(lam, cloud_rounds=3, engine="sync", pipeline="device", device="cpu")
    cpu_s = time.perf_counter() - t0
    acc_gap = max(abs(a.test_acc - b.test_acc) for a, b in zip(gpu.history, cpu.history))
    param_gap = float((_flat_row(gpu.final_params).cpu() - _flat_row(cpu.final_params)).abs().max())
    out = {"seconds_per_round": [h.wall_seconds for h in gpu.history], "launches": counts,
           "acc_gap": acc_gap, "param_gap": param_gap,
           "kernels": _lm_kernels(sc, lam, rate, smi, label="the MoE population's shape")}
    print(f"moe: device pipeline seconds a round {[round(h.wall_seconds, 4) for h in gpu.history]}, next-token "
          f"accuracy {[round(h.test_acc, 6) for h in gpu.history]}, loss "
          f"{[round(h.mean_local_loss, 6) for h in gpu.history]}, launches {json.dumps(counts)}; the CPU's 3 rounds "
          f"{cpu_s:.2f}s; card vs CPU: accuracy {acc_gap:.3g}, parameters {param_gap:.3g} {card}", flush=True)
    _require(acc_gap <= 1e-3, f"moe population: card and CPU accuracy differ by {acc_gap}")
    _require(param_gap <= 5e-3, f"moe population: card and CPU parameters differ by {param_gap}")
    _require(gpu.accountant.totals() == cpu.accountant.totals(), "moe population: card and CPU accounting differ")

    mix = build_scenario("lm", model_mix=MOE_MIX)
    mix_lam = mix.assign("eara-sca").lam
    dev, dev_counts = _run_counted(mix, mix_lam, f"moe mix sync-device {card}", cloud_rounds=1, engine="sync",
                                   pipeline="device")
    _require(dev_counts["hier_segment_aggregate"] == 2 and dev_counts["hier_aggregate"] == 2,
             f"moe mix: device launches {dev_counts}, expected 2 segment and 2 aggregate a round")
    _require(set(dev.final_params) == set(MOE_MIX), f"moe mix: final_params keyed {sorted(dev.final_params)}")
    host, _ = _run_counted(mix, mix_lam, f"moe mix sync-host {card}", cloud_rounds=1, engine="sync", pipeline="host")
    _agree(f"moe mix device vs host {card}", dev, host, acc_tol=2 / len(mix.test))
    out["mix"] = {"launches": dev_counts, "seconds": dev.history[0].wall_seconds,
                  "host_seconds": host.history[0].wall_seconds,
                  "kernels": {name: _lm_kernels(mix, mix_lam, rate, smi, label=f"the mix's {name} group", group=g)
                              for g, name in enumerate(MOE_MIX)}}
    print(f"moe: mix {mix.name} device round {dev.history[0].wall_seconds:.4f}s, host round "
          f"{host.history[0].wall_seconds:.4f}s {card}", flush=True)
    return out


def _moe_phase(rate: float, smi: str) -> dict:
    """Phase 9, the MoE family: 9a-9d, each printed with the card's name and
    power limit, and the phase's seconds."""
    t_phase = time.perf_counter()
    out = {"serve": _moe_serve(smi), "exact": _moe_exactness(smi)}
    _moe_card_vs_cpu(smi)
    out["population"] = _moe_population(rate, smi)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"moe: phase 9 {out['phase_s']:.1f}s [{smi}]", flush=True)
    return out


# phase 10: the recurrent families (Mamba and RWKV)
RWKV_ARCH, JAMBA_ARCH = "rwkv6-7b", "jamba-1.5-large-398b"
RWKV_PARAMS = 6_997_811_200  # jax.eval_shape of the reference's init_params at rwkv6-7b
REC_MIX = {"lm": 6, "mamba": 3, "rwkv": 3}
# the rounds phase 10d holds a population's card run to the CPU's.  RWKV's
# training at scale=1.0 amplifies rounding: one leaf scaled by 1 + 1e-7
# moves its parameters by ~7e-3 after 3 rounds on the CPU, as far as the
# JAX package and the port differ there (tests/torch_drift_table.py), so it
# is held after its first round
CPU_ROUNDS = {"mamba": 3, "rwkv": 1}
# phase 10b's jamba smoke batch: a uniform 3 x 96 and ragged lengths
JAMBA_SMOKE_B, JAMBA_SMOKE_S = 3, 96
JAMBA_RAGGED = (96, 64, 64, 32)


def _rwkv_serve(smi: str) -> dict:
    """Phase 10a: rwkv6-7b at published widths (32 layers, d_model 4096, 64
    heads of 64, d_ff 14,336, vocab 65,536, bf16, random weights from seed
    0; its parameter count must be 6,997,811,200) through ``ServeEngine``.
    One 4 x 2048 prefill and one decode step with the launch counts zeroed
    just before and read just after (no kernel launch: the stack has no
    attention and no router); the uniform batch with 32 new tokens each
    (prefill seconds, decode tokens/s, peak memory); a ragged batch of
    lengths that are multiples of 64 through the exact-length buckets,
    token-identical to each request alone; one prefill and 4 decode steps
    under ``torch.profiler``; one RWKV mixer layer alone at the prefill's
    shape and its decode step at the batch's, timed."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import rwkv
    from repro_torch.models.transformer import decode_step, prefill
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.telemetry import Telemetry
    from repro_torch.utils.tree import tree_map

    card = f"[{smi}]"
    cfg = get_config(RWKV_ARCH)
    t0 = time.perf_counter()
    tel = Telemetry()
    engine = ServeEngine(cfg, max_seq=2080, seed=0, device="cuda", telemetry=tel)
    torch.cuda.synchronize()
    leaves = _leaves(engine.params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"rwkv: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} heads {cfg.d_model // cfg.rwkv.head_size} x "
          f"{cfg.rwkv.head_size} d_ff {cfg.d_ff} vocab {cfg.vocab_size} {cfg.dtype}: {n_params} parameters, "
          f"{n_bytes} bytes, drawn in {time.perf_counter() - t0:.3f}s {card}", flush=True)
    _require(n_params == RWKV_PARAMS, f"rwkv6-7b: {n_params} parameters, not {RWKV_PARAMS}")
    rng = np.random.default_rng(0)
    engine.run([Request(rng.integers(0, cfg.vocab_size, 64).astype(np.int32), max_new_tokens=2)])  # warm-up
    prompts = rng.integers(0, cfg.vocab_size, (4, 2048)).astype(np.int32)
    _warm_serve_cost(engine, prompts)
    toks = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launch_counts()
        logits, cache = prefill(engine.params, cfg, toks, max_seq=2080)
        torch.cuda.synchronize()
        pre_counts = launch_counts()
        reset_launch_counts()
        decode_step(engine.params, cfg, logits[:, -1].argmax(-1)[:, None], cache,
                    torch.full((4,), 2048, device="cuda"))
        torch.cuda.synchronize()
        step_counts = launch_counts()
    del logits, cache
    print(f"rwkv: one prefill 4 x 2048 launches {json.dumps(pre_counts)}; one decode step launches "
          f"{json.dumps(step_counts)} {card}", flush=True)
    _require(not any(pre_counts.values()) and not any(step_counts.values()),
             f"rwkv: the attention-free stack launched kernels {pre_counts} {step_counts}")

    reqs = [Request(p, max_new_tokens=32) for p in prompts]
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    engine.run(reqs)
    torch.cuda.synchronize()
    pre = [s for s in tel.tracer.spans if s.name == "prefill"][-1]
    dec = [s for s in tel.tracer.spans if s.name == "decode"][-1]
    out = {"prefill_s": pre.duration, "decode_steps": dec.attrs["steps"],
           "decode_tok_s": dec.attrs["tokens"] / dec.duration, "peak_bytes": torch.cuda.max_memory_allocated(),
           "n_params": n_params, "n_bytes": n_bytes, "launches": launch_counts()}
    print(f"rwkv: uniform 4 x 2048, 32 new tokens: prefill {pre.duration:.4f}s, decode {dec.attrs['steps']} steps "
          f"{dec.duration:.4f}s = {out['decode_tok_s']:.2f} tok/s; max_memory_allocated {out['peak_bytes']} bytes; "
          f"launches {json.dumps(out['launches'])} {card}", flush=True)
    for r in reqs:
        _require(r.out.shape == (32,) and 0 <= r.out.min() and r.out.max() < cfg.vocab_size, "rwkv: bad tokens")

    # distinct lengths, one row a bucket: a bucket's bf16 GEMMs take their
    # kernel by row count, so two rows sharing a bucket round otherwise than
    # each alone (the repeated-length restore is held exactly in fp32, 10b)
    lens = (1024, 768, 512, 256)
    ragged = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    t0 = time.perf_counter()
    batched = [r.out for r in engine.run([Request(p, max_new_tokens=8) for p in ragged])]
    out["ragged_s"] = time.perf_counter() - t0
    for i, p in enumerate(ragged):
        solo = engine.run([Request(p, max_new_tokens=8)])[0].out
        _require(np.array_equal(batched[i], solo), f"rwkv: ragged row {i} (length {lens[i]}) differs from solo")
    print(f"rwkv: ragged batch {lens} through the exact-length buckets in {out['ragged_s']:.4f}s, token-identical "
          f"to each request served alone {card}", flush=True)

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
    _report_profile(prof, plain_wall, wall, f"rwkv profile: prefill + 4 decode steps {card}")

    layer = tree_map(lambda t: t[0], engine.params["blocks"][0]["mixer"])  # layer 0's views
    x = torch.randn((4, 2048, cfg.d_model), generator=torch.Generator("cuda").manual_seed(3),
                    device="cuda").to(cfg.param_dtype)
    state = rwkv.rwkv_init_state(cfg, 4, device="cuda")
    with torch.inference_mode():
        out["mixer_prefill_ms"] = _device_ms(lambda: rwkv.rwkv_mixer(layer, cfg, x, return_state=True),
                                             iters=3, warmup=1)[0]
        out["mixer_decode_ms"] = _device_ms(lambda: rwkv.rwkv_decode_step(layer, cfg, x[:, :1], state),
                                            iters=50, warmup=5)[0]
    print(f"rwkv: one RWKV mixer layer (plain PyTorch) at 4 x 2048 with its state {out['mixer_prefill_ms']:.4f} ms, "
          f"its decode step at B 4 {out['mixer_decode_ms']:.4f} ms (device time, back to back) {card}", flush=True)
    del engine, layer, x, state
    torch.cuda.empty_cache()
    return out


def _recurrent_smoke(smi: str) -> dict:
    """Phase 10b: the jamba and rwkv6 smoke configs served with the same
    parameters on the card and on the CPU (prefill logits 1e-4, identical
    greedy tokens, a uniform batch and a ragged one).  Jamba runs with
    ``use_flash=True``, its launch counts zeroed just before and read just
    after each card batch: one fp32 flash launch per attention layer and
    prefill bucket, one ``topk_gating`` per MoE layer and bucket or decode
    step."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention, launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.models.transformer import block_spec, prefill
    from repro_torch.serving import Request, ServeEngine

    card = f"[{smi}]"
    rng = np.random.default_rng(0)
    new = 16
    out = {}
    for arch in (JAMBA_ARCH, RWKV_ARCH):
        cfg = dataclasses.replace(get_smoke_config(arch), use_flash=arch == JAMBA_ARCH)
        specs, n_blocks = block_spec(cfg)
        attn_layers = n_blocks * sum(s.kind == "attn" for s in specs)
        moe_layers = n_blocks * sum(s.is_moe for s in specs)
        params = init_params(torch.Generator().manual_seed(0), cfg)
        uniform = list(rng.integers(0, cfg.vocab_size, (JAMBA_SMOKE_B, JAMBA_SMOKE_S)).astype(np.int32))
        ragged = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in JAMBA_RAGGED]
        logits, outs, counts = {}, {}, {}
        for d in ("cuda", "cpu"):
            p = _tree_to(params, d)
            with torch.inference_mode():
                logits[d] = prefill(p, cfg, torch.as_tensor(np.stack(uniform), device=d), max_seq=128)[0].cpu()
            eng = ServeEngine(cfg, params=p, max_seq=128, device=d)
            for label, batch in (("uniform", uniform), ("ragged", ragged)):
                if d == "cuda":
                    torch.cuda.synchronize()
                    reset_launch_counts()
                outs[d, label] = [r.out for r in eng.run([Request(x, max_new_tokens=new) for x in batch])]
                if d == "cuda":
                    torch.cuda.synchronize()
                    counts[label] = {**launch_counts(), "simt": flash_attention.launches_by_variant["simt"]}
        diff = float((logits["cuda"] - logits["cpu"]).abs().max())
        same = all(np.array_equal(a, b) for key in outs if key[0] == "cuda"
                   for a, b in zip(outs[key], outs["cpu", key[1]]))
        print(f"recurrent card-vs-cpu serve {cfg.name} use_flash={cfg.use_flash}: prefill logits max |diff| "
              f"{diff:.3g}, greedy tokens identical {same} (uniform {JAMBA_SMOKE_B} x {JAMBA_SMOKE_S}, ragged "
              f"{JAMBA_RAGGED}); card launches {json.dumps(counts)} {card}", flush=True)
        _require(diff <= 1e-4, f"{cfg.name}: card and CPU prefill logits disagree by {diff}")
        _require(same, f"{cfg.name}: card and CPU greedy tokens disagree")
        for label, buckets in (("uniform", 1), ("ragged", len(set(JAMBA_RAGGED)))):
            want_flash, want_topk = attn_layers * buckets, moe_layers * (buckets + new - 1)
            got = counts[label]
            _require(got["flash_attention"] == got["simt"] == want_flash and got["topk_gating"] == want_topk,
                     f"{cfg.name} {label}: launches {got}, expected {want_flash} simt flash and {want_topk} topk_gating")
        out[arch] = counts
    return out


def _jamba_mixer(smi: str) -> dict:
    """Phase 10c: one Mamba mixer at jamba-1.5-large-398b's widths (d_model
    8192, d_inner 16,384, d_state 16, d_conv 4, bf16, random weights from
    seed 0): a 1 x 2048 chunked prefill's output and handed-off state
    against stepping ``mamba_decode_step`` over the same tokens from the
    zero state (outputs and the convolution's tail 2e-2, the scan state
    ``h`` 1e-3 relative to its largest entry), each timed."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import mamba

    card = f"[{smi}]"
    cfg = get_config(JAMBA_ARCH)
    _require(cfg.param_dtype == torch.bfloat16, f"{cfg.name} is not bf16")
    p = mamba.mamba_init(torch.Generator("cuda").manual_seed(0), cfg)
    u = (torch.randn((1, 2048, cfg.d_model), generator=torch.Generator("cuda").manual_seed(1), device="cuda")
         * 0.5).to(cfg.param_dtype)

    def stepped():
        state, ys = mamba.mamba_init_state(cfg, 1, device="cuda"), []
        for t in range(u.shape[1]):
            y, state = mamba.mamba_decode_step(p, cfg, u[:, t : t + 1], state)
            ys.append(y)
        return torch.cat(ys, dim=1), state

    with torch.inference_mode():
        y_chunk, s_chunk = mamba.mamba_mixer(p, cfg, u, return_state=True)
        y_step, s_step = stepped()
        torch.cuda.synchronize()
        out_gap = float((y_chunk.float() - y_step.float()).abs().max())
        h_gap = float((s_chunk["h"] - s_step["h"]).abs().max() / s_step["h"].abs().max())
        conv_gap = float((s_chunk["conv"] - s_step["conv"]).abs().max())
        prefill_ms = _device_ms(lambda: mamba.mamba_mixer(p, cfg, u, return_state=True), iters=5, warmup=1)[0]
        t0 = time.perf_counter()
        stepped()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        one = u[:, :1]
        state = mamba.mamba_init_state(cfg, 1, device="cuda")
        step_ms = _device_ms(lambda: mamba.mamba_decode_step(p, cfg, one, state), iters=50, warmup=5)[0]
    out = {"out_gap": out_gap, "h_rel_gap": h_gap, "conv_gap": conv_gap, "prefill_ms": prefill_ms,
           "decode_step_ms": step_ms, "stepped_2048_s": step_s}
    print(f"jamba mixer: d_model {cfg.d_model} d_inner {cfg.ssm.expand * cfg.d_model} d_state {cfg.ssm.d_state} "
          f"bf16, 1 x 2048: chunked vs stepped output max |diff| {out_gap:.3g}, state h max rel diff {h_gap:.3g}, "
          f"conv tail max |diff| {conv_gap:.3g}; chunked prefill {prefill_ms:.4f} ms (device), one decode step "
          f"{step_ms:.4f} ms (device), 2048 steps {step_s:.4f}s (host clock) {card}", flush=True)
    _require(out_gap <= 2e-2, f"jamba mixer: chunked and stepped outputs differ by {out_gap}")
    _require(h_gap <= 1e-3 and conv_gap <= 2e-2, f"jamba mixer: states differ (h {h_gap}, conv {conv_gap})")
    del p, u
    torch.cuda.empty_cache()
    return out


def _recurrent_population(name: str, rate: float, smi: str) -> dict:
    """Phase 10d, one program: ``build_scenario("lm", model=name)`` at
    ``scale=1.0`` under EARA-SCA, 3 device-pipeline rounds (launch counts
    zeroed just before and read just after: 1 segment and 1
    ``hier_aggregate`` a round; seconds a round), and the first
    ``CPU_ROUNDS[name]`` of them against the same on the CPU (next-token
    accuracy 1e-3 every round, parameters 5e-3, equal accounting); both
    FedAvg kernels at its shapes."""
    import torch

    from repro_torch.federated import build_scenario
    from repro_torch.kernels import launch_counts, reset_launch_counts

    card = f"[{smi}]"
    t0 = time.perf_counter()
    sc = build_scenario("lm", model=name, scale=1.0)
    lam = sc.assign("eara-sca").lam
    print(f"{name}: build_scenario lm model={name} scale=1.0 and eara-sca {time.perf_counter() - t0:.3f}s: "
          f"{len(sc.clients)} EUs, {sc.n_edges} edges, {sum(c.data_size for c in sc.clients)} sequences, "
          f"{int(sc.model_bits) // 32} parameters {card}", flush=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    gpu = sc.simulate(lam, cloud_rounds=3, engine="sync", pipeline="device")
    torch.cuda.synchronize()
    counts = launch_counts()
    _require(counts["hier_segment_aggregate"] == 3 and counts["hier_aggregate"] == 3
             and counts["flash_attention"] == 0 and counts["topk_gating"] == 0,
             f"{name} population: device launches {counts}, expected 1 segment and 1 aggregate a round")
    rounds = CPU_ROUNDS[name]
    held = gpu if rounds == 3 else sc.simulate(lam, cloud_rounds=rounds, engine="sync", pipeline="device")
    t0 = time.perf_counter()
    cpu = sc.simulate(lam, cloud_rounds=rounds, engine="sync", pipeline="device", device="cpu")
    cpu_s = time.perf_counter() - t0
    acc_gap = max(abs(a.test_acc - b.test_acc) for a, b in zip(held.history, cpu.history))
    param_gap = float((_flat_row(held.final_params).cpu() - _flat_row(cpu.final_params)).abs().max())
    out = {"seconds_per_round": [h.wall_seconds for h in gpu.history], "launches": counts, "cpu_rounds": rounds,
           "acc_gap": acc_gap, "param_gap": param_gap, "cpu_s": cpu_s,
           "kernels": _lm_kernels(sc, lam, rate, smi, label=f"the {name} population's shape")}
    print(f"{name}: device pipeline seconds a round {[round(h.wall_seconds, 4) for h in gpu.history]}, next-token "
          f"accuracy {[round(h.test_acc, 6) for h in gpu.history]}, loss "
          f"{[round(h.mean_local_loss, 6) for h in gpu.history]}, launches {json.dumps(counts)}; the CPU's {rounds} "
          f"rounds {cpu_s:.2f}s; card vs CPU after {rounds}: accuracy {acc_gap:.3g}, parameters {param_gap:.3g} {card}",
          flush=True)
    _require(acc_gap <= 1e-3, f"{name} population: card and CPU accuracy differ by {acc_gap}")
    _require(param_gap <= 5e-3, f"{name} population: card and CPU parameters differ by {param_gap}")
    _require(held.accountant.totals() == cpu.accountant.totals(), f"{name} population: card and CPU accounting differ")
    return out


def _recurrent_mix(rate: float, smi: str) -> dict:
    """Phase 10d, the mix: ``model_mix={"lm": 6, "mamba": 3, "rwkv": 3}``
    with the distillation fuse for 1 round on the device pipeline (one
    segment and one ``hier_aggregate`` launch per group) held to the host
    pipeline (accuracy within 2 test samples, parameters within 5e-3, equal
    accounting); both FedAvg kernels at each group's shapes."""
    from repro_torch.federated import build_scenario

    card = f"[{smi}]"
    mix = build_scenario("lm", model_mix=REC_MIX)
    lam = mix.assign("eara-sca").lam
    dev, counts = _run_counted(mix, lam, f"recurrent mix sync-device {card}", cloud_rounds=1, engine="sync",
                               pipeline="device")
    groups = len(REC_MIX)
    _require(counts["hier_segment_aggregate"] == groups and counts["hier_aggregate"] == groups,
             f"recurrent mix: device launches {counts}, expected {groups} segment and {groups} aggregate a round")
    _require(set(dev.final_params) == set(REC_MIX), f"recurrent mix: final_params keyed {sorted(dev.final_params)}")
    host, _ = _run_counted(mix, lam, f"recurrent mix sync-host {card}", cloud_rounds=1, engine="sync", pipeline="host")
    _agree(f"recurrent mix device vs host {card}", dev, host, acc_tol=2 / len(mix.test))
    out = {"launches": counts, "seconds": dev.history[0].wall_seconds, "host_seconds": host.history[0].wall_seconds,
           "kernels": {name: _lm_kernels(mix, lam, rate, smi, label=f"the recurrent mix's {name} group", group=g)
                       for g, name in enumerate(REC_MIX)}}
    print(f"recurrent: mix {mix.name} device round {out['seconds']:.4f}s, host round {out['host_seconds']:.4f}s "
          f"{card}", flush=True)
    return out


def _recurrent_phase(rate: float, smi: str) -> dict:
    """Phase 10, Mamba and RWKV: 10a-10d, each printed with the card's name
    and power limit, and the phase's seconds."""
    t_phase = time.perf_counter()
    out = {"serve": _rwkv_serve(smi), "smoke": _recurrent_smoke(smi), "mixer": _jamba_mixer(smi)}
    out["population"] = {name: _recurrent_population(name, rate, smi) for name in ("mamba", "rwkv")}
    out["mix"] = _recurrent_mix(rate, smi)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"recurrent: phase 10 {out['phase_s']:.1f}s [{smi}]", flush=True)
    return out


# phase 11: encdec serving (whisper-tiny) and LM training at full width
WHISPER_ARCH = "whisper-tiny"
WHISPER_PARAMS, WHISPER_BYTES = 36_448_128, 72_896_256
# the decoder prefill of phase 11a: 4 prompts of 384 tokens (+ 64 new = max_seq 448)
WHISPER_B, WHISPER_S, WHISPER_NEW = 4, 384, 64
TRAIN_ARCH = "phi3-mini-3.8b"
TRAIN_PARAMS = 3_821_079_552
TRAIN_SEQ, TRAIN_STEPS = 1024, 3
# card against CPU (phase 11d): smoke configs in fp32, 3 steps, grad_accum 2, remat
TRAIN_SMOKE_ARCHS = ("qwen3-14b", "granite-moe-3b-a800m", "whisper-tiny")
# Adam's first steps move a parameter by ~lr * g / |g|, so a 1e-7 gradient
# difference on a near-zero gradient becomes ~1e-4 (the CPU suite holds the
# port to the JAX package at 1e-4 after 2 steps for the same reason)
TRAIN_CARD_TOL = 5e-4


def _frames(cfg, b: int, seed: int = 2, device="cuda"):
    """Frame embeddings (b, n_audio_frames, d_model) in the param dtype,
    drawn as ``launch/serve.py`` draws them."""
    import torch

    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn((b, cfg.n_audio_frames, cfg.d_model), generator=gen, device=device).to(cfg.param_dtype)


def _whisper_serve(smi: str) -> dict:
    """Phase 11a: whisper-tiny at published widths through ``ServeEngine``
    (bf16, random weights from seed 0, ``use_flash=True``): its parameter
    count and bytes; a uniform batch of 4 x 384 tokens with 64 new each
    (launch counts zeroed just before and read just after: one ``wgmma``
    flash launch per decoder layer of the prefill, none in the encoder or
    the decode); prefill seconds, decode tokens/s, peak memory, the serve
    spans' analytic FLOPs; ``use_flash=False`` on the same parameters
    (prefill-logit difference, token agreement); a ragged batch through the
    pad-mask path (no flash launch; each row's agreement with its request
    alone); one prefill and 4 decode steps under ``torch.profiler``; then
    the same weights in fp32: the uniform batch with ``use_flash`` on (one
    fp32 flash launch per decoder layer) and off gives the same tokens, and
    the ragged batch the same tokens as each request alone."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, launch_counts, reset_launch_counts
    from repro_torch.models.transformer import prefill
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.telemetry import Telemetry

    card = f"[{smi}]"
    cfg = dataclasses.replace(get_config(WHISPER_ARCH), use_flash=True)
    max_seq = WHISPER_S + WHISPER_NEW
    _require(max_seq == cfg.max_seq, f"{cfg.name}: {WHISPER_S} + {WHISPER_NEW} is not its max_seq {cfg.max_seq}")
    t0 = time.perf_counter()
    tel = Telemetry()
    engine = ServeEngine(cfg, max_seq=max_seq, seed=0, device="cuda", telemetry=tel)
    torch.cuda.synchronize()
    leaves = _leaves(engine.params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"whisper: {cfg.name} {cfg.n_encoder_layers}+{cfg.n_layers} layers d_model {cfg.d_model} heads "
          f"{cfg.n_heads} x {cfg.d_head} vocab {cfg.vocab_size} frames {cfg.n_audio_frames} {cfg.dtype}: {n_params} "
          f"parameters, {n_bytes} bytes, drawn in {time.perf_counter() - t0:.3f}s {card}", flush=True)
    _require(n_params == WHISPER_PARAMS and n_bytes == WHISPER_BYTES,
             f"{cfg.name}: {n_params} parameters / {n_bytes} bytes, not {WHISPER_PARAMS} / {WHISPER_BYTES}")
    rng = np.random.default_rng(0)
    frames = _frames(cfg, WHISPER_B)
    prompts = rng.integers(0, cfg.vocab_size, (WHISPER_B, WHISPER_S)).astype(np.int32)
    _warm_serve_cost(engine, prompts, enc_embeds=frames)

    def spans():
        return tuple([s for s in tel.tracer.spans if s.name == name][-1] for name in ("prefill", "decode"))

    reqs = [Request(p, max_new_tokens=WHISPER_NEW) for p in prompts]
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    engine.run(reqs, enc_embeds=frames)
    torch.cuda.synchronize()
    counts, variants = launch_counts(), dict(flash_attention.launches_by_variant)
    pre, dec = spans()
    out = {"n_params": n_params, "n_bytes": n_bytes, "prefill_s": pre.duration,
           "decode_tok_s": dec.attrs["tokens"] / dec.duration, "peak_bytes": torch.cuda.max_memory_allocated(),
           "flash_wgmma": variants["wgmma"], "prefill_flops": pre.attrs.get("flops"),
           "decode_step_flops": dec.attrs.get("flops")}
    print(f"whisper: uniform {WHISPER_B} x {WHISPER_S}, {WHISPER_NEW} new tokens: prefill {pre.duration:.4f}s, decode "
          f"{dec.attrs['steps']} steps {dec.duration:.4f}s = {out['decode_tok_s']:.2f} tok/s; max_memory_allocated "
          f"{out['peak_bytes']} bytes; launches {json.dumps(counts)} flash by variant {json.dumps(variants)} {card}",
          flush=True)
    print(f"whisper: analytic cost (jit_cost on meta copies): prefill {pre.attrs.get('flops')} flops "
          f"{pre.attrs.get('bytes_moved')} bytes, decode step {dec.attrs.get('flops')} flops "
          f"{dec.attrs.get('bytes_moved')} bytes {card}", flush=True)
    _require(counts["flash_attention"] == cfg.n_layers and variants["wgmma"] == cfg.n_layers,
             f"whisper serve: flash launches {counts} {variants}, not one wgmma per decoder layer ({cfg.n_layers})")
    _require(counts["topk_gating"] == 0, "whisper serve launched topk_gating")
    _require(bool(out["prefill_flops"]) and bool(out["decode_step_flops"]), "whisper: the serve spans carry no flops")
    for r in reqs:
        _require(r.out.shape == (WHISPER_NEW,) and 0 <= r.out.min() and r.out.max() < cfg.vocab_size,
                 "whisper: bad tokens")

    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    toks = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        lf = prefill(engine.params, cfg, toks, max_seq=max_seq, enc_embeds=frames)[0]
        lp = prefill(engine.params, plain_cfg, toks, max_seq=max_seq, enc_embeds=frames)[0]
    _require(bool(torch.isfinite(lf).all() and torch.isfinite(lp).all()), "whisper: non-finite prefill logits")
    out["flash_vs_plain_logits"] = float((lf - lp).abs().max())
    argmax_same = int((lf.argmax(-1) == lp.argmax(-1)).sum())
    del lf, lp
    plain = ServeEngine(plain_cfg, params=engine.params, max_seq=max_seq, device="cuda")
    plain_out = [r.out for r in plain.run([Request(p, max_new_tokens=WHISPER_NEW) for p in prompts],
                                          enc_embeds=frames)]
    out["leading_tokens_equal"] = [int(np.sum(np.cumprod(a == b))) for a, b in zip((r.out for r in reqs), plain_out)]
    print(f"whisper: bf16 use_flash on vs off, same params: prefill logits max |diff| "
          f"{out['flash_vs_plain_logits']:.4g}, first tokens equal {argmax_same}/{WHISPER_B}, leading tokens equal per "
          f"row {out['leading_tokens_equal']} of {WHISPER_NEW} {card}", flush=True)

    lens = [WHISPER_S, 300, 217, 100]
    ragged = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    reset_launch_counts()
    batched = [r.out for r in engine.run([Request(p, max_new_tokens=WHISPER_NEW) for p in ragged], enc_embeds=frames)]
    torch.cuda.synchronize()
    pre, dec = spans()
    ragged_flash = launch_counts()["flash_attention"]
    # bf16: a row alone runs other GEMM shapes than in the batch, so its
    # tokens may part from the batch's at a near-tie; exactness is held in fp32 below
    solo = [engine.run([Request(p, max_new_tokens=WHISPER_NEW)], enc_embeds=frames[i:i + 1])[0].out
            for i, p in enumerate(ragged)]
    out["ragged_solo_leading_equal"] = [int(np.sum(np.cumprod(a == b))) for a, b in zip(batched, solo)]
    print(f"whisper: ragged {lens}, {WHISPER_NEW} new tokens: prefill {pre.duration:.4f}s, decode "
          f"{dec.attrs['tokens'] / dec.duration:.2f} tok/s; flash launches {ragged_flash}; bf16 leading tokens equal "
          f"to each request served alone {out['ragged_solo_leading_equal']} of {WHISPER_NEW} {card}", flush=True)
    _require(ragged_flash == 0, "the pad-mask prefill launched the flash kernel")

    short = [Request(p, max_new_tokens=5) for p in prompts]
    engine.run(short, enc_embeds=frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(short, enc_embeds=frames)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(short, enc_embeds=frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report_profile(prof, plain_wall, wall, f"whisper profile: prefill + 4 decode steps {card}")

    # the same weights in fp32 (146 MB): the fp32 flash kernel, flash on = off
    # and ragged = solo token for token (launch counts zeroed just before and
    # read just after the uniform batch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _tree_to(engine.params, torch.float32)
    frames32 = frames.float()
    flash32 = ServeEngine(cfg32, params=params32, max_seq=max_seq, device="cuda")
    plain32 = ServeEngine(dataclasses.replace(cfg32, use_flash=False), params=params32, max_seq=max_seq,
                          device="cuda")

    def serve(eng, prompts, emb):
        return [r.out for r in eng.run([Request(p, max_new_tokens=WHISPER_NEW) for p in prompts], enc_embeds=emb)]

    reset_launch_counts()
    a = serve(flash32, list(prompts), frames32)
    variants32 = dict(flash_attention.launches_by_variant)
    _require(variants32["simt"] == cfg.n_layers, f"whisper fp32 uniform prefill: flash launches {variants32}")
    _require(all(np.array_equal(x, y) for x, y in zip(a, serve(plain32, list(prompts), frames32))),
             "whisper fp32: use_flash on and off give different tokens")
    batched32 = serve(flash32, ragged, frames32)
    for i, p in enumerate(ragged):
        _require(np.array_equal(batched32[i], serve(flash32, [p], frames32[i:i + 1])[0]),
                 f"whisper fp32 ragged row {i} (len {lens[i]}) differs from solo")
    print(f"whisper exact: fp32, uniform {WHISPER_B} x {WHISPER_S}: use_flash on/off tokens identical, flash by "
          f"variant {json.dumps(variants32)}; ragged {lens} token-identical to each request served alone {card}",
          flush=True)
    del engine, plain, frames, toks, flash32, plain32, params32, frames32
    torch.cuda.empty_cache()
    return out


def _whisper_card_vs_cpu(smi: str) -> None:
    """Phase 11b: whisper-tiny's smoke config (fp32) with the same
    parameters and frame embeddings on the card and on the CPU: prefill
    logits 1e-4, identical greedy tokens, uniform and ragged."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import prefill
    from repro_torch.serving import Request, ServeEngine

    cfg = get_smoke_config(WHISPER_ARCH)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    frames = _frames(cfg, 3, device="cpu")
    rng = np.random.default_rng(0)
    uniform = list(rng.integers(0, cfg.vocab_size, (3, 40)).astype(np.int32))
    ragged = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (40, 23, 31)]
    logits, outs = {}, {}
    for d in ("cuda", "cpu"):
        p, f = _tree_to(params, d), frames.to(d)
        with torch.inference_mode():
            logits[d] = prefill(p, cfg, torch.as_tensor(np.stack(uniform), device=d), max_seq=cfg.max_seq,
                                enc_embeds=f)[0].cpu()
        eng = ServeEngine(cfg, params=p, max_seq=cfg.max_seq, device=d)
        outs[d] = [r.out for batch in (uniform, ragged)
                   for r in eng.run([Request(x, max_new_tokens=16) for x in batch], enc_embeds=f)]
    diff = float((logits["cuda"] - logits["cpu"]).abs().max())
    same = all(np.array_equal(a, b) for a, b in zip(outs["cuda"], outs["cpu"]))
    print(f"card-vs-cpu serve {cfg.name}: prefill logits max |diff| {diff:.3g}, greedy tokens identical (uniform and "
          f"ragged) {same} [{smi}]", flush=True)
    _require(diff <= 1e-4, "whisper smoke: card and CPU prefill logits disagree")
    _require(same, "whisper smoke: card and CPU greedy tokens disagree")


def _train_full(rate: float, smi: str) -> dict:
    """Phase 11c: phi3-mini-3.8b at published widths (bf16, random weights
    from seed 0) trained by ``make_train_step`` with ``adam(1e-3)`` (its
    in-place update; fp32 moments) on ``TokenStream`` batches of 1 x 1024
    tokens for 3 steps: each step's seconds, loss and gradient norm (the
    first loss within 0.5 of ln(vocab) + d_model * 0.02^2 / 2, the
    cross entropy of the random init, every loss finite),
    peak memory, one ``adam_update`` launch a leaf a step and no other
    kernel launch (launch counts zeroed just before and read just after);
    then one more step under ``torch.profiler`` (busy share, top kernels)."""
    import gc
    import math

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.device import upload
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.training import adam, init_train_state, make_train_step

    card = f"[{smi}]"
    cfg = get_config(TRAIN_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(torch.Generator("cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    leaves = _leaves(params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"train: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} heads {cfg.n_heads} x {cfg.d_head} d_ff "
          f"{cfg.d_ff} vocab {cfg.vocab_size} {cfg.dtype}: {n_params} parameters, {n_bytes} bytes, drawn in "
          f"{time.perf_counter() - t0:.3f}s (memory allocated before: {base} bytes) {card}", flush=True)
    _require(n_params == TRAIN_PARAMS, f"{cfg.name}: {n_params} parameters, not {TRAIN_PARAMS}")
    n_leaves = len(leaves)
    opt = adam(1e-3)
    state = init_train_state(params, opt)
    del params, leaves
    step = make_train_step(cfg, opt)
    stream = TokenStream(cfg.vocab_size, seed=0)
    out = {"n_params": n_params, "n_bytes": n_bytes, "leaves": n_leaves, "step_s": [], "loss": [], "grad_norm": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for i in range(TRAIN_STEPS):
        batch = {k: upload(v.astype(np.int64), torch.device("cuda"))
                 for k, v in stream.train_batch(1, TRAIN_SEQ).items()}
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["total_loss"])  # waits for the step
        out["step_s"].append(time.perf_counter() - t0)
        out["loss"].append(loss)
        out["grad_norm"].append(float(m["grad_norm"]))
        print(f"train: step {i + 1}: {out['step_s'][-1]:.4f}s loss {loss:.4f} grad_norm {out['grad_norm'][-1]:.4g} "
              f"{card}", flush=True)
    counts = launch_counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["launches"] = counts
    out["checksum"] = _bits_checksum(state.params)  # phase 13a's sharded step is held to these bits
    batch = {k: upload(v.astype(np.int64), torch.device("cuda")) for k, v in stream.train_batch(1, TRAIN_SEQ).items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["total_loss"])
        wall = time.perf_counter() - t0
    _report_profile(prof, out["step_s"][-1], wall, f"train profile: one more step {card}")
    # at random init a logit is a sum of d_model products of the unit-RMS
    # final hidden state with N(0, 0.02^2) head weights (both packages'
    # embedding_init), so the cross entropy starts near ln(V) + d_model *
    # 0.02^2 / 2 (10.99 at phi3-mini's widths; the JAX package gives 11.006
    # for them at one layer), not at ln(V) (10.38)
    init_loss = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    print(f"train: 1 x {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps: max_memory_allocated {out['peak_bytes']} bytes "
          f"({out['peak_bytes'] / 1e9:.2f} GB); launches {json.dumps(counts)}; ln(vocab) "
          f"{math.log(cfg.vocab_size):.4f}, random-init expectation {init_loss:.4f} {card}", flush=True)
    _require(all(math.isfinite(x) for x in out["loss"] + out["grad_norm"]), "train: a non-finite loss or norm")
    _require(abs(out["loss"][0] - init_loss) < 0.5,
             f"train: first loss {out['loss'][0]} not within 0.5 of {init_loss:.4f}, the random-init expectation")
    _require(counts["adam_update"] == TRAIN_STEPS * n_leaves
             and not any(v for k, v in counts.items() if k != "adam_update"),
             f"train: kernel launches {counts} (the training path launches adam_update once a leaf a step)")
    _require(out["peak_bytes"] < 80e9, "train: peak memory over 80 GB")
    del state, step, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_card_vs_cpu(smi: str) -> dict:
    """Phase 11d: ``make_train_step`` with ``adam(1e-3)``, ``grad_accum=2``
    and ``remat=True`` on the qwen3-14b, granite-moe-3b-a800m and
    whisper-tiny smoke configs (fp32), 3 steps from the same parameters and
    batches on the card and on the CPU (parameters ``TRAIN_CARD_TOL``,
    losses 1e-5); then a checkpoint round trip on the card, fp32 and bf16,
    bit-exact; then the kernels' no-gradient guard on CUDA tensors."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention, topk_gating
    from repro_torch.models import init_params
    from repro_torch.training import adam, init_train_state, load_checkpoint, make_train_step, save_checkpoint
    from repro_torch.utils.tree import tree_leaves

    card = f"[{smi}]"
    out = {}
    for arch in TRAIN_SMOKE_ARCHS:
        cfg = get_smoke_config(arch)
        params = init_params(torch.Generator().manual_seed(0), cfg)
        rng = np.random.default_rng(0)
        batches = []
        for _ in range(3):
            t = rng.integers(0, cfg.vocab_size, (4, 33))
            b = {"tokens": torch.as_tensor(t[:, :-1]), "labels": torch.as_tensor(t[:, 1:])}
            if cfg.family == "encdec":
                b["enc_embeds"] = torch.as_tensor(rng.standard_normal((4, cfg.n_audio_frames, cfg.d_model)),
                                                  dtype=torch.float32)
            batches.append(b)
        final, losses = {}, {}
        for d in ("cuda", "cpu"):
            opt = adam(1e-3)
            state = init_train_state(_tree_to(params, d), opt)
            step = make_train_step(cfg, opt, grad_accum=2, remat=True)
            losses[d] = []
            for b in batches:
                state, m = step(state, {k: v.to(d) for k, v in b.items()})
                losses[d].append(float(m["total_loss"]))
            final[d] = state.params
        perr = max(float((a.cpu() - b).abs().max()) for a, b in zip(_leaves(final["cuda"]), _leaves(final["cpu"])))
        lerr = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
        out[arch] = {"param_err": perr, "loss_err": lerr}
        print(f"card-vs-cpu train {cfg.name}: 3 steps grad_accum 2 remat: parameters max |diff| {perr:.3g}, losses "
              f"max |diff| {lerr:.3g} {card}", flush=True)
        _require(perr <= TRAIN_CARD_TOL and lerr <= 1e-5, f"train {cfg.name}: card and CPU disagree")
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in (torch.float32, torch.bfloat16):
            cfg = dataclasses.replace(get_smoke_config(WHISPER_ARCH), dtype=str(dtype).split(".")[1])
            tree = init_params(torch.Generator("cuda").manual_seed(3), cfg)
            path = f"{tmp}/ck_{cfg.dtype}.npz"
            save_checkpoint(path, tree, step=3)
            back = load_checkpoint(path, init_params(torch.Generator("cuda").manual_seed(4), cfg))
            same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
                       for a, b in zip(tree_leaves(tree), tree_leaves(back), strict=True))
            print(f"checkpoint: {cfg.name} {cfg.dtype} on the card: round trip bit-exact {same} {card}", flush=True)
            _require(same, f"checkpoint round trip ({cfg.dtype}) is not bit-exact")
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 128, 2, 64), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    logits = torch.randn((4, 40), generator=gen, device="cuda")
    for name, call in (("flash_attention", lambda: flash_attention(q.requires_grad_(True), k, v)),
                       ("topk_gating", lambda: topk_gating(logits.requires_grad_(True), 8))):
        try:
            call()
        except RuntimeError as e:
            _require("no gradient" in str(e), f"{name}: unexpected error {e}")
            print(f"guard: {name} on CUDA inputs that require grad raises: {e} {card}", flush=True)
        else:
            raise AssertionError(f"{name} returned an output under autograd on the card")
    return out


def _launchers(smi: str) -> dict:
    """Phase 11f: the serve launcher on whisper-tiny at published widths and
    the train launcher on phi3-mini-3.8b at published widths (3 steps of 1 x
    1024), each in its own process (the kernel library is built already)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    out = {}
    for label, args in (
        ("serve", ["-m", "repro_torch.launch.serve", "--arch", WHISPER_ARCH, "--full-config"]),
        ("train", ["-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--full-config", "--steps",
                   str(TRAIN_STEPS), "--batch", "1", "--seq", str(TRAIN_SEQ)]),
    ):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env, timeout=300)
        out[label] = time.perf_counter() - t0
        for line in proc.stdout.strip().splitlines():
            print(f"launcher {label}: {line} [{smi}]", flush=True)
        _require(proc.returncode == 0, f"launcher {label} failed ({proc.returncode}): {proc.stderr[-2000:]}")
        print(f"launcher {label}: {out[label]:.1f}s", flush=True)
    return out


def _encdec_train_phase(rate: float, smi: str) -> dict:
    """Phase 11: every number printed with the card's name and power limit,
    and the phase's seconds."""
    t_phase = time.perf_counter()
    out = {"serve": _whisper_serve(smi)}
    _whisper_card_vs_cpu(smi)
    out["train"] = _train_full(rate, smi)
    out["card_vs_cpu"] = _train_card_vs_cpu(smi)
    out["launchers"] = _launchers(smi)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"encdec+train: phase 11 {out['phase_s']:.1f}s [{smi}]", flush=True)
    return out



def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _build_report(log: str, so, agg_n: int, agg_d: int) -> dict:
    """Each kernel's registers and spills from ``-Xptxas=-v`` (every kernel
    must show 0 spills), the fp32 flash kernel's tile (must equal
    ``SIMT_TILE``), ``hier_aggregate``'s layout for (``agg_n``,
    ``agg_d``), as its library launches it (returned), and the
    tensor-core (``HGMMA``) and TMA (``UTMALDG``, ``UTMASTG``) instructions
    in the ``wgmma`` flash kernel's SASS: both must be there."""
    from repro_torch.kernels.build import load_library, sass_instruction_counts
    from repro_torch.kernels.flash_attention import SIMT_TILE, simt_kernel_tile

    tile = simt_kernel_tile()
    print(f"build: flash_attention_kernel tile {tile} (query rows, key rows)", flush=True)
    _require(tile == SIMT_TILE, f"the fp32 flash kernel's tile {tile} is not SIMT_TILE {SIMT_TILE}")
    lib = load_library()
    threads, blocks, rows = (lib.repro_aggregate_layout(i, agg_n, agg_d) for i in range(3))
    layout = {"N": agg_n, "D": agg_d, "threads": threads, "blocks": blocks,
              "cols_per_thread": -(-agg_d // (threads * blocks)), "rows_in_flight": rows}
    print(f"build: aggregate_kernel layout {json.dumps(layout)}", flush=True)

    arg_names = {"13__nv_bfloat16": "bf16", "f": "f32", "i": "int32", "l": "int64"}
    name, checked = None, set()
    for line in log.splitlines():
        m = re.search(r"(segment_aggregate_kernel|aggregate_kernel|adam_update_kernel|flash_attention_kernel|"
                      r"flash_attention_wgmma_kernel|topk_gating_group_kernel|topk_gating_kernel)I(.+?)E+v", line)
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
    return layout


def _wrappers_only(root: Path) -> int:
    """``--wrappers ROOT``: the launch floor, then the small kernels alone
    (``kernel_ms``: the module's ``_launch`` back to back, as phase 3 times
    it) and their wrappers' whole calls (``_wrapper_work`` and host ms):
    ``hier_segment_aggregate`` at the SCA edge FedAvg shape,
    ``hier_aggregate`` at the cloud reduce's (N 5) and ``topk_gating`` for
    8192 tokens, k 8, at E 40, 128 and 1000, for the port under
    ``ROOT/src``, built there; prints one JSON line.  Alternating two trees
    (a parent commit unpacked under ``build/``, say) in one run compares
    them on one card.  A tree whose aggregate kernel takes normalized
    weights (its module has ``_normalized_weights``) gets them, made once
    outside the timing."""
    import importlib

    import numpy as np
    import torch

    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch.federated.programs import CNNProgram
    from repro_torch.kernels import (
        hier_aggregate,
        hier_aggregate_ref,
        hier_segment_aggregate,
        hier_segment_aggregate_ref,
        topk_gating,
        topk_gating_ref,
    )
    from repro_torch.utils.tree import tree_num_params

    _require(Path(repro_torch.__file__).resolve().is_relative_to(root), f"repro_torch not imported from {root}")
    seg_mod, agg_mod, topk_mod = (importlib.import_module(f"repro_torch.kernels.{m}")
                                  for m in ("segment_aggregate", "hier_aggregate", "topk_gating"))
    d_model = tree_num_params(CNNProgram().init(torch.Generator().manual_seed(0)))
    x, seg, w, e = _sca_inputs(d_model)
    call = lambda: hier_segment_aggregate(x, seg, w, e)  # noqa: E731
    err = _close(call(), hier_segment_aggregate_ref(x, seg, w, e), TOL["float32"])
    record = {"tree": str(root), "card": _smi(), **_launch_floor(), "N": 18, "E": e, "D": d_model,
              "max_abs_err": err, "kernel_ms": _device_ms(lambda: seg_mod._launch(x, seg, w, e))[0],
              **_wrapper_work(call), "wrapper_host_ms": _host_ms(call)}
    rng = np.random.default_rng(0)
    xa = torch.as_tensor(rng.standard_normal((5, d_model)), dtype=torch.float32, device="cuda")
    wa = torch.as_tensor(rng.uniform(0.05, 1.0, 5), dtype=torch.float32, device="cuda")
    call = lambda: hier_aggregate(xa, wa)  # noqa: E731
    err = _close(call(), hier_aggregate_ref(xa, wa), TOL["float32"])
    normalized = hasattr(agg_mod, "_normalized_weights")
    wk = agg_mod._normalized_weights(wa) if normalized else wa
    _close(agg_mod._launch(xa, wk), hier_aggregate_ref(xa, wa), TOL["float32"])
    record["aggregate"] = {"N": 5, "D": d_model, "max_abs_err": err, "kernel_weights": "normalized" if normalized else "raw",
                           "kernel_ms": _device_ms(lambda: agg_mod._launch(xa, wk))[0],
                           **_wrapper_work(call), "wrapper_host_ms": _host_ms(call)}
    record["topk"] = []
    for experts in (40, 128, 1000):  # the granite-moe router width, then wider
        xt = torch.as_tensor(rng.standard_normal((8192, experts)) * 2, dtype=torch.float32, device="cuda")
        call = lambda: topk_gating(xt, 8)  # noqa: E731
        err = _close(call(), topk_gating_ref(xt, 8), 1e-5)
        record["topk"].append({"T": 8192, "E": experts, "k": 8, "max_abs_err": err,
                               "kernel_ms": _device_ms(lambda: topk_mod._launch(xt, 8))[0],
                               **_wrapper_work(call), "wrapper_host_ms": _host_ms(call)})
    print(json.dumps(record), flush=True)
    return 0


# phase 12: the edge mesh
MESH_RANKS = 5  # one heartbeat edge per rank
MESH_SCHEDULE = (1, 2)  # one local epoch an edge round, T 2 edge rounds a cloud round
MESH_ROUNDS = 2
MESH_RANK_TIMEOUT = 300.0
HFL_SMOKE_TOL = 5e-4  # phase 11d's card-vs-CPU parameter tolerance for make_train_step
HFL_LAYERS, HFL_SEQ = 4, 512  # phi3-mini-3.8b's widths, depth cut to 4 layers, 1 x 512 tokens an edge


def _mesh_run(sc, lam, label: str, **kw):
    """One heartbeat run of phase 12 (launch counts zeroed just before and
    read just after) -> (result, launches, peak bytes)."""
    import torch

    from repro_torch.core import HFLSchedule
    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = sc.simulate(lam, MESH_ROUNDS, engine="sync", schedule=HFLSchedule(*MESH_SCHEDULE), **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    for h in res.history:
        print(f"mesh: {label} round {h.cloud_round} acc {h.test_acc:.6f} loss {h.mean_local_loss:.6f} "
              f"seconds {h.wall_seconds:.4f}", flush=True)
    print(f"mesh: {label} launches {json.dumps(counts)}", flush=True)
    return res, counts, torch.cuda.max_memory_allocated()


def _mesh_rank(lam) -> dict:
    """Phase 12b's rank program (run by ``run_ranks`` in its own process on
    the card, in a gloo group of ``MESH_RANKS``): the full heartbeat
    scenario over the edge mesh; host copies of what the parent compares."""
    import torch

    from repro_torch.federated import build_scenario

    sc = build_scenario("heartbeat")
    res, counts, peak = _mesh_run(sc, lam, f"rank {torch.distributed.get_rank()}", pipeline="mesh",
                                  mesh=MESH_RANKS)
    return {"accs": [h.test_acc for h in res.history], "losses": [h.mean_local_loss for h in res.history],
            "seconds": [h.wall_seconds for h in res.history], "params": _flat_row(res.final_params).cpu(),
            "report": res.comm_report, "launches": counts, "peak_bytes": peak, "n_test": len(sc.test)}


def _mesh_engine_phase(sc, lam, smi: str) -> dict:
    """Phases 12a-12b: the heartbeat path over an edge mesh of one rank (in
    this process, a one-rank NCCL group) and of ``MESH_RANKS`` ranks
    (spawned, gloo, all on this card)."""
    import torch

    from repro_torch.distributed import run_ranks

    card = f"[{smi}]"
    out = {}
    # 12a: one rank against the device pipeline, bit for bit
    dev_res, dev_counts, _ = _mesh_run(sc, lam, "12a device pipeline", pipeline="device")
    one, counts, peak = _mesh_run(sc, lam, "12a mesh k 1", pipeline="mesh", mesh=1)
    rep = one.comm_report
    progs = rep["programs"]
    print(f"mesh: 12a comm_report {json.dumps({k: v for k, v in rep.items() if k != 'simulated'})}", flush=True)
    _require([h.test_acc for h in one.history] == [h.test_acc for h in dev_res.history],
             "12a: mesh k 1 accuracies differ from the device pipeline's")
    _require(torch.equal(_flat_row(one.final_params), _flat_row(dev_res.final_params)),
             "12a: mesh k 1 parameters are not the device pipeline's bit for bit")
    _require(counts == dev_counts, f"12a: launches {counts} differ from the device pipeline's {dev_counts}")
    _require(counts["hier_segment_aggregate"] == progs["edge_agg"]["calls"] > 0,
             f"12a: {counts['hier_segment_aggregate']} segment launches, the engine made {progs['edge_agg']['calls']}")
    _require(counts["hier_aggregate"] == progs["cloud_reduce"]["calls"] == MESH_ROUNDS,
             f"12a: {counts['hier_aggregate']} aggregate launches for {progs['cloud_reduce']['calls']} cloud reduces")
    _require(rep["cross_edge_total_bytes"] == 0.0, "12a: cross-edge bytes at one rank")
    out["k1"] = {"launches": counts, "seconds_per_cloud_round": one.history[-1].wall_seconds,
                 "device_seconds_per_cloud_round": dev_res.history[-1].wall_seconds, "peak_bytes": peak}
    print(f"mesh: 12a bit-equal to the device pipeline; round {MESH_ROUNDS} seconds mesh k 1 "
          f"{out['k1']['seconds_per_cloud_round']:.4f} device pipeline "
          f"{out['k1']['device_seconds_per_cloud_round']:.4f}; peak {peak} bytes {card}", flush=True)
    torch.distributed.destroy_process_group()  # the one-rank group 12a created
    # 12b: MESH_RANKS ranks on this card (gloo), one edge each
    t0 = time.perf_counter()
    ranks = run_ranks(_mesh_rank, MESH_RANKS, (lam,), backend="gloo", timeout=MESH_RANK_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    first = ranks[0]
    for r, run in enumerate(ranks):
        _require(run["accs"] == first["accs"] and run["losses"] == first["losses"]
                 and torch.equal(run["params"], first["params"]), f"12b: rank {r} differs from rank 0")
    acc_diff = max(abs(a - b) for a, b in zip(first["accs"], [h.test_acc for h in one.history]))
    param_diff = float((first["params"] - _flat_row(one.final_params).cpu()).abs().max())
    rep5 = first["report"]
    progs5 = rep5["programs"]
    payload = rep5["payload_bytes"]
    print(f"mesh: 12b comm_report {json.dumps({k: v for k, v in rep5.items() if k != 'simulated'})}", flush=True)
    for name in ("edge_starts", "cohort_epoch", "edge_agg"):
        _require(progs5[name]["coll_bytes_per_call"] == 0.0 and progs5[name]["cross_edge_bytes_total"] == 0.0,
                 f"12b: {name} hands bytes to a collective")
    _require(progs5["cloud_reduce"]["calls"] == MESH_ROUNDS, "12b: cloud_reduce not once per cloud round")
    per_cloud, per_edge = rep5["cross_edge_bytes_per_cloud_round"], rep5["cross_edge_bytes_per_edge_round"]
    _require(abs(per_cloud - payload) <= 0.05 * payload, f"12b: {per_cloud} cross-edge bytes a cloud round")
    _require(abs(per_edge - payload / MESH_SCHEDULE[1]) <= 0.05 * payload / MESH_SCHEDULE[1],
             f"12b: {per_edge} cross-edge bytes an edge round")
    _require(acc_diff <= 2.0 / first["n_test"] + 1e-6, f"12b: accuracy {acc_diff} from 12a")
    launches = {k: sum(run["launches"][k] for run in ranks) for k in first["launches"]}
    out["k5"] = {
        "launches": launches, "launches_per_rank": first["launches"],
        "seconds_per_cloud_round": max(run["seconds"][-1] for run in ranks),
        "peak_bytes_per_rank": [run["peak_bytes"] for run in ranks], "param_diff_vs_k1": param_diff,
        "acc_diff_vs_k1": acc_diff, "cross_edge_bytes_per_cloud_round": per_cloud,
        "cross_edge_bytes_per_edge_round": per_edge, "payload_bytes": payload, "spawn_s": spawn_s,
    }
    print(f"mesh: 12b {MESH_RANKS} ranks (gloo, all on this one card: a topology and accounting check, not a "
          f"speedup): identical on every rank; vs 12a accuracy {acc_diff:.3g} parameters {param_diff:.3g}; "
          f"cross-edge bytes {per_cloud:.0f} a cloud round ({per_cloud / payload:.4f} payloads), {per_edge:.0f} an "
          f"edge round; round {MESH_ROUNDS} seconds {out['k5']['seconds_per_cloud_round']:.4f}; peak bytes per rank "
          f"{out['k5']['peak_bytes_per_rank']}; launches {json.dumps(launches)}; {spawn_s:.1f}s with the spawn "
          f"{card}", flush=True)
    _require(param_diff <= 1e-5, f"12b: parameters {param_diff} from 12a")
    return out


def _hfl_phase(smi: str) -> dict:
    """Phase 12c: ``make_hfl_train_step`` (E 2, ``adam(1e-3)``) on the card
    against the CPU at the phi3-mini smoke config (fp32; steps local, local,
    sync: parameters ``HFL_SMOKE_TOL``, losses 1e-5, the replicas equal to
    1e-6 after the sync), then at phi3-mini-3.8b's published widths with the
    depth cut to ``HFL_LAYERS`` layers (bf16, random weights from seed 0),
    1 x ``HFL_SEQ`` tokens an edge: the seconds of a local and of a sync
    step, and peak memory."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed import init_hfl_state, make_hfl_train_step
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.training import adam

    card = f"[{smi}]"
    cfg = get_smoke_config(TRAIN_ARCH)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    t = rng.integers(0, cfg.vocab_size, (2, 4, 17))
    batch = {"tokens": torch.as_tensor(t[..., :-1]), "labels": torch.as_tensor(t[..., 1:])}
    runs = {}
    for dev in ("cpu", "cuda"):
        opt = adam(1e-3)
        state = init_hfl_state(_tree_to(params, dev), opt, 2)
        b = {k: v.to(dev) for k, v in batch.items()}
        reset_launch_counts()
        losses = []
        for sync in (False, False, True):
            state, m = make_hfl_train_step(cfg, opt, sync=sync)(state, b)
            losses.append(float(m["total_loss"]))
        runs[dev] = (state, losses, launch_counts())
    (cpu, cpu_loss, _), (gpu, gpu_loss, counts) = runs["cpu"], runs["cuda"]
    param_diff = max(float((p.cpu() - q).abs().max()) for p, q in zip(_leaves(gpu.params), _leaves(cpu.params)))
    loss_diff = max(abs(a - b) for a, b in zip(gpu_loss, cpu_loss))
    spread = max(float((x[0] - x[1]).abs().max()) for x in _leaves(gpu.params))
    print(f"hfl: {cfg.name} smoke E 2: card vs CPU parameters {param_diff:.3g} losses {loss_diff:.3g}; replicas "
          f"after sync {spread:.3g}; launches on the card {json.dumps(counts)} {card}", flush=True)
    _require(param_diff <= HFL_SMOKE_TOL, f"hfl: parameters {param_diff} card vs CPU")
    _require(loss_diff <= 1e-5, f"hfl: losses {loss_diff} card vs CPU")
    _require(spread <= 1e-6, f"hfl: replicas differ by {spread} after the sync")
    _require(counts["hier_aggregate"] == len(_leaves(gpu.params)), f"hfl: sync launches {counts}")
    from repro_torch.utils.tree import tree_leaves

    out = {"smoke": {"param_diff": param_diff, "loss_diff": loss_diff, "launches": counts,
                     "params": [x.cpu() for x in tree_leaves(gpu.params)], "losses": gpu_loss}}
    # published widths, depth cut
    full = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=HFL_LAYERS)
    del runs, cpu, gpu, params
    gc.collect()
    torch.cuda.empty_cache()
    opt = adam(1e-3)
    state = init_hfl_state(init_params(torch.Generator("cuda").manual_seed(0), full), opt, 2)
    n_params = sum(x.numel() for x in _leaves(state.params)) // 2
    tok = torch.as_tensor(rng.integers(0, full.vocab_size, (2, 1, HFL_SEQ + 1)), device="cuda")
    b = {"tokens": tok[..., :-1], "labels": tok[..., 1:]}
    local, sync = make_hfl_train_step(full, opt, sync=False), make_hfl_train_step(full, opt, sync=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = {}
    for label, step in (("warm-up local", local), ("local", local), ("sync", sync)):
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss = float(m["total_loss"])  # waits for the step
        secs[label] = time.perf_counter() - t0
        _require(np.isfinite(loss), f"hfl: {label} step loss {loss}")
    peak = torch.cuda.max_memory_allocated()
    spread = max(float((x[0].float() - x[1].float()).abs().max()) for x in _leaves(state.params))
    print(f"hfl: {full.name} widths cut to {HFL_LAYERS} layers ({n_params} parameters a replica, {full.dtype}), E 2, "
          f"1 x {HFL_SEQ} tokens an edge: local step {secs['local']:.4f}s, sync step {secs['sync']:.4f}s "
          f"(warm-up {secs['warm-up local']:.4f}s), peak {peak} bytes, replicas after sync {spread:.3g} {card}",
          flush=True)
    _require(spread == 0.0, "hfl: replicas differ after the sync step")
    out["full"] = {"layers": HFL_LAYERS, "n_params_per_replica": n_params, "local_s": secs["local"],
                   "sync_s": secs["sync"], "peak_bytes": peak}
    del state, b, tok
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_phase(sc, lam, smi: str) -> dict:
    """Phase 12, with its seconds."""
    t_phase = time.perf_counter()
    out = _mesh_engine_phase(sc, lam, smi)
    out["hfl"] = _hfl_phase(smi)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"mesh: phase 12 {out['phase_s']:.1f}s [{smi}]", flush=True)
    return out


# phase 13: the sharded train step and the dry run
DIST_RANKS = 2  # 13b: gloo ranks on the one card, one edge replica each
# 13c in this script: train_4k on the (16, 16) fake mesh, and three
# shapes on (2, 16, 16); rwkv6-7b's and jamba's train_4k, the prefill_32k
# pairs (~5 minutes of fake run each at the card's 512-token attention
# tiles) and the rest of the sweep run through the CLI (PERF.md's dry-run
# table).  The heavy pairs first: each worker takes every DRY_JOBS-th pair.
DRY_TRAIN_ARCHS = ("qwen3-14b", "dbrx-132b", "chameleon-34b", "phi3-mini-3.8b", "qwen1.5-4b", "starcoder2-3b",
                   "granite-moe-3b-a800m", "whisper-tiny")
DRY_MULTI_ARCHS = ("qwen3-14b", "dbrx-132b")
DRY_MULTI_SHAPES = ("train_4k", "decode_32k", "long_500k")
DRY_JOBS = (6, 2)  # worker processes of the two sweeps, run side by side on the host's 8 cores
DRY_TIMEOUT = 600.0


def _bits_checksum(params) -> list:
    """Per leaf (in the tree's sorted-path order) two exact integer sums of
    its raw bit patterns, plain and position-weighted, on the card: equal
    checksums are the parameters bit for bit but for a cancellation no
    update makes.  A DTensor leaf is checked by its local shard."""
    import torch

    from repro_torch.utils.tree import tree_leaves

    out = []
    for x in tree_leaves(params):
        x = x.to_local() if hasattr(x, "to_local") else x
        bits = x.detach().reshape(-1).view({2: torch.int16, 4: torch.int32}[x.element_size()])
        plain = weighted = 0
        for i in range(0, bits.numel(), 1 << 26):
            b = bits[i:i + (1 << 26)].to(torch.int64)
            w = torch.arange(i, i + b.numel(), device=b.device, dtype=torch.int64) % 1_000_003
            plain += int(b.sum())
            weighted += int((b * w).sum())
        out.append((plain, weighted))
    return out


def _one_rank_nccl() -> None:
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)


def _sharded_train_full(smi: str, want: dict) -> dict:
    """Phase 13a: phase 11c's phi3-mini-3.8b step at published widths as a
    one-rank sharded step: ``param_pspec`` from ``param_specs(cfg, ...,
    "fsdp", mesh)`` on a (1, 1) ("data", "model") mesh over a one-rank NCCL
    group, the state laid out as DTensors (``shard_train_state``), the same
    seed-0 weights and ``TokenStream`` batches: losses, gradient norms and
    the parameters' bits (``_bits_checksum``) equal to 11c's, 11c's
    launches; seconds a step and peak memory beside 11c's."""
    import gc

    import numpy as np
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.device import upload
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.training import adam, init_train_state, make_train_step, shard_train_state

    card = f"[{smi}]"
    _one_rank_nccl()
    mesh = DeviceMesh("cuda", [[0]], mesh_dim_names=("data", "model"))
    cfg = get_config(TRAIN_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(torch.Generator("cuda").manual_seed(0), cfg)
    spec = param_specs(cfg, params, "fsdp", mesh)
    opt = adam(1e-3)
    state = shard_train_state(init_train_state(params, opt), spec, mesh)
    del params
    step = make_train_step(cfg, opt, param_pspec=spec)
    stream = TokenStream(cfg.vocab_size, seed=0)
    out = {"step_s": [], "loss": [], "grad_norm": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for i in range(TRAIN_STEPS):
        batch = {k: upload(v.astype(np.int64), torch.device("cuda"))
                 for k, v in stream.train_batch(1, TRAIN_SEQ).items()}
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["total_loss"])  # waits for the step
        out["step_s"].append(time.perf_counter() - t0)
        out["loss"].append(loss)
        out["grad_norm"].append(float(m["grad_norm"]))
        print(f"dist: 13a sharded step {i + 1}: {out['step_s'][-1]:.4f}s loss {loss:.6f} grad_norm "
              f"{out['grad_norm'][-1]:.6g} (11c: {want['step_s'][i]:.4f}s loss {want['loss'][i]:.6f} grad_norm "
              f"{want['grad_norm'][i]:.6g}) {card}", flush=True)
    counts = launch_counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    same = _bits_checksum(state.params) == want["checksum"]
    print(f"dist: 13a {cfg.name} on a (1, 1) mesh (fsdp specs, NCCL): losses and norms equal to 11c "
          f"{out['loss'] == want['loss'] and out['grad_norm'] == want['grad_norm']}, parameter bits equal {same}; "
          f"peak {out['peak_bytes']} bytes (11c {want['peak_bytes']}); launches {json.dumps(counts)} {card}",
          flush=True)
    _require(out["loss"] == want["loss"] and out["grad_norm"] == want["grad_norm"],
             "13a: the one-rank sharded step's losses or norms differ from 11c's")
    _require(same, "13a: the one-rank sharded step's parameters differ from 11c's")
    _require(counts == want["launches"], f"13a: kernel launches {counts}, 11c's {want['launches']}")
    out["launches"] = counts
    del state, step, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _hfl_smoke_inputs():
    """Phase 12c's smoke config, seed-0 weights and (E 2, 4, 16) batch."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params

    cfg = get_smoke_config(TRAIN_ARCH)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    t = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 4, 17))
    return cfg, params, {"tokens": torch.as_tensor(t[..., :-1]), "labels": torch.as_tensor(t[..., 1:])}


def _hfl_dtensor_run(k: int, rank: int) -> dict:
    """``make_hfl_train_step`` (local, local, sync) on an edge mesh of the
    default group's ``k`` ranks, the state this rank's E/k replicas as
    DTensors built by ``DTensor.from_local`` on ``hfl_param_specs``'
    placements (no collective); ``hier_aggregate``'s launches zeroed just
    before the steps and read just after.  Host copies of the rank's
    replicas (sorted-path order), its launches and the losses."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import edge_mesh, hfl_param_specs, init_hfl_state, make_hfl_train_step
    from repro_torch.distributed.sharding import param_specs, to_placements
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training import TrainState, adam
    from repro_torch.training.train_step import _spec_leaves
    from repro_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten

    cfg, params, batch = _hfl_smoke_inputs()
    mesh = edge_mesh(k, device="cuda")
    specs = hfl_param_specs(param_specs(cfg, params, "tp", mesh))
    opt = adam(1e-3)
    local = init_hfl_state(_tree_to(params, "cuda"), opt, 2, mesh=mesh)

    def wrap(tree):
        paths = tree_paths(tree)
        return tree_unflatten(paths, [DTensor.from_local(x, mesh, to_placements(sp, mesh), run_check=False)
                                      for x, sp in zip(tree_leaves(tree), _spec_leaves(specs, paths))])

    state = TrainState(wrap(local.params), tuple(wrap(o) for o in local.opt_state), 0)
    e = 2 // k
    b = {key: v[rank * e:(rank + 1) * e].cuda() for key, v in batch.items()}
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = []
    for sync in (False, False, True):
        state, m = make_hfl_train_step(cfg, opt, sync=sync, mesh=mesh)(state, b)
        losses.append(float(m["total_loss"]))
    torch.cuda.synchronize()
    counts = launch_counts()
    leaves = tree_leaves(state.params)
    return {"replicas": [x.to_local().cpu() for x in leaves], "launches": counts, "losses": losses,
            "n_leaves": len(leaves), "sizes": [x[0].numel() for x in tree_leaves(local.params)]}


def _hfl_dist_rank() -> dict:
    """Phase 13b's rank program (``run_ranks``, gloo, on this card)."""
    import torch

    return _hfl_dtensor_run(torch.distributed.get_world_size(), torch.distributed.get_rank())


def _hfl_dist(smi: str, want: dict, rate: float) -> dict:
    """Phase 13b: phase 12c's smoke HFL run with the state as DTensors on
    ``hfl_param_specs``' placements, at 1 rank (NCCL, this process) and at
    ``DIST_RANKS`` gloo ranks (spawned, all on this card: gloo reduces CUDA
    tensors, so the step issues ``all_reduce`` only): parameters within
    1e-6 of 12c's, one ``hier_aggregate`` launch a leaf at the sync on each
    rank; the kernel at the sync's per-leaf shapes (N = the rank's
    replicas, D = the leaf) against its plain version and ``wn @ x``."""
    import importlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import run_ranks
    from repro_torch.kernels import hier_aggregate, hier_aggregate_ref

    card = f"[{smi}]"
    _one_rank_nccl()
    one = _hfl_dtensor_run(1, 0)
    dist.destroy_process_group()
    diff1 = max(float((a - b).abs().max()) for a, b in zip(one["replicas"], want["params"]))
    t0 = time.perf_counter()
    ranks = run_ranks(_hfl_dist_rank, DIST_RANKS, (), backend="gloo", timeout=MESH_RANK_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    joined = [torch.cat([r["replicas"][i] for r in ranks]) for i in range(len(want["params"]))]
    diff2 = max(float((a - b).abs().max()) for a, b in zip(joined, want["params"]))
    n = one["n_leaves"]
    print(f"dist: 13b make_hfl_train_step on DTensor replicas: 1 rank (NCCL) {diff1:.3g} from 12c, launches "
          f"{json.dumps(one['launches'])}; {DIST_RANKS} ranks (gloo) {diff2:.3g} from 12c, launches per rank "
          f"{[r['launches']['hier_aggregate'] for r in ranks]} ({n} leaves); losses 1 rank {one['losses']} "
          f"{DIST_RANKS} ranks {ranks[0]['losses']}; {spawn_s:.1f}s with the spawn {card}", flush=True)
    _require(diff1 <= 1e-6 and diff2 <= 1e-6, f"13b: parameters {diff1}, {diff2} from 12c")
    _require(one["launches"]["hier_aggregate"] == n and all(r["launches"]["hier_aggregate"] == n for r in ranks),
             "13b: not one hier_aggregate launch a leaf at the sync")
    # the sync's shapes: N replicas of the largest leaf
    agg_mod = importlib.import_module("repro_torch.kernels.hier_aggregate")
    d = max(one["sizes"])
    rng = np.random.default_rng(13)
    shapes = {}
    for rows in sorted({2, 2 // DIST_RANKS}):
        x = torch.as_tensor(rng.standard_normal((rows, d)), dtype=torch.float32, device="cuda")
        w = torch.full((rows,), 0.5, device="cuda")
        err = _close(hier_aggregate(x, w), hier_aggregate_ref(x, w), TOL["float32"])
        wn = w / w.sum()
        t = _timings(kernel=lambda: agg_mod._launch(x, w), wrapper=lambda: hier_aggregate(x, w),
                     plain=lambda: hier_aggregate_ref(x, w), library=lambda: wn @ x,
                     nbytes=(rows + 1) * d * 4 + rows * 4, rate=rate)
        shapes[rows] = {"N": rows, "D": d, "max_abs_err": err, **t}
        print(f"dist: 13b hier_aggregate at the sync's shape N={rows} D={d} torch.float32: max_abs_err={err:.3g} "
              f"{_fmt(t)} {card}", flush=True)
    return {"launches_k1": one["launches"]["hier_aggregate"],
            "launches_per_rank_k2": [r["launches"]["hier_aggregate"] for r in ranks], "leaves": n,
            "param_diff_k1": diff1, "param_diff_k2": diff2, "shapes": shapes, "spawn_s": spawn_s}


def _dry_sweeps():
    """Phase 13c's two sweeps (the dry-run CLI in worker processes), started
    side by side: train_4k of ``DRY_TRAIN_ARCHS`` on (16, 16) and
    ``DRY_MULTI_SHAPES`` of ``DRY_MULTI_ARCHS`` on (2, 16, 16)."""
    import subprocess

    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    runs = []
    for label, extra, jobs in (("16x16", ["--arch", ",".join(DRY_TRAIN_ARCHS), "--shape", "train_4k"], DRY_JOBS[0]),
                               ("2x16x16", ["--multi-pod", "--arch", ",".join(DRY_MULTI_ARCHS),
                                            "--shape", ",".join(DRY_MULTI_SHAPES)], DRY_JOBS[1])):
        path = out_dir / f"dryrun_{label}.json"
        log = open(out_dir / f"dryrun_{label}.log", "w")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *extra, "--jobs", str(jobs), "--out", str(path)]
        runs.append((label, path, log, subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT)))
    return runs


def _dry_results(runs, smi: str) -> dict:
    """Phase 13c: wait for the sweeps; per pair its seconds, per-rank GB,
    dominant term and collective bytes by kind; every pair ok."""
    card = f"[{smi}]"
    deadline = time.perf_counter() + DRY_TIMEOUT
    out = {}
    for label, path, log, proc in runs:
        try:
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except Exception:
            proc.kill()
            proc.wait()
            raise
        finally:
            log.close()
        results = json.loads(path.read_text())
        for r in results:
            mem, rl = r["memory"] or {}, r["roofline"] or {}
            print(f"dist: 13c {label} {r['arch']} {r['shape']} ok {r['ok']} {r['seconds']:.1f}s per-rank "
                  f"{mem.get('total_bytes_per_device', 0) / 1e9:.2f} GB (arguments "
                  f"{mem.get('argument_size_in_bytes', 0) / 1e9:.2f}) dominant {rl.get('dominant')} collective "
                  f"bytes {json.dumps(rl.get('coll_bytes'))} {r['note']} {r['error'].splitlines()[0] if r['error'] else ''}",
                  flush=True)
        _require(proc.returncode == 0 and all(r["ok"] for r in results), f"13c: a {label} dry-run pair failed")
        out[label] = results
    return out


def _dist_phase(train: dict, hfl: dict, rate: float, smi: str) -> dict:
    """Phase 13, with its seconds (13c's sweeps after 13a and 13b, so that
    their host cores do not slow 13a's timed steps)."""
    t_phase = time.perf_counter()
    out = {"train": _sharded_train_full(smi, train), "hfl": _hfl_dist(smi, hfl, rate)}
    out["dry"] = _dry_results(_dry_sweeps(), smi)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"dist: phase 13 {out['phase_s']:.1f}s [{smi}]", flush=True)
    return out


def _dist_only() -> int:
    """``--dist``: phases 11c, 12c and 13 alone (the kernels built first)."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.build import build

    smi = _smi()
    rate = _rates(torch.cuda.get_device_name(0))[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build()
    train = _train_full(rate, smi)
    hfl = _hfl_phase(smi)
    _dist_phase(train, hfl["smoke"], rate, smi)
    return 0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    if argv == ["--dist"]:
        return _dist_only()
    if argv == ["--adam"]:
        return _adam_only()
    if argv:
        if len(argv) != 2 or argv[0] not in ("--wrappers", "--paths"):
            print("usage: python3 chip_smoke.py [--wrappers ROOT | --paths ROOT | --dist | --adam]", file=sys.stderr)
            return 2
        only = _wrappers_only if argv[0] == "--wrappers" else _paths_only
        return only(Path(argv[1]).resolve())
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails when the package is not beside the script)
    from repro_torch.kernels.build import build

    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(label: str) -> None:
        now = time.perf_counter()
        print(f"chip_smoke: {label} {now - t_lap[0]:.1f}s", flush=True)
        t_lap[0] = now

    smi = _smi()
    card_name = torch.cuda.get_device_name(0)
    rates = _rates(card_name)
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    so, log = build()
    print(f"build: {so.name} in {time.perf_counter() - t0:.3f}s", flush=True)
    from repro_torch.federated.programs import CNNProgram
    from repro_torch.utils.tree import tree_num_params

    d_model = tree_num_params(CNNProgram().init(torch.Generator().manual_seed(0)))
    layout = _build_report(log, so, 5, d_model)  # the cloud reduce phase 3 times
    sc, sca_lam = _heartbeat_scenario()
    mix_sc, mix_lam, mix_ids = _mix_scenario()
    kern = _kernel_phase(rates[0], d_model, int(sca_lam.sum(axis=0).max()), mix_ids)
    kern["agg"]["layout"] = layout
    kern["flash"] = _flash_phase(rates)
    kern["topk"] = _topk_phase(rates[0], kern["floor"])
    kern["adam"] = _adam_phase(rates[0], smi)
    lap("phases 1-3")
    _card_vs_cpu()
    _stream_card_vs_cpu()
    _serve_card_vs_cpu()
    lap("phase 4")
    counts = _main_path(sc, sca_lam)
    _profile_round(sc, sca_lam)
    lap("phases 5-6")
    host_launches = _engines_phase(sc, sca_lam)
    lap("phase 6b")
    async_run = _async_phase(sc, sca_lam)
    lap("phase 6c")
    stream_run = _stream_phase()
    lap("phase 6d")
    mix_run = _mix_phase(mix_sc, mix_lam)
    lap("phase 6e")
    _telemetry_phase(sc, sca_lam, mix_sc, mix_lam, smi)
    lm_run = _serve_lm_phase(sc, sca_lam, rates[0], smi)
    lap("phases 6f-6g")
    exact_variants = _serve_exactness()
    serve_counts, serve_variants = _serve_path()
    lap("phases 7-8")
    moe_run = _moe_phase(rates[0], smi)
    rec = _recurrent_phase(rates[0], smi)
    lap("phases 9-10")
    encdec = _encdec_train_phase(rates[0], smi)
    lap("phase 11")
    mesh_run = _mesh_phase(sc, sca_lam, smi)
    lap("phase 12")
    dist_run = _dist_phase(encdec["train"], mesh_run["hfl"]["smoke"], rates[0], smi)
    lap("phase 13")
    rec_smoke = rec["smoke"][JAMBA_ARCH]
    flash = kern["flash"]
    record = []
    for k, fn_name, source, replaces, launches, variant in (
        (kern["seg"], "hier_segment_aggregate", AGG_SOURCE, SEG_REPLACES, counts["hier_segment_aggregate"], None),
        (kern["agg"], "hier_aggregate", AGG_SOURCE, AGG_REPLACES, counts["hier_aggregate"], None),
        (flash["wgmma"], "flash_attention", FLASH_SOURCE, FLASH_REPLACES, serve_variants["wgmma"], "wgmma"),
        (flash["simt"], "flash_attention", FLASH_SIMT_SOURCE, FLASH_REPLACES, exact_variants["simt"], "simt"),
        (kern["topk"], "topk_gating", TOPK_SOURCE, TOPK_REPLACES, moe_run["serve"]["launches"], None),
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
        if fn_name in HEARTBEAT_KERNELS:  # the streaming engine (phase 6d): shape timed in phase 3, launches a round
            big = stream_run[1_000_000]
            entry["stream"] = {**k["stream"], "launches_per_round": big["launches_per_round"][fn_name],
                               "seconds_per_round_1M": big["seconds_per_round"]}
        if fn_name in HEARTBEAT_KERNELS:  # phase 6e: the groups' shapes timed in phase 3, launches per path
            entry["mix"] = {"shapes": k["mix"], "launches": {
                path: counts[fn_name] for path, counts in mix_run["launches"].items()}}
        if fn_name in HEARTBEAT_KERNELS:  # phase 6g: the LM population's shape and its 3 device rounds
            entry["lm"] = {**lm_run["lm"]["kernels"][fn_name], "launches": lm_run["lm"]["launches"][fn_name]}
        if fn_name in HEARTBEAT_KERNELS:  # phase 9d: the MoE population's 3 device rounds, the mix's round
            pop = moe_run["population"]
            entry["moe"] = {**pop["kernels"][fn_name], "launches": pop["launches"][fn_name]}
            entry["moe_mix"] = {"shapes": {g: t[fn_name] for g, t in pop["mix"]["kernels"].items()},
                                "launches": pop["mix"]["launches"][fn_name]}
        if fn_name in HEARTBEAT_KERNELS:  # phase 10d: the mamba and rwkv populations' 3 rounds, the mix's round
            for program, run in rec["population"].items():
                entry[program] = {**run["kernels"][fn_name], "launches": run["launches"][fn_name]}
            entry["recurrent_mix"] = {"shapes": {g: t[fn_name] for g, t in rec["mix"]["kernels"].items()},
                                      "launches": rec["mix"]["launches"][fn_name]}
        if fn_name in HEARTBEAT_KERNELS:  # phase 12: the edge mesh's launches at 1 and MESH_RANKS ranks
            ranks = mesh_run["k5"]
            entry["mesh"] = {
                "launches_k1": mesh_run["k1"]["launches"][fn_name], "launches_k5": ranks["launches"][fn_name],
                "launches_per_rank_k5": ranks["launches_per_rank"][fn_name],
                "shape_k1": "the device pipeline's (the record's main shape)",
                "shape_k5": k["mesh"] if fn_name == "hier_segment_aggregate" else k["by_n"][1],
            }
            if fn_name == "hier_aggregate":
                entry["mesh"]["launches_hfl_sync_smoke"] = mesh_run["hfl"]["smoke"]["launches"][fn_name]
                hfl = dist_run["hfl"]  # phase 13b: the sync on DTensor replicas, one launch a leaf
                entry["dist"] = {
                    "launches_k1": hfl["launches_k1"], "launches_per_rank_k2": hfl["launches_per_rank_k2"],
                    "shape": f"N 2 (1 rank) and 2 / {DIST_RANKS} ({DIST_RANKS} ranks) per leaf, D the leaf's "
                             f"size ({hfl['leaves']} leaves of phi3-mini's smoke config); timed at the largest",
                    "timed": {str(n): t for n, t in hfl["shapes"].items()},
                }
        if fn_name == "hier_aggregate":  # phases 6b (host pipeline) and 6c (async), beside phase 5's count
            entry["launches_host_pipeline"] = host_launches
            entry["launches_async_2_rounds"] = async_run["launches_2_rounds"]
            entry["async_flush_rows"] = async_run["flush_rows"]
            entry["async_weight_uploads"] = async_run["weight_uploads"]
            mode = max(async_run["flush_rows"], key=lambda n: (async_run["flush_rows"][n], -n))
            entry["async_flush"] = k["by_n"].get(mode, {"N": mode, "ms": "not measured"})
        entry.update({key: k[key] for key in _EXTRA_KEYS if key in k})
        if variant == "wgmma":  # phases 9a's and 11a's prefills: shapes timed in phase 3, launches per prefill
            entry["granite"] = {"shape": "B 4, S 2048, Hq 24, Hkv 8, d 64, bf16 (phase 9a)",
                                "launches": moe_run["serve"]["flash_wgmma"], **flash["granite"]}
            entry["whisper"] = {"shape": f"B {WHISPER_B}, S {WHISPER_S}, Hq 6, Hkv 6, d 64, bf16 (phase 11a)",
                                "launches": encdec["serve"]["flash_wgmma"], **flash["whisper"]}
        if fn_name == "topk_gating":  # phase 9: the decode shape's launches; phase 9b's prefill and decode
            entry["shape"] = "T 4, E 40, k 8 (phase 9a decode)"
            entry["launches_per_decode_step"] = moe_run["serve"]["launches"] // moe_run["serve"]["decode_steps"]
            entry["launches_phase_9b"] = moe_run["exact"]["topk_gating"]
            entry["jamba"] = {"shape": f"E 4, k 2, T {JAMBA_SMOKE_B} (decode) and {JAMBA_SMOKE_B * JAMBA_SMOKE_S} "
                                       "(prefill), timed in other_shapes (phase 10b)",
                              "launches": {label: c["topk_gating"] for label, c in rec_smoke.items()}}
        if variant == "simt":
            entry["shape"] = "B 4, S 1536, Hq 40, Hkv 8, d 128, fp32 (phase 7)"
            entry["granite"] = {"shape": "B 4, S 512, Hq 24, Hkv 8, d 64, fp32 (phase 9b)",
                                "launches": moe_run["exact"]["flash_simt"], **flash["simt_granite"]}
            entry["jamba"] = {"shape": f"B {JAMBA_SMOKE_B}, S {JAMBA_SMOKE_S}, Hq 8, Hkv 2, d 16, fp32 (phase 10b)",
                              "launches": {label: c["simt"] for label, c in rec_smoke.items()},
                              **flash["simt_jamba"]}
            entry["fp32_case"] = {
                "shape": "B 2, S 1024, Hq 16, Hkv 4, d 128, fp32",
                **{key: flash["simt"][key] for key in
                   ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", *_EXTRA_KEYS) if key in flash["simt"]},
            }
        record.append(entry)
    adam_k = kern["adam"]
    record.append({"name": "adam_update", "route": "cuda", "source": ADAM_SOURCE, "replaces": ADAM_REPLACES,
                   "launches": encdec["train"]["launches"]["adam_update"],
                   "shape": f"{ADAM_STACK} bf16 p/g, fp32 m/v; replica {ADAM_PARAMS} in {ADAM_LEAVES} leaves",
                   **{k: adam_k[k] for k in ("max_abs_err", "differing_elements", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "replica")}})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all", flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(_smi(), flush=True)
    device = {"platform": "gpu", "kind": card_name, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
