"""Dry-run core: run every (arch x shape x mesh) step once on fake tensors.

The port of ``src/repro/launch/dryrun_lib.py``.  Where the reference lowers
and compiles each pair for a 256- or 512-device mesh of host placeholder
devices, the port holds ONE rank of a ``"fake"`` process group of the
mesh's size (:func:`fake_group`; rank 0, which holds the largest shard of
an uneven split) and runs the pair's step once under ``FakeTensorMode``:
parameters, optimizer state, cache and batch are fake DTensors laid out by
the spec trees, so nothing is allocated and no collective moves data.

  * ``train``:   ``make_train_step(..., param_pspec=)`` (adam or sgd);
  * ``prefill``: ``prefill``;
  * ``decode``:  ``decode_step`` over a cache laid out by ``cache_specs``.

Per pair (:class:`DryRunResult`):

  * ``memory``: ``argument_size_in_bytes``, the rank's shards of the
    parameters, optimizer state, cache and batch, by spec arithmetic;
    ``temp_size_in_bytes``, the peak of what the step allocates beside
    them (``MemTracker``); ``total_bytes_per_device``, their sum;
  * ``roofline``: per-rank FLOPs and bytes written (``Telemetry.jit_cost``,
    which counts each rank's local operations of a DTensor program), the
    collective bytes by kind (``CollectiveCounter``) and the H100 roofline
    terms; ``model_flops_token`` and ``tokens`` beside them.

The kernel wrappers send fake tensors to their plain versions, whatever
device they claim: nothing launches.  A prefill pair's attention is then
the plain blockwise version, whose temporaries the flash kernel would not
make: its record says so (``attention``).  A pair that fails returns
``ok=False`` with the error; the sweep goes on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.analysis import CollectiveCounter, Roofline, model_flops_per_token, total_params
from repro_torch.distributed.axes import sharding_hints
from repro_torch.distributed.sharding import (
    batch_spec,
    cache_specs,
    local_shape,
    mesh_axes,
    opt_state_specs,
    param_specs,
    to_placements,
)
from repro_torch.launch.specs import cache_shapes, decode_input_specs, param_shapes, train_batch_specs
from repro_torch.launch.specs import plan as make_plan
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizers import adam, sgd
from repro_torch.training.train_step import _spec_leaves, init_train_state, make_train_step, shard_train_state
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

_FAKE_MODE = None


def fake_mode():
    """The process's one ``FakeTensorMode`` (every pair runs under it)."""
    global _FAKE_MODE
    if _FAKE_MODE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _FAKE_MODE = FakeTensorMode()
    return _FAKE_MODE


def fake_group(world_size: int) -> None:
    """Make this process rank 0 of a ``"fake"`` process group of
    ``world_size`` ranks (collectives return at once and move nothing).
    The group is global to the process: one per process, of one size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"this process already holds a group of {dist.get_world_size()} ranks, "
                               f"not {world_size}: run each mesh size in its own process")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


@dataclasses.dataclass
class DryRunResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    kind: str = ""
    note: str = ""
    error: str = ""
    seconds: float = 0.0
    memory: Optional[Dict[str, float]] = None
    roofline: Optional[dict] = None
    model_flops_token: float = 0.0
    tokens: int = 0
    attention: str = ""  # prefill: the attention whose temporaries ``temp`` counts

    def as_dict(self):
        return dataclasses.asdict(self)


def optimizer_for(cfg: ModelConfig, name: str = "adam"):
    del cfg
    return adam(1e-4) if name == "adam" else sgd(0.01, momentum=0.9)


def default_grad_accum(cfg, shape) -> int:
    """Microbatch count so activations fit the card's memory: big models
    accumulate."""
    del shape
    n = total_params(cfg)
    if n > 5e10:
        return 8
    if n > 1e10:
        return 4
    if n > 3e9:
        return 2
    return 1


def _fake_like(tree, device):
    return tree_map(lambda m: torch.empty(tuple(m.shape), dtype=m.dtype, device=device), tree)


def _distribute(tree, specs, mesh):
    from torch.distributed.tensor import distribute_tensor

    paths = tree_paths(tree)
    return tree_unflatten(paths, [distribute_tensor(x, mesh, to_placements(sp, mesh), src_data_rank=None)
                                  for x, sp in zip(tree_leaves(tree), _spec_leaves(specs, paths))])


def _shard_bytes(tree, specs, mesh) -> int:
    """Bytes of rank 0's shards of ``tree`` laid out by ``specs``."""
    total = 0
    paths = tree_paths(tree)
    for x, sp in zip(tree_leaves(tree), _spec_leaves(specs, paths)):
        n = 1
        for s in local_shape(tuple(x.shape), sp, mesh):
            n *= s
        total += n * x.element_size()
    return total


def _batch_specs(batch, shape, mesh):
    rows = batch_spec(shape, mesh)
    return {k: rows if v.dim() == 2 else type(rows)(rows[0], None, None) for k, v in batch.items()}


@contextlib.contextmanager
def _uncounted_shape_inference():
    """DTensor infers a new operation's output shape by running it on fake
    tensors of the GLOBAL shapes, once per (operation, shapes, layout);
    inside, that inference runs with the dispatch modes set aside, so the
    counters (FLOPs, bytes, collectives, ``MemTracker``) see only each
    rank's local work.  Yields False where this torch has no such hook
    (then the caller runs the step once first, filling DTensor's cache)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    orig = getattr(ShardingPropagator, "_propagate_tensor_meta_non_cached", None)
    if orig is None:
        yield False
        return

    def inferred(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = inferred
    try:
        yield True
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _measure(key, fn, *args):
    """(cost, collective bytes, peak bytes) of one run of ``fn(*args)``:
    ``Telemetry.jit_cost`` for the FLOPs and bytes, inside the collective
    counter and ``MemTracker``."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.telemetry import Telemetry, analytic_cost

    coll = CollectiveCounter()
    mem = MemTracker()
    with coll, mem:
        cost = Telemetry().jit_cost(key, fn, *args)
        if cost is None:  # jit_cost keeps its errors: run it bare to raise them
            analytic_cost(fn, args, {})
    peak = sum(snap.get("Total", 0) for snap in mem.get_tracker_snapshot("peak").values())
    return cost, dict(coll.bytes), float(peak)


@contextlib.contextmanager
def _fresh_rope_cache():
    """RoPE's per-device cache of its frequencies emptied on the way in and
    out: inside, its entries are fake tensors, which must not outlive the
    pair's run."""
    from repro_torch.models.modules import _device_frequencies

    _device_frequencies.cache_clear()
    try:
        yield
    finally:
        _device_frequencies.cache_clear()


def _blocks(cfg: ModelConfig) -> int:
    """The config's repeated blocks: layers, or hybrid blocks of layers."""
    return cfg.n_layers // (cfg.hybrid_block if cfg.family == "hybrid" else 1)


def _cut(cfg: ModelConfig, k: int) -> ModelConfig:
    """``cfg`` cut to its first ``k`` blocks (an encdec encoder as deep
    as its decoder is cut alike)."""
    per = cfg.n_layers // _blocks(cfg)
    kw = {"n_layers": k * per}
    if cfg.family == "encdec":
        kw["n_encoder_layers"] = k
    return dataclasses.replace(cfg, **kw)


def _run(p, cfg, mesh, *, sharding_mode, optimizer, remat, grad_accum, run: bool):
    """One pair at ``cfg``: (argument bytes, cost, collective bytes, peak
    bytes, tokens, attention); without ``run`` only the argument bytes."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.transformer import decode_step, prefill

    shape, device = p.shape, torch.device(mesh.device_type)
    attention = ""
    if p.kind != "decode" and any(k == "attn" for k in cfg.layer_kinds()):
        attention = "plain blockwise attention, 512-token tiles" if shape.seq_len > 1024 else "plain sdpa"
    with fake_mode(), sharding_hints(mesh), _fresh_rope_cache():
        params = _fake_like(param_shapes(cfg), device)
        pspec = param_specs(cfg, params, sharding_mode, mesh)
        arg_bytes = _shard_bytes(params, pspec, mesh)
        if p.kind == "train":
            opt = optimizer_for(cfg, optimizer)
            state = init_train_state(params, opt)
            arg_bytes += _shard_bytes(state.opt_state, opt_state_specs(pspec, state.opt_state, params), mesh)
            batch = _fake_like(train_batch_specs(cfg, shape), device)
            bspec = _batch_specs(batch, shape, mesh)
            arg_bytes += _shard_bytes(batch, bspec, mesh)
            fn = make_train_step(cfg, opt, remat=remat, grad_accum=grad_accum, param_pspec=pspec)
            args = lambda: (shard_train_state(state, pspec, mesh), _distribute(batch, bspec, mesh))  # noqa: E731
            tokens = shape.global_batch * shape.seq_len
        elif p.kind == "prefill":
            batch = _fake_like(train_batch_specs(cfg, shape), device)
            batch.pop("labels")
            bspec = _batch_specs(batch, shape, mesh)
            arg_bytes += _shard_bytes(batch, bspec, mesh)

            def fn(params, tokens, enc_embeds=None):
                with implicit_replication():
                    return prefill(params, cfg, tokens, max_seq=shape.seq_len, enc_embeds=enc_embeds)

            args = lambda: (_distribute(params, pspec, mesh),) + tuple(  # noqa: E731
                _distribute(batch, bspec, mesh)[k] for k in ("tokens", "enc_embeds") if k in batch)
            tokens = shape.global_batch * shape.seq_len
        else:
            cache = _fake_like(cache_shapes(cfg, shape, param_shapes(cfg)), device)
            cspec = cache_specs(cfg, cache, shape, mesh)
            arg_bytes += _shard_bytes(cache, cspec, mesh)
            dec = _fake_like(decode_input_specs(cfg, shape), device)
            rows = batch_spec(shape, mesh)
            dspec = {"token": rows, "position": type(rows)(rows[0])}
            arg_bytes += _shard_bytes(dec, dspec, mesh)

            def fn(params, token, cache, position):
                with implicit_replication():
                    return decode_step(params, cfg, token, cache, position)

            def args():
                d = _distribute(dec, dspec, mesh)
                return _distribute(params, pspec, mesh), d["token"], _distribute(cache, cspec, mesh), d["position"]

            tokens = shape.global_batch
        if not run:
            return arg_bytes, None, None, None, tokens, attention
        with _uncounted_shape_inference() as clean:
            if not clean:  # a first run fills DTensor's caches of shape inference instead
                fn(*args())
            cost, coll, peak = _measure(p.kind, fn, *args())
    return arg_bytes, cost, coll, peak, tokens, attention


def _extrapolated(p, cfg, mesh, n: int, accum: int, kw):
    """(cost, collective bytes, peak, note) of ``n`` blocks and ``accum``
    microbatches from runs at 1 and 2 blocks (and, for a train step of
    more than two microbatches, 2 and 3 microbatches of the same rows):
    the counts are linear in blocks, and in microbatches from the second
    on (the first of several adds the fp32 accumulator, the gather of the
    batch and the division, once a step), so X(N, A) = X12 + (N-1) dN +
    (A-2) dA + (N-1)(A-2) dNA.  The activation peak is linear in blocks
    and carried from the runs at the most microbatches run (past the
    third it grows only with the batch the step gathers: +0.1% from 3 to
    4 at the qwen3 smoke config).  ``tests/torch_dryrun_main.py`` holds
    this to full runs."""
    accums = (2, 3) if p.kind == "train" and accum > 2 else (accum if p.kind == "train" else 1,)
    runs = {}
    for a in accums:
        rows = p.shape.global_batch // accum * a if p.kind == "train" else p.shape.global_batch
        plan_a = dataclasses.replace(p, shape=dataclasses.replace(p.shape, global_batch=rows))
        for b in (1, 2):
            runs[b, a] = _run(plan_a, _cut(cfg, b), mesh, run=True, **dict(kw, grad_accum=a))
    a0 = accums[0]

    def at(get):
        x1, x2 = get(runs[1, a0]), get(runs[2, a0])
        if len(accums) == 1:
            return x1 + (n - 1) * (x2 - x1)
        y1, y2 = get(runs[1, 3]), get(runs[2, 3])
        return x1 + (n - 1) * (x2 - x1) + (accum - 2) * (y1 - x1) + (n - 1) * (accum - 2) * (y2 - x2 - y1 + x1)

    keys = set().union(*(r[2] for r in runs.values()))
    cost = {k: at(lambda r, k=k: r[1][k]) for k in runs[1, a0][1]}
    coll = {k: int(at(lambda r, k=k: r[2].get(k, 0))) for k in keys}
    a = accums[-1]
    peak = runs[1, a][3] + (n - 1) * (runs[2, a][3] - runs[1, a][3])
    how = f"depth extrapolated from 1 and 2 of {n} blocks"
    if len(accums) == 2:
        how += f", microbatches from 2 and 3 of {accum}"
    return cost, coll, peak, how


def lower_pair(
    arch: str,
    shape_name: str,
    mesh,
    *,
    sharding_mode: str = "fsdp",
    optimizer: str = "adam",
    remat: bool = True,
    donate: bool = True,
    compile_: bool = True,
    grad_accum: int = 0,
    smoke: bool = False,
    extrapolate: bool = True,
) -> DryRunResult:
    """Run one (arch, shape) on ``mesh`` (a ``DeviceMesh`` over the
    process's fake group) and report it.

    ``smoke`` takes the arch's smoke config in place of its published one
    (the CPU tests).  ``extrapolate`` (the CLI's ``--depth extrapolate``)
    runs the step at the config's first one and two blocks (layers; a
    hybrid's blocks of layers), and a train step of more than two
    microbatches at two and three of them, and carries
    the per-rank FLOPs, bytes, collective bytes and activation peak to the
    full depth and count (:func:`_extrapolated`; the argument bytes are the
    full pair's, by spec arithmetic): a fake run costs ~1 ms an operation,
    minutes a block of a deep config.
    ``compile_=False`` stops after the specs and the argument bytes,
    without running the step.  ``donate`` has no effect: the port's steps
    update their state in place."""
    del donate
    axes = mesh_axes(mesh)
    mesh_name = "x".join(str(s) for s in axes.values())
    n_dev = 1
    for s in axes.values():
        n_dev *= s
    t0 = time.time()
    p = make_plan(arch, shape_name)
    shape_name = getattr(shape_name, "name", shape_name)
    if p is None:
        return DryRunResult(arch, shape_name, mesh_name, ok=True, kind="skip", note="skipped: not applicable")
    cfg = p.cfg
    if smoke:
        small = get_smoke_config(arch)
        cfg = dataclasses.replace(small, max_seq=cfg.max_seq, sliding_window=cfg.sliding_window if p.note
                                  else small.sliding_window)
    if remat and p.kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
    accum = grad_accum or default_grad_accum(cfg, p.shape)
    kw = dict(sharding_mode=sharding_mode, optimizer=optimizer, remat=remat, grad_accum=accum)
    note = p.note
    try:
        n = _blocks(cfg)
        deep = extrapolate and n > 2 and (cfg.family != "encdec" or cfg.n_encoder_layers == cfg.n_layers)
        arg_bytes, cost, coll, peak, tokens, attention = _run(p, cfg, mesh, run=compile_ and not deep, **kw)
        memory = {"argument_size_in_bytes": float(arg_bytes)}
        if not compile_:
            memory["total_bytes_per_device"] = float(arg_bytes)
            return DryRunResult(arch, shape_name, mesh_name, ok=True, kind=p.kind, note=note,
                                seconds=time.time() - t0, memory=memory, tokens=tokens, attention=attention)
        if deep:
            cost, coll, peak, how = _extrapolated(p, cfg, mesh, n, accum, kw)
            note = "; ".join(x for x in (note, how) if x)
        memory["temp_size_in_bytes"] = float(peak)
        memory["total_bytes_per_device"] = memory["argument_size_in_bytes"] + float(peak)
        rl = Roofline(cost["flops"], cost["bytes_moved"], coll, n_dev)
        return DryRunResult(arch, shape_name, mesh_name, ok=True, kind=p.kind, note=note,
                            seconds=time.time() - t0, memory=memory, roofline=rl.as_dict(),
                            model_flops_token=model_flops_per_token(cfg), tokens=tokens, attention=attention)
    except Exception as e:  # noqa: BLE001 -- report, don't crash the sweep
        return DryRunResult(arch, shape_name, mesh_name, ok=False, kind=p.kind, note=note,
                            error=f"{type(e).__name__}: {e}\n{traceback.format_exc()[-2000:]}",
                            seconds=time.time() - t0)
