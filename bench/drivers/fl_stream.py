"""Driver ``fl_stream``: cloud rounds of the port's streaming engine.

Set-up makes the population, the test set and the initial CNN from the
seed (``bench.gen.health``), builds one ``StreamSyncEngine`` over them
with every client resident (``page_slots`` = M, paged in through
``PagedShardStore.ensure`` in chunks), and drives it through the first
``checked_rounds`` rounds; those rounds are what the reference follows.
The window then runs rounds back to back on the same engine, one
``run(1)`` call each, each ending in its test accuracy on the host.  Each
call gets a fresh uniform ``CohortSpec`` (seeded from ``--seed`` and the
round), since the engine keys its draw on a round index that restarts in
every call.
"""
from __future__ import annotations

import math
import time

import numpy as np

from bench import harness
from bench.gen import health
from bench.reference import fl as ref_fl

_SEED_MIX = 0x9E3779B97F4A7C15


def cohort_seed(seed: int, cloud_round: int) -> int:
    return (int(seed) * 1_000_003 + cloud_round * _SEED_MIX) % (1 << 63)


class _Source:
    """The population as the engine's ``ShardSource``: sizes, feature
    layout and ``shard(cid)`` views of the bulk arrays."""

    def __init__(self, pop, dataset_cls):
        self.pop = pop
        self.n_clients = pop.n_clients
        self.sizes = pop.sizes
        self.feat_shape = tuple(pop.x.shape[1:])
        self.feat_dtype = pop.x.dtype
        self._ds = dataset_cls

    def shard(self, cid: int):
        x, y = self.pop.shard(int(cid))
        return self._ds(x, y, self.pop.n_classes)


def build(cell: harness.Cell):
    """Inputs from the seed and the engine over them."""
    import torch

    from repro_torch.core import HFLSchedule
    from repro_torch.data.synthetic_health import Dataset
    from repro_torch.engine import StreamSyncEngine
    from repro_torch.federated import CohortSpec
    from repro_torch.federated.programs import CNNProgram
    from repro_torch.models.cnn1d import CNNConfig

    cfg, tr = cell.config, cell.traffic
    model, data, train = cfg["model"], cfg["population"], cfg["training"]
    pop = health.make_population(cell.seed, tr["clients"], data["edges"], n_classes=model["n_classes"],
                                 length=model["seq_len"], channels=model["in_channels"],
                                 min_per_class=data["min_per_class"], max_per_class=data["max_per_class"],
                                 dom_boost=data["dom_boost"], device=cell.device)
    test = health.make_test_set(cell.seed, tr["test_per_class"], n_classes=model["n_classes"],
                                length=model["seq_len"], channels=model["in_channels"], device=cell.device)
    init = health.cnn_init(cell.seed, model, device=cell.device)
    if cell.device != "cpu":  # the peak is the program's: the inputs were drawn on the card and copied out
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    program = CNNProgram(CNNConfig(**model))
    eng = StreamSyncEngine(
        _Source(pop, Dataset), pop.edge_of, program, Dataset(test[0], test[1], model["n_classes"]),
        cohort=CohortSpec(size=tr["cohort"], seed=cohort_seed(cell.seed, 1)), n_edges=data["edges"],
        schedule=HFLSchedule(train["local_epochs"], train["edge_rounds"]), seed=cell.seed % (1 << 63),
        page_slots=tr["page_slots"], batch_size=train["batch"], lr=train["lr"], max_steps=train["max_steps"],
        device=cell.device)
    eng.params = {k: {kk: vv.to(torch.float32).clone() for kk, vv in v.items()} for k, v in init.items()}
    del init
    chunk = int(tr["page_chunk"])
    with harness.record("page_in"):
        for lo in range(0, pop.n_clients, chunk):
            eng.store.ensure(np.arange(lo, min(lo + chunk, pop.n_clients)))
    return eng, pop, test


class _Tally:
    """Samples trained, counted where the engine's cohort plan hands out
    each round's groups."""

    def __init__(self, plan):
        self.samples = 0
        self._draw = plan.draw
        plan.draw = self

    def __call__(self, rng, members, epochs):
        groups, passthrough = self._draw(rng, members, epochs)
        self.samples += sum(len(g.members) * g.epochs * g.steps * g.batch for g in groups)
        return groups, passthrough


def setup(cell: harness.Cell):
    """The engine built and driven through the checked rounds: returns
    (engine, population, test set, the checked rounds, the round call,
    the sample tally)."""
    from repro_torch.federated import CohortSpec

    tr = cell.traffic
    eng, pop, test = build(cell)
    tally = _Tally(eng.plan)
    size = tr["cohort"]
    r = 0

    def one_round():
        nonlocal r
        r += 1
        eng.cohort = CohortSpec(size=size, seed=cohort_seed(cell.seed, r))
        with harness.record("run(1)"):
            h = eng.run(1).history[-1]
        return h.mean_local_loss, h.test_acc

    checked = []
    for _ in range(tr["checked_rounds"]):
        loss, acc = one_round()
        checked.append({"loss": loss, "acc": acc,
                        "params": {k: v.detach().clone() for k, v in ref_fl.flat_params(eng.params).items()}})
    return eng, pop, test, checked, one_round, tally


def run(cell: harness.Cell) -> dict:
    import torch

    eng, pop, test, checked, one_round, tally = setup(cell)
    if cell.device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - cell.t0

    # the window: whole rounds until --seconds have passed
    lat, failed, samples0 = [], 0, tally.samples
    t_win = time.perf_counter()
    while True:
        t = time.perf_counter()
        loss, acc = one_round()
        lat.append(time.perf_counter() - t)
        failed += not (math.isfinite(loss) and math.isfinite(acc))
        if time.perf_counter() - t_win >= cell.seconds:
            break
    window_s = time.perf_counter() - t_win
    rounds = len(lat)
    size = cell.traffic["cohort"]
    clients = rounds * min(size, pop.n_clients)
    peak = torch.cuda.max_memory_allocated() if cell.device != "cpu" else 0
    counters = {"window_s": window_s, "window_samples": tally.samples - samples0, "rounds": rounds,
                "cohort": size, "dim": eng.pack.dim, "edges": eng.n_edges}
    trace = None
    if cell.trace:
        n_traced = max(1, min(cell.traffic["traced_rounds"], rounds))
        _, trace = harness.traced(lambda: [one_round() for _ in range(n_traced)])
        counters["traced_rounds"] = n_traced
    e2e = {"fl_clients_per_s": clients / window_s, "latency_ms_p95": 1e3 * harness.p95(lat),
           "peak_mem_gib": peak / harness.GIB, "setup_s": setup_s}
    del eng, tally, one_round
    harness.free_device(cell.device)
    checks = compare(cell, pop, test, checked)
    return {"e2e": e2e, "attempted": rounds, "failed": failed, "checks": checks, "peak_bytes": peak,
            "counters": counters, "trace": trace}


def calibrate(cell: harness.Cell, variants) -> dict:
    """Readings for setting the limits: the program's checked rounds, and
    each variant of the reference put in its place ("tf32", the control,
    or a fault), each against the float64 reference."""
    eng, pop, test, checked, one_round, tally = setup(cell)
    del eng, tally, one_round
    harness.free_device(cell.device)
    init, ref = reference_rounds(cell, pop, test, len(checked))
    n_test = len(test[1])
    out = {"program": readings(checked, ref, init, n_test)}
    for v in variants:
        _, got = reference_rounds(cell, pop, test, len(checked), prec="tf32" if v == "control" else "fp64",
                                  fault=None if v == "control" else v)
        out[v] = readings(got, ref, init, n_test)
    return out


def reference_rounds(cell: harness.Cell, pop, test, n: int, *, fault=None, prec="fp64"):
    cfg, tr = cell.config, cell.traffic
    train = cfg["training"]
    init = health.cnn_init(cell.seed, cfg["model"], device=cell.device)
    return init, ref_fl.run_rounds(
        pop, test, init, cohort_seeds=[cohort_seed(cell.seed, r) for r in range(1, n + 1)],
        cohort_size=tr["cohort"], engine_seed=cell.seed % (1 << 63), n_edges=cfg["population"]["edges"],
        batch=train["batch"], lr=train["lr"], max_steps=train["max_steps"], device=cell.device, fault=fault,
        prec=prec)


def readings(checked, ref, init, n_test: int) -> dict:
    """The numbers compared: the worst round's relative gap of the mean
    local loss and gap of the accuracy (in test samples), and the worst
    leaf's gap of the global model's change after the first round and
    after the last.  Leaves whose reference change is under a thousandth
    of the median leaf's are left out."""
    init = ref_fl.flat_params(init)
    out = {
        "loss_gap": max(abs(c["loss"] - r["loss"]) / abs(r["loss"]) for c, r in zip(checked, ref)),
        "acc_gap_samples": max(abs(c["acc"] - r["acc"]) * n_test for c, r in zip(checked, ref)),
    }
    for tag, i in (("change1_gap", 0), ("change_last_gap", len(ref) - 1)):
        rn = ref_fl.change_norms(ref[i]["params"], init)
        pn = ref_fl.change_norms(checked[i]["params"], init)
        med = harness.median(list(rn.values()))
        out[tag] = harness.leaf_gaps(pn, rn, {k: rn[k] >= 1e-3 * med for k in rn})
    return out


def compare(cell: harness.Cell, pop, test, checked) -> list:
    init, ref = reference_rounds(cell, pop, test, len(checked))
    return harness.checks(readings(checked, ref, init, len(test[1])), cell.limits)
