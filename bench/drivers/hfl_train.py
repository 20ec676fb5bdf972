"""Driver ``hfl_train``: per-edge replicas of a dense decoder trained by
the port's ``make_hfl_train_step``.

Set-up draws the weights from the seed on the device (``bench.gen.lm``),
hands them to ``distributed.init_hfl_state`` (E replicas and their Adam
moments), builds the local and the sync step, makes every edge's token
batches (``bench.gen.tokens``, edge e on topic e) and drives the state
through the first steps of the check (local, local, sync) through the
window's own calls and feed.  The window then runs cloud rounds on the
same state: ``sync_every - 1`` local steps and one sync step, each step
ending in the host read of its ``total_loss``, whole rounds until
``--seconds`` have passed.
"""
from __future__ import annotations

import math
import time

from bench import harness
from bench.gen import lm as gen_lm
from bench.gen import tokens as gen_tokens
from bench.reference import lm as ref_lm

# a configuration's MLP activation and norm as the program names them; the
# reference (bench/reference/lm.py) implements these and no others
ACTS = {"silu": "swiglu"}  # a gated MLP with SiLU, as Llama-family config.json states it
NORMS = {"rms_norm_eps": "rmsnorm"}


def model_config(cfg: dict):
    from repro_torch.models.config import ModelConfig

    act = cfg.get("hidden_act")
    norms = [k for k in NORMS if k in cfg]
    if act not in ACTS or len(norms) != 1:
        raise NotImplementedError(f"{cfg['name']}: hidden_act {act!r} and norm keys {norms}; the driver and its "
                                  f"reference run {sorted(ACTS)} with {sorted(NORMS)}")
    return ModelConfig(
        name=cfg["name"], family="dense", n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], act=ACTS[act], norm=NORMS[norms[0]], max_seq=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=float(cfg[norms[0]]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]), dtype=cfg["torch_dtype"], source=cfg["source"])


def _dtype(name: str):
    import torch

    return getattr(torch, name)


def _norms(named: dict, scale: float = 1.0, minus: dict = None) -> dict:
    """{leaf: float norm} of each leaf (less ``minus``'s), one host read
    for all of them."""
    import torch

    names = list(named)
    vals = torch.stack([torch.linalg.vector_norm(named[k].float() - (0 if minus is None else minus[k].float()))
                        for k in names]).cpu().tolist()
    return {k: v * scale for k, v in zip(names, vals)}


def setup(cell: harness.Cell):
    """The replicas built and driven through the checked steps: returns
    (step call, the checked readings, the token batches, a holder of the
    state)."""
    import torch

    from repro_torch.distributed import init_hfl_state, make_hfl_train_step
    from repro_torch.training import adam

    cfg, tr = cell.config, cell.traffic
    train = cfg["training"]
    dev = torch.device(cell.device)
    n_edges, n_layers = cfg["edges"], cfg["num_hidden_layers"]
    mc = model_config(cfg)
    opt = adam(train["lr"], b1=train["b1"], b2=train["b2"], eps=train["eps"])
    with harness.record("init"):
        held = {"state": init_hfl_state(gen_lm.init_weights(cell.seed, cfg, dev, _dtype(cfg["torch_dtype"])), opt,
                                        n_edges)}
    steps = {kind: make_hfl_train_step(mc, opt, sync=kind == "sync", grad_clip=train["clip"])
             for kind in ("local", "sync")}
    toks = torch.from_numpy(gen_tokens.edge_batches(cell.seed, n_edges, tr["batch_steps"], tr["batch"],
                                                    tr["seq_len"], cfg["vocab_size"]))
    if dev.type == "cuda":
        toks = toks.pin_memory()
    fed = [0]

    def step(kind: str) -> float:
        with harness.record("batch upload"):
            t = toks[fed[0] % len(toks)].to(dev, non_blocking=True)
            fed[0] += 1
        with harness.record(f"{kind} step"):
            held["state"], metrics = steps[kind](held["state"], {"tokens": t[..., :-1], "labels": t[..., 1:]})
            return float(metrics["total_loss"])

    # the checked steps: the reference follows them
    checked = {"loss": [], "grad1": None, "change": None}
    for i, kind in enumerate(tr["checked_schedule"]):
        checked["loss"].append(step(kind))
        if i == 0:  # Adam's m after one step from zero is (1 - b1) x the clipped gradient
            m = held["state"].opt_state[0]
            checked["grad1"] = [_norms(gen_lm.leaves(m, n_layers, (e,)), 1 / (1 - train["b1"])) for e in range(n_edges)]
    init = gen_lm.leaves(gen_lm.init_weights(cell.seed, cfg, dev, _dtype(cfg["torch_dtype"])), n_layers)
    checked["change"] = [_norms(gen_lm.leaves(held["state"].params, n_layers, (e,)), minus=init)
                         for e in range(n_edges)]
    del init
    return step, checked, toks, held


def run(cell: harness.Cell) -> dict:
    import torch

    from repro_torch.utils.tree import tree_leaves

    cfg, tr = cell.config, cell.traffic
    n_edges, batch, seq = cfg["edges"], tr["batch"], tr["seq_len"]
    step, checked, toks, held = setup(cell)
    if cell.device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - cell.t0

    # the window: whole cloud rounds until --seconds have passed
    every = tr["sync_every"]
    times = {"local": [], "sync": []}
    failed = 0
    t_win = time.perf_counter()
    while True:
        for j in range(every):
            kind = "sync" if j == every - 1 else "local"
            t = time.perf_counter()
            loss = step(kind)
            times[kind].append(time.perf_counter() - t)
            failed += not math.isfinite(loss)
        if time.perf_counter() - t_win >= cell.seconds:
            break
    window_s = time.perf_counter() - t_win
    n_steps = len(times["local"]) + len(times["sync"])
    tokens = n_steps * n_edges * batch * seq
    peak = torch.cuda.max_memory_allocated() if cell.device != "cpu" else 0
    sizes = [x.numel() // n_edges for x in tree_leaves(held["state"].params)]
    counters = {"window_s": window_s, "steps": n_steps, "tokens": tokens, "local_s": times["local"],
                "sync_s": times["sync"], "leaf_sizes": sizes, "edges": n_edges, "batch": batch, "seq": seq}
    trace = None
    if cell.trace:
        kinds = ["local"] * (every - 1) + ["sync"]
        _, trace = harness.traced(lambda: [step(k) for k in kinds])
        counters["traced_syncs"] = 1
    e2e = {"tokens_per_s": tokens / window_s, "peak_mem_gib": peak / harness.GIB, "setup_s": setup_s}

    held.clear()
    del step
    harness.free_device(cell.device)
    checks = compare(cell, checked, toks)
    return {"e2e": e2e, "attempted": n_steps, "failed": failed, "checks": checks, "peak_bytes": peak,
            "counters": counters, "trace": trace}


def reference(cell: harness.Cell, toks, *, prec: str = "fp32", fault=None) -> dict:
    cfg, tr = cell.config, cell.traffic
    n = len(tr["checked_schedule"])
    batches = [[(toks[s, e, :, :-1], toks[s, e, :, 1:]) for e in range(cfg["edges"])] for s in range(n)]
    init = gen_lm.leaves(gen_lm.init_weights(cell.seed, cfg, cell.device, _dtype(cfg["torch_dtype"])),
                         cfg["num_hidden_layers"])
    sync = tuple(i for i, k in enumerate(tr["checked_schedule"]) if k == "sync")
    train = cfg["training"]
    return ref_lm.train_edges(cfg, init, batches, lr=train["lr"], clip=train["clip"], sync_steps=sync,
                              b1=train["b1"], b2=train["b2"], eps=train["eps"], prec=prec,
                              store=_dtype(cfg["torch_dtype"]), fault=fault, device=cell.device)


def readings(checked: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative gap of the mean
    loss, and the worst (edge, leaf) gap of the first clipped gradient's
    norm and of the parameters' change after the checked steps.  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    (on every edge) are left out of the change."""
    n_edges = len(ref["grad1"])
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(checked["loss"], ref["loss"]))}
    g = [harness.leaf_gaps(checked["grad1"][e], ref["grad1"][e]) for e in range(n_edges)]
    out["grad1_gap"] = max(g)
    med = harness.median([x for e in range(n_edges) for x in ref["grad1"][e].values()])
    keep = {k: max(ref["grad1"][e][k] for e in range(n_edges)) >= 1e-3 * med for k in ref["grad1"][0]}
    out["change_gap"] = max(harness.leaf_gaps(checked["change"][e], ref["change"][e], keep) for e in range(n_edges))
    return out


def calibrate(cell: harness.Cell, variants) -> dict:
    """Readings for setting the limits: the program's checked steps, and
    each variant of the reference put in its place ("fp8", the control,
    or a fault), each against the float32 reference."""
    step, checked, toks, held = setup(cell)
    held.clear()
    del step
    harness.free_device(cell.device)
    ref = reference(cell, toks)
    out = {"program": readings(checked, ref)}
    for v in variants:
        got = reference(cell, toks, prec="fp8" if v == "control" else "fp32", fault=None if v == "control" else v)
        out[v] = readings(got, ref)
    return out


def compare(cell: harness.Cell, checked: dict, toks) -> list:
    return harness.checks(readings(checked, reference(cell, toks)), cell.limits)
