"""Training launcher.

Two modes:
  * --paper      : the paper's hierarchical-FL healthcare experiment;
  * --arch <id>  : LM training of one sequence model on the synthetic token
                   stream (its smoke config, or ``--full-config`` for the
                   published widths: phi3-mini-3.8b's fits one 80 GB card).

  PYTHONPATH=src python -m repro_torch.launch.train --paper --rounds 4
  PYTHONPATH=src python -m repro_torch.launch.train --paper --device cpu --telemetry out/
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b --full-config --steps 3 --batch 1 --seq 1024

The port of ``repro.launch.train``, with the same flags plus ``--device``
(default ``cuda``; without CUDA it raises unless ``--device cpu`` is
given).  ``--telemetry DIR`` records the run's spans,
metrics and round records and writes ``trace.json``, ``trace.jsonl``,
``rounds.jsonl``, ``metrics.json`` and ``summary.txt`` there;
``--engine`` picks the simulation engine; ``--faults chaos`` runs under
the fault-injection preset (client churn, mid-round upload losses with
async retries, finite energy budgets, time-varying channels);
``--cohort N`` trains a sampled N-client cohort a round, and with
``--lazy-eus M`` over a lazy M-client population on the streaming engine;
``--dataset lm`` federates the dense transformer LM over the token-stream
population.  ``--serve Q`` hot-swaps the global model into serving after
each cloud round and drives it with Q deterministic queries drawn from the
scenario's own shards (``--serve-batch`` a batch, a swap every
``--swap-every`` rounds), printing serve_acc, qps and staleness per round.

``--arch`` trains with ``adam(--lr)`` through ``make_train_step`` (its
in-place update), weights drawn from ``torch.Generator`` seeded by
``--seed`` (not the reference's ``jax.random`` draws), batches from the
port's ``TokenStream`` (the reference's, draw for draw); the first step's
``train_step`` span carries its analytic cost, and the loss is read inside
each span.  ``--checkpoint PATH`` saves the parameters in the reference's
format (``repro_torch.training.checkpoint``).  An encdec --arch needs frame
embeddings the token stream does not give, and raises, as the
reference's does.
"""
from __future__ import annotations

import argparse

# fault-injection presets for --faults (FaultSpec kwargs; "chaos": >= 20%
# churn, lossy uplinks, finite batteries, fading drift)
FAULT_PRESETS = {
    "chaos": dict(
        p_drop=0.25, p_rejoin=0.5, p_fail=0.2, max_retries=2, backoff_s=0.1,
        energy_uploads=6.0, refade_rounds=1, drift_rate=0.05,
    ),
}


def run_paper(args) -> None:
    from repro_torch.core import HFLSchedule
    from repro_torch.federated import CohortSpec, build_scenario

    schedule = HFLSchedule(args.local_steps, args.edge_per_cloud)
    telemetry = args.telemetry or None
    cohort = None
    if args.cohort:
        cohort = CohortSpec(size=args.cohort, strategy=args.cohort_strategy, seed=args.seed)
    if args.lazy_eus:
        # streaming mode: lazy shard synthesis, striped assignment and the
        # cohort-sampled StreamSyncEngine; nothing O(M) is materialized
        if cohort is None:
            raise SystemExit("--lazy-eus requires --cohort N")
        sc = build_scenario(args.dataset, lazy=True, n_eus=args.lazy_eus, n_edges=args.lazy_edges, seed=args.seed,
                            device=args.device)
        print(f"streaming M={sc.n_clients} N={sc.n_edges} KLD={sc.kld_total():.3f}")
        res = sc.simulate(cohort, cloud_rounds=args.rounds, schedule=schedule, seed=args.seed,
                          server_momentum=args.server_momentum, telemetry=telemetry, device=args.device)
        for m in res.history:
            print(f"round {m.cloud_round}: acc={m.test_acc:.3f} wall={m.wall_seconds:.2f}s")
        if res.telemetry is not None:
            print(res.telemetry.summary())
        return
    faults = None
    if args.faults:
        from repro_torch.faults import FaultSpec

        faults = FaultSpec(seed=args.seed, **FAULT_PRESETS[args.faults])
    serve = None
    if args.serve:
        from repro_torch.serving import TrafficSpec

        serve = TrafficSpec(queries=args.serve, batch=args.serve_batch, swap_every=args.swap_every, seed=args.seed)
    sc = build_scenario(args.dataset, scale=args.scale, seed=args.seed, device=args.device)
    a = sc.assign(args.strategy, device=args.device)
    print(f"strategy={args.strategy} KLD={a.kld_total:.3f}")
    res = sc.simulate(
        a.lam, cloud_rounds=args.rounds, schedule=schedule, seed=args.seed, engine=args.engine, faults=faults,
        cohort=cohort, server_momentum=args.server_momentum, telemetry=telemetry, serve=serve, device=args.device,
    )
    serve_by_round = {r["round"]: r for r in (res.serve_history or [])}
    for m in res.history:
        extra = f" wall={m.wall_seconds:.2f}s"
        if m.sim_seconds:
            extra += f" sim={m.sim_seconds:.2f}s"
        s = serve_by_round.get(m.cloud_round)
        if s is not None:
            extra += f" serve_acc={s['serve_acc']:.3f} qps={s['serve_qps']:.0f} stale={s['serve_staleness_rounds']:.0f}"
        print(f"round {m.cloud_round}: acc={m.test_acc:.3f}{extra}")
    if faults is not None:
        t = res.accountant.totals()
        print(
            f"faults: wasted={t['wasted_bits'] / 1e6:.2f}Mb dropped={t['dropped_uploads']:.0f} "
            f"retried={t['retried_uploads']:.0f} abandoned={t['abandoned_uploads']:.0f}"
        )
    if res.telemetry is not None:
        print(res.telemetry.summary())
        if args.telemetry:
            print("telemetry artifacts in", args.telemetry)


def run_lm(args) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.device import configure_numerics, resolve_device, upload
    from repro_torch.models import init_params
    from repro_torch.telemetry import Telemetry
    from repro_torch.training import adam, init_train_state, make_train_step, save_checkpoint

    dev = resolve_device(args.device)
    configure_numerics(dev)
    cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
    params = init_params(torch.Generator(dev).manual_seed(args.seed), cfg)
    opt = adam(args.lr)
    state = init_train_state(params, opt)
    step = make_train_step(cfg, opt, grad_accum=args.grad_accum)
    stream = TokenStream(cfg.vocab_size, seed=args.seed)
    tel = Telemetry(out_dir=args.telemetry or None)
    for i in range(1, args.steps + 1):
        batch = {k: upload(v.astype(np.int64), dev) for k, v in stream.train_batch(args.batch, args.seq).items()}
        with tel.span("train_step", step=i) as sp:
            if i == 1:
                cost = tel.jit_cost("train_step", step, state, batch)
                if cost:
                    sp.set(**cost)
            state, m = step(state, batch)
            loss = float(m["total_loss"])  # host sync inside the span
        if i % max(1, args.steps // 10) == 0:
            ds = tel.tracer.durations("train_step")
            print(f"step {i:4d} loss={loss:.4f} ({sum(ds) / len(ds):.2f}s/step)")
    if args.telemetry:
        for k, p in tel.flush().items():
            print(f"  wrote {k}: {p}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state.params, step=args.steps)
        print("saved", args.checkpoint)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper", action="store_true")
    ap.add_argument("--dataset", default="heartbeat")
    ap.add_argument("--strategy", default="eara-sca")
    ap.add_argument("--engine", default="reference", choices=("reference", "sync", "async"))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--edge-per-cloud", type=int, default=1)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--faults", default="", choices=("", *FAULT_PRESETS),
                    help="fault-injection preset for the paper experiment")
    ap.add_argument("--cohort", type=int, default=0, metavar="N",
                    help="sample an N-client cohort per edge round instead of full participation")
    ap.add_argument("--cohort-strategy", default="uniform", choices=("uniform", "prate", "per_edge"))
    ap.add_argument("--server-momentum", type=float, default=0.0,
                    help="cloud-side momentum on the aggregated update")
    ap.add_argument("--lazy-eus", type=int, default=0, metavar="M",
                    help="streaming mode: a lazy M-client population (needs --cohort)")
    ap.add_argument("--lazy-edges", type=int, default=8)
    ap.add_argument("--serve", type=int, default=0, metavar="Q",
                    help="evaluation under traffic: Q queries a cloud round against the hot-swapped global model")
    ap.add_argument("--serve-batch", type=int, default=32, help="serving batch size for --serve")
    ap.add_argument("--swap-every", type=int, default=1,
                    help="hot-swap the served model every K cloud rounds (serve_staleness_rounds)")
    ap.add_argument("--arch", default="", help="LM training of a sequence model (without --paper)")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--telemetry", default="", metavar="DIR", help="record telemetry; write artifacts to DIR")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.paper or not args.arch:
        run_paper(args)
    else:
        run_lm(args)


if __name__ == "__main__":
    main()
