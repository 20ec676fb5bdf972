"""End to end on the PyTorch port: the full I-Care hierarchical-FL
experiment.

The paper's Sec. 6 protocol end to end through ``repro_torch``
(``examples/hfl_healthcare.py`` is the JAX package's): synthetic data
matching Tables 2/3, wireless topology, EARA assignment + bandwidth
allocation, hierarchical training (T' local epochs, T edge rounds per
cloud round), divergence tracking vs the virtual-centralized model (eq.
17), and the communication accounting behind Figs. 5/6.  The rounds run on
the batched sync engine's device pipeline (``--engine``): each edge round's
FedAvg is one ``hier_segment_aggregate`` launch on the card.

  PYTHONPATH=src python examples/hfl_healthcare_torch.py [--dataset seizure]
                                                         [--rounds 8] [--scale 0.05]
  PYTHONPATH=src python examples/hfl_healthcare_torch.py --device cpu --rounds 2 --scale 0.02
"""
import argparse

import numpy as np

from repro_torch.core import HFLSchedule
from repro_torch.federated import build_scenario


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="heartbeat", choices=["heartbeat", "seizure"])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--local-steps", type=int, default=1, help="T'")
    ap.add_argument("--edge-per-cloud", type=int, default=2, help="T")
    ap.add_argument("--engine", default="sync", choices=["reference", "sync", "async"])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    sc = build_scenario(args.dataset, scale=args.scale, seed=0, n_test_per_class=100, device=dev)
    print(f"dataset={args.dataset}  EUs={len(sc.clients)}  edges={sc.n_edges}")
    print("per-EU class counts:\n", sc.class_counts)

    strategies = {}
    for strat in ("dba", "eara-sca", "eara-dca"):
        a = sc.assign(strat, device=dev)
        strategies[strat] = a
        served = "n/a" if a.served is None else f"{a.served.mean():.0%}"
        print(f"\n{strat}: KLD={a.kld_total:.3f} served={served}")
        print("  assignment:", {i: list(np.nonzero(a.lam[i])[0]) for i in range(len(sc.clients))})

    sched = HFLSchedule(args.local_steps, args.edge_per_cloud)
    print(f"\nschedule: T'={sched.local_steps} T={sched.edge_per_cloud} "
          f"(cloud sync every {sched.cloud_period} local epochs)")

    for strat, a in strategies.items():
        res = sc.simulate(a.lam, cloud_rounds=args.rounds, schedule=sched, track_divergence=(strat == "dba"),
                          seed=0, engine=args.engine, device=dev)
        print(f"\n== {strat} ==")
        for m in res.history:
            div = f" div={m.divergence:.3f}" if m.divergence else ""
            print(f"  cloud round {m.cloud_round:2d}: acc={m.test_acc:.3f} "
                  f"loss={m.mean_local_loss:.3f}{div}")
        acc = res.accountant
        print(f"  edge rounds={acc.edge_rounds} cloud rounds={acc.cloud_rounds} "
              f"edge<->cloud traffic={acc.edge_cloud_bits/8e6:.2f} MB "
              f"mean EU traffic={np.mean(list(acc.eu_traffic_bits().values()))/8e6:.2f} MB")

    cent = sc.centralized(args.rounds, device=dev)
    print("\ncentralized benchmark acc:", " ".join(f"{m.test_acc:.3f}" for m in cent))


if __name__ == "__main__":
    main()
