"""Quickstart on the PyTorch port: the paper's pipeline in ~40 lines.

Builds the Heartbeat scenario (Table 3 distribution), runs every assignment
strategy, and trains hierarchical FL for a few cloud rounds with the best,
through ``repro_torch`` (``examples/quickstart.py`` is the JAX package's).
The rounds run on the batched sync engine's device pipeline: every edge's
FedAvg is one ``hier_segment_aggregate`` launch on the card.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --scale 0.02
"""
import argparse

import numpy as np

from repro_torch.core import HFLSchedule
from repro_torch.federated import build_scenario


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--scale", type=float, default=0.03)
    ap.add_argument("--rounds", type=int, default=4, help="cloud rounds")
    ap.add_argument("--engine", default="sync", choices=["reference", "sync", "async"])
    args = ap.parse_args(argv)
    dev = args.device

    print("== building scenario (synthetic Heartbeat, 5 edges x 18 EUs) ==")
    sc = build_scenario("heartbeat", scale=args.scale, seed=0, n_test_per_class=60, device=dev)

    print("\n== assignment strategies (edge-level KLD, lower is better) ==")
    results = {}
    for strat in ("random", "dba", "eara-sca", "eara-dca", "eara-sca+"):
        a = sc.assign(strat, device=dev)
        results[strat] = a
        print(f"  {strat:10s} KLD={a.kld_total:7.3f}  L1-obj={a.objective_l1:9.0f}")

    print(f"\n== hierarchical FL training (EARA-SCA vs DBA, {args.rounds} cloud rounds, T=4) ==")
    # T=4 edge rounds per cloud sync: with T=1 two-level FedAvg telescopes to
    # flat FedAvg and the assignment cannot matter
    for strat in ("dba", "eara-sca"):
        res = sc.simulate(results[strat].lam, cloud_rounds=args.rounds,
                          schedule=HFLSchedule(local_steps=1, edge_per_cloud=4), engine=args.engine, device=dev)
        accs = " ".join(f"{m.test_acc:.3f}" for m in res.history)
        traffic = np.mean(list(res.accountant.eu_traffic_bits().values())) / 8e6
        print(f"  {strat:10s} acc/round: {accs}   mean traffic {traffic:.2f} MB/EU")


if __name__ == "__main__":
    main()
