"""Hierarchical FL for LM training on the PyTorch port: the paper's
pipeline on a non-CNN workload, end to end.

Builds the topic-skewed token-stream population (``build_scenario(model=
...)``): each EU's shard is dominated by one Markov topic, the LM
counterpart of the paper's per-EU class imbalance.  EARA assigns EUs to
edges by their TOPIC histograms (same KLD objective, topics = classes),
then the batched sync engine trains the chosen sequence model (the dense
transformer-LM, the top-k-routed MoE, the hybrid attn+Mamba, or RWKV-6)
through the device-resident round pipeline, through ``repro_torch``
(``examples/hfl_lm_training.py`` is the JAX package's).

  PYTHONPATH=src python examples/hfl_lm_training_torch.py --rounds 3 --scale 0.1
  PYTHONPATH=src python examples/hfl_lm_training_torch.py --model moe --rounds 2 --device cpu
"""
import argparse

from repro_torch.federated import build_scenario


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="lm", choices=["lm", "moe", "mamba", "rwkv"],
                    help="sequence program to train")
    ap.add_argument("--rounds", type=int, default=3, help="cloud rounds")
    ap.add_argument("--scale", type=float, default=0.1, help="sequences-per-EU scale")
    ap.add_argument("--eus", type=int, default=12)
    ap.add_argument("--edges", type=int, default=4)
    ap.add_argument("--topics", type=int, default=4)
    ap.add_argument("--engine", default="sync", choices=["reference", "sync", "async"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    sc = build_scenario(
        model=args.model, seed=args.seed, scale=args.scale, n_test_per_class=32,
        lm_eus=args.eus, lm_edges=args.edges, lm_topics=args.topics, device=dev,
    )
    print(
        f"{args.model} population: {len(sc.clients)} EUs x "
        f"~{len(sc.clients[0].shard)} sequences, {args.topics} topics, "
        f"model {sc.model_bits / 8e3:.1f} kB"
    )
    eara = sc.assign("eara-sca", device=dev)
    dba = sc.assign("dba", device=dev)
    print(
        f"edge TOPIC imbalance (total KLD): eara-sca={eara.kld_total:.3f}  "
        f"dba={dba.kld_total:.3f}  (lower = better-mixed edges)"
    )
    res = sc.simulate(eara.lam, cloud_rounds=args.rounds, seed=args.seed, engine=args.engine, device=dev)
    for m in res.history:
        print(
            f"cloud round {m.cloud_round}: next-token acc={m.test_acc:.4f} "
            f"mean local loss={m.mean_local_loss:.3f}"
        )
    traffic = sum(res.accountant.eu_traffic_bits().values()) / 8e6
    print(f"done: {res.accountant.edge_rounds} edge rounds, "
          f"{traffic:.2f} MB total EU<->edge traffic")


if __name__ == "__main__":
    main()
