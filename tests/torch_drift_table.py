"""How far the sequence programs' training drifts from rounding alone.

For each token population at ``scale=1.0`` (12 EUs, 4 edges, EARA-SCA,
the sync engine's device pipeline, both packages from the JAX package's
initial parameters), the table gives the largest parameter difference
after 1 and after 3 cloud rounds

  * between the port and the JAX package (both on the CPU), and
  * between the port and itself with one leaf (``final_norm.scale``)
    multiplied by 1 + 1e-7 before training: a rounding-sized nudge.

Where the nudge alone moves the parameters as far as the two packages
differ, the training amplifies rounding, and a parameter tolerance held
after many rounds tests that amplification, not the code:

    PYTHONPATH=src python tests/torch_drift_table.py [lm mamba rwkv]
"""
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.federated import PROGRAMS, build_scenario
from torch_parity import ReferencePopulation, flat, ref_flat, reference_inits

NUDGE = 1e-7


def drift(name: str, rounds=(1, 3)) -> dict:
    """{rounds: (port vs JAX, port vs nudged port)} largest parameter gaps."""
    cls = type(PROGRAMS.get(name)())
    with reference_inits():
        sc = build_scenario("lm", model=name, scale=1.0, device="cpu")
        ref = ReferencePopulation(sc)
        sc = dataclasses.replace(sc, cost=ref.cost)
        lam = sc.assign("eara-sca", device="cpu").lam
        runs = {r: sc.simulate(lam, r, engine="sync", device="cpu") for r in rounds}
        want = {r: ref.simulate(lam, r, engine="sync") for r in rounds}
        init = cls.init

        def nudged(self, generator):
            params = init(self, generator)
            params["final_norm"]["scale"] = params["final_norm"]["scale"] * (1 + NUDGE)
            return params

        cls.init = nudged
        try:
            nudge = {r: sc.simulate(lam, r, engine="sync", device="cpu") for r in rounds}
        finally:
            cls.init = init
    return {
        r: (float(np.abs(flat(runs[r].final_params) - ref_flat(want[r].final_params)).max()),
            float(np.abs(flat(runs[r].final_params) - flat(nudge[r].final_params)).max()))
        for r in rounds
    }


if __name__ == "__main__":
    torch.set_num_threads(4)
    print("program  rounds  port vs JAX  port vs port nudged by 1e-7")
    for name in sys.argv[1:] or ["lm", "mamba", "rwkv"]:
        t0 = time.perf_counter()
        for r, (vs_ref, vs_nudge) in drift(name).items():
            print(f"{name:7s}  {r:6d}  {vs_ref:11.3g}  {vs_nudge:11.3g}")
        print(f"  ({time.perf_counter() - t0:.0f} s)", flush=True)
