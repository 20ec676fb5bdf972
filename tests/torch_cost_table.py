"""The analytic cost of each program the engines count, in both packages.

``Telemetry.jit_cost`` counts a program's FLOPs and bytes: the JAX package
from its lowered HLO (``distributed/hlo_stats.py``), the port by running it
on meta tensors under ``torch.utils.flop_counter`` with a byte counter.
``cost_pairs`` returns both packages' counts for every key the engines use,
at the heartbeat shapes scaled by its arguments; run as a script it prints
them at the full heartbeat shapes (cohort C 18 of S 128 steps of batch 10,
edge FedAvg N 18 into E 5, cloud reduce N 5, the mixed population's fuse
over E 5 edges, 4 steps of 16) with each key's bytes ratio:

    PYTHONPATH=src python tests/torch_cost_table.py

FLOPs count the matrix products (and, in the port, convolutions), forward
and backward.  ``bytes_moved`` differs by design: the reference counts what
XLA's fusion leaves in memory, the port every eager operation's output.
"""
import time

import jax.numpy as jnp
import numpy as np
import torch

from repro.engine import cohort as ref_cohort
from repro.engine import distill as ref_distill
from repro.engine.distill import DistillSpec as RefDistillSpec
from repro.engine.flatten import FlatPack as RefFlatPack
from repro.engine.flatten import flat_mean as ref_flat_mean
from repro.engine.sync_sim import _segment_agg_keep as ref_segment_agg_keep
from repro.federated.programs import CNNProgram as RefCNNProgram
from repro.federated.programs import MLPProgram as RefMLPProgram
from repro.telemetry import Telemetry as RefTelemetry
from repro_torch.engine import cohort, distill
from repro_torch.engine.distill import DistillSpec
from repro_torch.engine.flatten import FlatPack, flat_mean
from repro_torch.engine.sync_sim import _segment_agg_keep
from repro_torch.federated.programs import CNNProgram, MLPProgram
from repro_torch.telemetry import Telemetry

KEYS = ("cohort_epoch_flat", "cohort_epoch", "segment_agg_keep", "cloud_reduce", "kd_targets", "kd_fuse_one")


def _ref_pack(program):
    import jax

    return RefFlatPack(program.init(jax.random.PRNGKey(0)))


def cost_pairs(c: int = 18, steps: int = 128, batch: int = 10, n_edges: int = 5, kd_steps: int = 4,
               kd_batch: int = 16) -> dict:
    """{key: (port cost, reference cost)}, each ``{"flops", "bytes_moved"}``:
    a cohort of ``c`` CNN clients (``cohort_epoch_flat`` on the GEMM form,
    ``cohort_epoch`` on the host pipeline's library convolution), the edge
    FedAvg of ``c`` rows into ``n_edges`` and the cloud reduce of
    ``n_edges`` rows, and the fuse of a CNN and an MLP group on
    ``n_edges`` edges."""
    tel, ref = Telemetry(), RefTelemetry()
    prog, ref_prog = CNNProgram(), RefCNNProgram()
    pk, ref_pk = FlatPack(prog.init(torch.Generator().manual_seed(0))), _ref_pack(ref_prog)
    d, feat = pk.dim, prog.feat_shape
    flat, xb, yb = torch.zeros((c, d)), torch.zeros((c, steps, batch, *feat)), torch.zeros((c, steps, batch),
                                                                                           dtype=torch.int32)
    j_flat, j_xb, j_yb = jnp.zeros((c, d)), jnp.zeros((c, steps, batch, *feat)), jnp.zeros((c, steps, batch),
                                                                                           jnp.int32)
    out = {}
    out["cohort_epoch_flat"] = (
        tel.jit_cost("cohort_epoch_flat", cohort._cohort_epoch_flat, flat, xb, yb, pk.spec, prog, steps, 1e-3),
        ref.jit_cost("cohort_epoch_flat", ref_cohort._cohort_epoch_flat, j_flat, j_xb, j_yb, ref_pk.spec, ref_prog,
                     steps, 1e-3),
    )
    out["cohort_epoch"] = (
        tel.jit_cost("cohort_epoch", cohort._cohort_epoch_flat, flat, xb, yb, pk.spec, prog, steps, 1e-3, "xla"),
        ref.jit_cost("cohort_epoch", ref_cohort._cohort_epoch, ref_pk.unravel_batched(j_flat), j_xb, j_yb, ref_prog,
                     steps, 1e-3, "xla"),
    )
    seg = np.arange(c) % n_edges
    out["segment_agg_keep"] = (
        tel.jit_cost("segment_agg_keep", _segment_agg_keep, flat, torch.as_tensor(seg), torch.ones(c),
                     torch.ones(n_edges, dtype=torch.bool), torch.zeros((n_edges, d)), n_edges, "kernel"),
        ref.jit_cost("segment_agg_keep", ref_segment_agg_keep, j_flat, jnp.asarray(seg, jnp.int32), jnp.ones(c),
                     jnp.ones(n_edges, bool), jnp.zeros((n_edges, d)), n_edges, "pallas"),
    )
    out["cloud_reduce"] = (
        tel.jit_cost("cloud_reduce", lambda u, w: flat_mean(u, w), torch.zeros((n_edges, d)), torch.ones(n_edges)),
        ref.jit_cost("cloud_reduce", lambda u, w: ref_flat_mean(u, w, backend="pallas"), jnp.zeros((n_edges, d)),
                     np.ones(n_edges, np.float32)),
    )
    progs, ref_progs = (prog, MLPProgram()), (ref_prog, RefMLPProgram())
    packs = [pk, FlatPack(progs[1].init(torch.Generator().manual_seed(0)))]
    ref_packs = [ref_pk, _ref_pack(ref_progs[1])]
    spec, ref_spec = DistillSpec(steps=kd_steps, batch=kd_batch), RefDistillSpec(steps=kd_steps, batch=kd_batch)
    mats = tuple(torch.zeros((n_edges, p.dim)) for p in packs)
    j_mats = tuple(jnp.zeros((n_edges, p.dim)) for p in packs)
    kx = torch.zeros((kd_steps, n_edges, kd_batch, *feat))
    j_kx = jnp.zeros((kd_steps, n_edges, kd_batch, *feat))
    specs, ref_specs = tuple(p.spec for p in packs), tuple(p.spec for p in ref_packs)
    out["kd_targets"] = (
        tel.jit_cost("kd_targets", distill._kd_targets_all, mats, kx, progs, specs, spec),
        ref.jit_cost("kd_targets", ref_distill._kd_targets_all, j_mats, j_kx, ref_progs, ref_specs, ref_spec),
    )
    targets = torch.zeros((kd_steps, n_edges, kd_batch, prog.n_classes))
    j_targets = jnp.zeros((kd_steps, n_edges, kd_batch, prog.n_classes))
    out["kd_fuse_one"] = (
        tel.jit_cost("kd_fuse_one", distill._distill_fuse_one, mats[0], kx, targets, prog, specs[0], spec),
        ref.jit_cost("kd_fuse_one", ref_distill._distill_fuse_one, j_mats[0], j_kx, j_targets, ref_prog,
                     ref_specs[0], ref_spec),
    )
    return out


def main() -> None:
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    pairs = cost_pairs()
    print(f"heartbeat full shapes, counted in {time.perf_counter() - t0:.2f}s (both packages)")
    print(f"{'key':<20}{'port flops':>18}{'reference flops':>18}{'port bytes':>16}{'reference bytes':>18}"
          f"{'bytes ratio':>13}")
    for key in KEYS:
        port, ref = pairs[key]
        ratio = port["bytes_moved"] / ref["bytes_moved"] if ref["bytes_moved"] else float("inf")
        print(f"{key:<20}{port['flops']:>18,.0f}{ref['flops']:>18,.0f}{port['bytes_moved']:>16,.0f}"
              f"{ref['bytes_moved']:>18,.0f}{ratio:>13.4g}")


if __name__ == "__main__":
    main()
