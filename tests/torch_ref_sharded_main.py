"""The reference's sharded train step in a process of its own, on four
host devices (``XLA_FLAGS`` must be set before JAX starts):
``tests/test_torch_sharded_train.py`` runs it and holds the port's 4-rank
step to what it writes.

Every case of ``torch_shard_ranks`` (arch, mode, grad_accum) runs
``repro.training.make_train_step(param_pspec=)`` for two steps on a (2, 2)
("data", "model") mesh, its parameters those the port draws
(``torch_shard_ranks.params_of``, carried across as numpy) and its batches
the port's, under ``jax.jit`` with the state and batch laid out by the
reference's spec trees.  Writes an ``.npz`` of each case's parameters
after the steps and a ``.json`` of its metrics per step.

Usage: python torch_ref_sharded_main.py OUT_PREFIX
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch  # noqa: E402

torch.set_num_threads(1)

import torch_shard_ranks as ranks  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.distributed.axes import sharding_hints  # noqa: E402
from repro.distributed.sharding import opt_state_specs, param_specs  # noqa: E402
from repro.training import adam, make_train_step  # noqa: E402
from repro.training.train_step import TrainState  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402

CASES = [(a, m, g) for a in ranks.ARCHS for m in ranks.MODES for g in ranks.ACCUMS]


def run(mesh, arch, mode, accum):
    cfg = ref_smoke(arch)
    params = jax.tree.map(jnp.asarray, params_to_numpy(ranks.params_of(ranks.get_smoke_config(arch))))
    opt = adam(ranks.LR)
    pspec = param_specs(cfg, params, mode, mesh)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    sspec = TrainState(pspec, opt_state_specs(pspec, state.opt_state, params), P())

    def named(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree, is_leaf=lambda x: isinstance(x, P))

    step = make_train_step(cfg, opt, grad_accum=accum, param_pspec=pspec)
    metrics = []
    with mesh, sharding_hints(mesh):
        fn = jax.jit(step, in_shardings=(named(sspec), named({"tokens": P("data", None), "labels": P("data", None)})),
                     out_shardings=(named(sspec), None))
        state = jax.device_put(state, named(sspec))
        for b in ranks.batches(ranks.get_smoke_config(arch)):
            state, m = fn(state, {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [np.asarray(x, np.float32) for x in jax.tree.leaves(state.params)]


def main(prefix: str) -> None:
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    arrays, metrics = {}, {}
    for case in CASES:
        key = "|".join(map(str, case))
        metrics[key], leaves = run(mesh, *case)
        arrays.update({f"{key}|{i}": x for i, x in enumerate(leaves)})
    np.savez(prefix + ".npz", **arrays)
    with open(prefix + ".json", "w") as f:
        json.dump(metrics, f)


if __name__ == "__main__":
    main(sys.argv[1])
