"""Rank programs of ``tests/test_torch_sharded_train.py``.

``repro_torch.distributed.run_ranks`` runs them in spawned processes joined
in one gloo group; they import no JAX and nothing of the reference package.
Every rank draws the same parameters (a seeded ``torch.Generator``) and
batches (a seeded numpy generator), so the parent can run the unsharded
step on the same inputs.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.training import adam, gather_train_state, init_train_state, make_train_step, sgd, shard_train_state
from repro_torch.utils.tree import tree_leaves

# dbrx: the MoE smoke config, at 64 tokens a batch its dense dispatch, the
# router's load-balance loss formed from the whole batch's token means
ARCHS = ("phi3-mini-3.8b", "qwen3-14b", "dbrx-132b")
MODES = ("tp", "fsdp")
ACCUMS = (1, 2)
STEPS = 2
# the functional optimizer path: sgd's velocity, which the specs replicate
# as the reference's do, against the parameters' shards
SGD_CASE = ("qwen3-14b", "fsdp", 2)


def batches(cfg, n=STEPS, b=4, s=16, seed=0):
    """The train test's batches: next-token pairs of uniform tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s + 1)))
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def params_of(cfg):
    return init_params(torch.Generator().manual_seed(0), cfg)


# the dry run's learning rate (``launch.dryrun_lib.optimizer_for``): at 1e-3
# Adam's first step turns the ~1e-9 reorderings of a data-parallel gradient
# sum on near-zero gradients (|g| ~ eps) into parameter moves of ~1.6e-4
LR = 1e-4


def grads(cfg, params, batch, mesh=None):
    """The gradients (whole tensors) of ``batch`` at ``params``, whole
    tensors or DTensors on ``mesh``."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.axes import kind_spec, sharding_hints
    from repro_torch.distributed.sharding import to_placements
    from repro_torch.training.train_step import _value_and_grad, make_loss_fn

    if mesh is None:
        return [g.clone() for g in tree_leaves(_value_and_grad(make_loss_fn(cfg), params, batch)[1])]
    with sharding_hints(mesh), implicit_replication():
        batch = {k: distribute_tensor(v, mesh, to_placements(kind_spec(tuple(v.shape), "batch"), mesh),
                                      src_data_rank=None) for k, v in batch.items()}
        g = _value_and_grad(make_loss_fn(cfg), params, batch)[1]
        return [x.full_tensor().clone() for x in tree_leaves(g)]


def train(arch, mode, accum, mesh=None, optimizer="adam"):
    """(metrics per step as floats, parameters after the steps, each
    step's gradients at the parameters it starts from) of the step on
    ``mesh`` (sharded by ``param_specs(mode)``) or unsharded."""
    from repro_torch.distributed.sharding import param_specs

    cfg = get_smoke_config(arch)
    params = params_of(cfg)
    opt = adam(LR) if optimizer == "adam" else sgd(0.01, momentum=0.9)
    state = init_train_state(params, opt)
    if mesh is None:
        step = make_train_step(cfg, opt, grad_accum=accum)
    else:
        spec = param_specs(cfg, params, mode, mesh)
        state = shard_train_state(state, spec, mesh)
        step = make_train_step(cfg, opt, grad_accum=accum, param_pspec=spec)
    metrics, step_grads = [], []
    for b in batches(cfg):
        step_grads.append(grads(cfg, state.params, b, mesh))
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    if mesh is not None:
        state = gather_train_state(state)
    return metrics, [x.detach().clone() for x in tree_leaves(state.params)], step_grads


def data_model_mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(shape[0] * shape[1]).reshape(shape), mesh_dim_names=("data", "model"))


def train_all(shape):
    """Every (arch, mode, accum) case on a ``shape`` (data, model) mesh."""
    mesh = data_model_mesh(shape)
    return {(a, m, g): train(a, m, g, mesh) for a in ARCHS for m in MODES for g in ACCUMS}


def serve(shape, arch="qwen3-14b", n_decode=2):
    """prefill and ``n_decode`` decode steps of the smoke config with
    parameters and cache as DTensors on a ``shape`` mesh (the cache laid
    out by ``cache_specs``: the sequence over the model axis), against the
    same steps on whole tensors: the largest logit difference."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.axes import sharding_hints
    from repro_torch.distributed.sharding import batch_spec, cache_specs, param_specs, to_placements
    from repro_torch.models import decode_step
    from repro_torch.models.config import InputShape
    from repro_torch.models.transformer import prefill
    from repro_torch.training.train_step import _spec_leaves
    from repro_torch.utils.tree import tree_map, tree_paths, tree_unflatten

    mesh = data_model_mesh(shape)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = params_of(cfg)
    b, s, max_seq = 4, 8, 16
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)))
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (n_decode, b, 1)))

    def lay(tree, specs):
        paths = tree_paths(tree)
        return tree_unflatten(paths, [distribute_tensor(x, mesh, to_placements(sp, mesh), src_data_rank=None)
                                      for x, sp in zip(tree_leaves(tree), _spec_leaves(specs, paths))])

    with torch.no_grad():
        want, cache = prefill(params, cfg, prompt, max_seq=max_seq)
        wants = [want]
        for i in range(n_decode):
            logits, cache = decode_step(params, cfg, nxt[i], cache, torch.full((b,), s + i))
            wants.append(logits)
        shp = InputShape("t", max_seq, b, "decode")
        with sharding_hints(mesh), implicit_replication():
            dparams = lay(params, param_specs(cfg, params, "fsdp", mesh))
            rows = to_placements(batch_spec(shp, mesh), mesh)
            got, dcache = prefill(dparams, cfg, distribute_tensor(prompt, mesh, rows, src_data_rank=None),
                                  max_seq=max_seq)
            whole = tree_map(lambda x: x.full_tensor(), dcache)
            dcache = lay(whole, cache_specs(cfg, whole, shp, mesh))
            gots = [got.full_tensor()]
            for i in range(n_decode):
                tok = distribute_tensor(nxt[i], mesh, rows, src_data_rank=None)
                pos = distribute_tensor(torch.full((b,), s + i), mesh, to_placements(("data",), mesh), src_data_rank=None)
                logits, dcache = decode_step(dparams, cfg, tok, dcache, pos)
                gots.append(logits.full_tensor())
    return max(float((w - g).abs().max()) for w, g in zip(wants, gots))


def hfl(n_edges=None):
    """``make_hfl_train_step`` (local, local, sync) on an edge mesh of the
    group's ranks, from the rank's replicas as plain tensors and as
    DTensors built with ``from_local`` on ``hfl_param_specs``' placements:
    (whether the two runs are bit-equal, the DTensor run's full state)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import edge_mesh, hfl_param_specs, init_hfl_state, make_hfl_train_step
    from repro_torch.distributed.sharding import param_specs, to_placements
    from repro_torch.training.train_step import TrainState, _spec_leaves
    from repro_torch.utils.tree import tree_map, tree_paths, tree_unflatten

    cfg = get_smoke_config("phi3-mini-3.8b")
    k = dist.get_world_size()
    n_edges = n_edges or k
    mesh = edge_mesh(k, device="cpu")
    opt = adam(1e-3)
    params = params_of(cfg)
    specs = hfl_param_specs(param_specs(cfg, params, "tp", mesh))
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, n_edges, 2, 9)))
    e_local, r = n_edges // k, dist.get_rank()
    steps = [make_hfl_train_step(cfg, opt, sync=s, mesh=mesh) for s in (False, False, True)]

    def run(state):
        for i, step in enumerate(steps):
            t = toks[i, r * e_local:(r + 1) * e_local]
            state, _ = step(state, {"tokens": t[..., :-1], "labels": t[..., 1:]})
        return state

    plain = run(init_hfl_state(params, opt, n_edges, mesh=mesh))
    local = init_hfl_state(params, opt, n_edges, mesh=mesh)

    def wrap(tree):
        paths = tree_paths(tree)
        return tree_unflatten(paths, [
            DTensor.from_local(x, mesh, to_placements(sp, mesh), run_check=False)
            for x, sp in zip(tree_leaves(tree), _spec_leaves(specs, paths))])

    dstate = run(TrainState(wrap(local.params), tuple(wrap(o) for o in local.opt_state), 0))
    same = all(torch.equal(a.to_local(), b) for a, b in zip(tree_leaves(dstate.params), tree_leaves(plain.params)))
    return same, [x.full_tensor().clone() for x in tree_leaves(dstate.params)]


def group_main(shape):
    """Everything a group of ``shape[0] * shape[1]`` ranks checks."""
    return {"train": train_all(shape), "sgd": train(*SGD_CASE, data_model_mesh(shape), optimizer="sgd"),
            "serve": max(serve(shape, a) for a in ("qwen3-14b", "dbrx-132b")), "hfl": hfl()}
