"""Train and serve step builders for the sequence models.

The port of ``src/repro/training/train_step.py``.  ``make_train_step``
builds a ``(state, batch) -> (state, metrics)`` function for any
``ModelConfig`` (the LM next-token objective plus the MoE auxiliary
losses); ``make_grad_step`` the gradient alone; ``make_serve_step`` the
single-token decode step.

Where the reference differentiates a pure function with ``jax.grad``, the
port runs eager autograd over detached views of the parameter leaves (the
caller's tensors never require grad, so nothing downstream, a serving
call say, sees a graph).  The optimizer then writes into the parameters'
own storage: ``train_step`` returns a state that holds the same tensors as
the one it was given, advanced (``Optimizer.update_``, bit-identical to
the functional ``update``; an optimizer without it, ``sgd``, takes the
functional form).  Clipping scales the gradients in place.  Those two are
what let phi3-mini-3.8b's step fit one 80 GB card.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import decode_step, forward_hidden
from repro_torch.training.loss import chunked_lm_loss
from repro_torch.training.optimizers import Optimizer, clip_by_global_norm_
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def init_train_state(params, optimizer: Optimizer) -> TrainState:
    return TrainState(params, optimizer.init(params), 0)


def make_loss_fn(cfg: ModelConfig, *, aux_weight: float = 0.01, z_weight: float = 1e-3, loss_chunk: int = 512):
    """LM loss with the unembed chunked over the sequence (never the whole
    (B, S, V) logits): ``loss_fn(params, batch) -> (total, metrics)``."""

    def loss_fn(params, batch: Dict[str, torch.Tensor]):
        hidden, aux = forward_hidden(params, cfg, batch["tokens"], enc_embeds=batch.get("enc_embeds"))
        head = params.get("lm_head", params["embed"])
        lm = chunked_lm_loss(hidden, head["emb"], batch["labels"], chunk=loss_chunk)
        total = lm + aux_weight * aux["moe_aux"] + z_weight * aux["moe_z"]
        return total, {"lm_loss": lm, "moe_aux": aux["moe_aux"], "moe_z": aux["moe_z"]}

    return loss_fn


def _with_remat(cfg: ModelConfig, remat: bool) -> ModelConfig:
    return dataclasses.replace(cfg, remat=True) if remat and not cfg.remat else cfg


# the tree keys whose leaves stack layers on their first axis
_STACKED = ("blocks", "enc_blocks")


class _Layers:
    """A stacked leaf given to the model as its layers' own tensors:
    ``[l]`` is layer l, what the stack's per-layer views take."""

    def __init__(self, layers, shape):
        self.layers, self.shape = layers, shape

    def __getitem__(self, l):
        return self.layers[l]


def _value_and_grad(loss_fn, params, batch):
    """((total, metrics), grads): autograd over detached views of the
    leaves, grads in the leaves' tree and dtypes; the metrics detached.

    A stacked leaf goes in as one leaf per layer whose ``.grad`` is a view
    of a zeroed (n_layers, ...) buffer, so the backward accumulates each
    layer's gradient into its slice in place.  Differentiating the stacked
    leaf itself would rebuild a whole zeroed stack and add it up once per
    layer (the backward of ``stack[l]``): 40% of phi3-mini's step on the
    card."""
    paths = tree_paths(params)
    inputs, grads = [], []
    for path, p in zip(paths, tree_leaves(params)):
        p = p.detach()
        if path[0] in _STACKED:
            g = torch.zeros_like(p)
            layers = [p[l].requires_grad_(True) for l in range(p.shape[0])]
            for x, gl in zip(layers, g):
                x.grad = gl
            inputs.append(_Layers(layers, p.shape))
            grads.append(g)
        else:
            inputs.append(p.requires_grad_(True))
            grads.append(None)
    with torch.enable_grad():
        total, metrics = loss_fn(tree_unflatten(paths, inputs), batch)
        total.backward()
    for i, (x, g) in enumerate(zip(inputs, grads)):
        if g is None:
            grads[i] = torch.zeros_like(x) if x.grad is None else x.grad
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), tree_unflatten(paths, grads)


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    grad_clip: float = 1.0,
    remat: bool = False,
    grad_accum: int = 1,
    param_pspec=None,
):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    * remat: per-layer activation recomputation (``cfg.remat``:
      ``torch.utils.checkpoint`` around each layer of the stack);
    * grad_accum: the batch is split into ``grad_accum`` microbatches of
      consecutive rows run one after another, their gradients summed in
      fp32 and divided by ``grad_accum``, their metrics averaged;
    * param_pspec: a PartitionSpec tree matching the parameters
      (``distributed.sharding.param_specs``): the sharded step.  The
      state's leaves are then DTensors laid out by ``to_placements`` of
      the specs (:func:`shard_train_state`), the step computes on them
      through DTensor under ``sharding_hints`` of their mesh, each
      microbatch's gradients are redistributed to the specs' placements
      before they are summed (the reference constrains them there), and
      the optimizer updates each rank's local shards.  The batch's leaves
      are DTensors, or whole tensors every rank holds; each (micro)batch
      is laid out over the batch axes.  An operation DTensor cannot shard
      raises: the step never gathers whole parameters to go on.

    The metrics (``lm_loss``, ``moe_aux``, ``moe_z``, ``total_loss``,
    ``grad_norm``) are 0-d tensors on the parameters' device; nothing is
    read back to the host.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    loss_fn = make_loss_fn(_with_remat(cfg, remat))

    def grads_of(params, batch, lay):
        if grad_accum == 1:
            (total, metrics), grads = _value_and_grad(loss_fn, params, {k: lay.rows(v) for k, v in batch.items()})
            return (total, metrics), lay.grads(grads)
        batch = {k: lay.whole(v) for k, v in batch.items()}  # a microbatch is rows of the whole batch
        b = batch["tokens"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} is not a multiple of grad_accum {grad_accum}")
        size = b // grad_accum
        gacc = total = metrics = None
        for i in range(grad_accum):
            micro = {k: lay.rows(v[i * size:(i + 1) * size]) for k, v in batch.items()}
            (t, m), g = _value_and_grad(loss_fn, params, micro)
            g = lay.grads(g)
            if gacc is None:
                gacc, total, metrics = tree_map(lambda x: x.float(), g), t, {k: [v] for k, v in m.items()}
                continue
            gacc = tree_map(lambda a, x: a + x.float(), gacc, g)
            total = total + t
            for k, v in m.items():
                metrics[k].append(v)
        grads = tree_map(lambda a: a / grad_accum, gacc)
        return (total / grad_accum, {k: torch.stack(v).mean() for k, v in metrics.items()}), grads

    def train_step(state: TrainState, batch):
        lay = _Whole() if param_pspec is None else _Sharded(state.params, param_pspec)
        with lay.context():
            (total, metrics), grads = grads_of(state.params, batch, lay)
            gnorm = clip_by_global_norm_(grads, grad_clip)
            params, opt_state = state.params, state.opt_state
            if optimizer.update_ is not None:  # elementwise: each rank's shards, in place
                optimizer.update_(lay.local(params), lay.local(grads), lay.local(opt_state), state.step)
            else:  # the functional form, on the layout's own tensors
                with torch.no_grad():
                    params, opt_state = optimizer.update(state.params, grads, state.opt_state, state.step)
                params, opt_state = lay.like(params, state.params), lay.like(opt_state, state.opt_state)
            metrics = {k: lay.whole(v) for k, v in dict(metrics, total_loss=total, grad_norm=gnorm).items()}
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


class _Whole:
    """The unsharded step's layout: whole tensors, every hook the identity."""

    def context(self):
        return contextlib.nullcontext()

    def rows(self, x):
        return x

    def grads(self, grads):
        return grads

    def local(self, tree):
        return tree

    def like(self, tree, ref):
        return tree

    def whole(self, x):
        return x


class _Sharded:
    """The sharded step's layout of DTensor ``params`` (specs
    ``param_pspec``) on their mesh: a batch leaf over the batch axes, each
    gradient at its parameter's placements, the optimizer on each rank's
    local shards."""

    def __init__(self, params, param_pspec):
        from repro_torch.distributed.axes import is_dtensor
        from repro_torch.distributed.sharding import to_placements

        leaves = tree_leaves(params)
        if not all(is_dtensor(x) for x in leaves):
            raise ValueError("the sharded step takes DTensor parameters: lay the state out with shard_train_state")
        self.mesh = leaves[0].device_mesh
        self.paths = tree_paths(params)
        self.placements = [tuple(to_placements(sp, self.mesh)) for sp in _spec_leaves(param_pspec, self.paths)]

    def context(self):
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.distributed.axes import sharding_hints

        stack = contextlib.ExitStack()
        stack.enter_context(sharding_hints(self.mesh))
        stack.enter_context(implicit_replication())
        return stack

    def rows(self, x):
        """``x`` laid out over the batch axes; a whole tensor (every rank
        holds the same one) is cut to this rank's rows, no collective."""
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.distributed.axes import is_dtensor, kind_spec
        from repro_torch.distributed.sharding import to_placements

        placements = tuple(to_placements(kind_spec(tuple(x.shape), "batch"), self.mesh))
        if not is_dtensor(x):
            return distribute_tensor(x, self.mesh, placements, src_data_rank=None)
        return x if tuple(x.placements) == placements else x.redistribute(self.mesh, placements)

    def grads(self, grads):
        return tree_unflatten(self.paths, [x if tuple(x.placements) == pl else x.redistribute(self.mesh, pl)
                                           for x, pl in zip(tree_leaves(grads), self.placements)])

    def local(self, tree):
        return tree_map(lambda x: x.to_local(), tree)

    def like(self, tree, ref):
        """DTensors ``tree`` laid out as ``ref``'s leaves (an optimizer
        state the specs replicate, sgd's velocity, is gathered again)."""
        return tree_map(lambda x, r: x if tuple(x.placements) == tuple(r.placements)
                        else x.redistribute(r.device_mesh, r.placements), tree, ref)

    def whole(self, x):
        return _whole(x)


def _whole(x):
    """A DTensor's whole tensor (a collective), on every rank."""
    from repro_torch.distributed.axes import is_dtensor

    return x.full_tensor() if is_dtensor(x) else x


def _spec_leaves(spec_tree, paths):
    """The PartitionSpecs of a spec tree at the parameter tree's ``paths``
    (a spec is a tuple, so the trees cannot be walked alike)."""
    out = []
    for path in paths:
        node = spec_tree
        for k in path:
            node = node[k]
        out.append(node)
    return out


def shard_train_state(state: TrainState, param_pspec, mesh) -> TrainState:
    """``state`` (whole tensors, the same on every rank) laid out on
    ``mesh`` as the sharded step takes it: every parameter leaf and Adam
    moment a DTensor placed by ``to_placements`` of its spec, each rank
    keeping only its shard (no collective); a state the specs replicate
    (sgd's velocity, as the reference's) whole on every rank."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import opt_state_specs, to_placements

    def lay(tree, specs):
        paths = tree_paths(tree)
        if not paths:  # sgd's empty state
            return tree
        return tree_unflatten(paths, [
            distribute_tensor(x, mesh, to_placements(sp, mesh), src_data_rank=None)
            for x, sp in zip(tree_leaves(tree), _spec_leaves(specs, paths))])

    ospec = opt_state_specs(param_pspec, state.opt_state, state.params)
    return TrainState(lay(state.params, param_pspec), lay(state.opt_state, ospec), state.step)


def gather_train_state(state: TrainState) -> TrainState:
    """The whole tensors of a sharded state (a collective per leaf), on
    every rank."""
    return TrainState(tree_map(_whole, state.params), tree_map(_whole, state.opt_state), state.step)


def make_grad_step(cfg: ModelConfig, *, remat: bool = False):
    """Gradient-only step for federated local updates (the optimizer is
    applied by the caller): ``grad_step(params, batch) -> (grads,
    metrics)``."""
    loss_fn = make_loss_fn(_with_remat(cfg, remat))

    def grad_step(params, batch):
        (total, metrics), grads = _value_and_grad(loss_fn, params, batch)
        return grads, dict(metrics, total_loss=total)

    return grad_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, cache, token, position) -> (logits, cache)``,
    one decode step (the cache advanced in place)."""

    def serve_step(params, cache, token, position):
        return decode_step(params, cfg, token, cache, position)

    return serve_step
