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
    * grad_accum: the batch is split into ``grad_accum`` microbatches run
      one after another, their gradients summed in fp32 and divided by
      ``grad_accum``, their metrics averaged;
    * param_pspec: the reference's sharding of the per-microbatch
      gradients, which needs the mesh (ROADMAP.md Queue 1 item 13, the
      distributed slice): given, it raises ``NotImplementedError``.

    The metrics (``lm_loss``, ``moe_aux``, ``moe_z``, ``total_loss``,
    ``grad_norm``) are 0-d tensors on the parameters' device; nothing is
    read back to the host.
    """
    if param_pspec is not None:
        raise NotImplementedError(
            "param_pspec shards gradients over a mesh, which the port does not carry yet "
            "(ROADMAP.md Queue 1 item 13, the distributed slice)"
        )
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    loss_fn = make_loss_fn(_with_remat(cfg, remat))

    def grads_of(params, batch):
        if grad_accum == 1:
            return _value_and_grad(loss_fn, params, batch)
        b = batch["tokens"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} is not a multiple of grad_accum {grad_accum}")
        size = b // grad_accum
        gacc = total = metrics = None
        for i in range(grad_accum):
            micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            (t, m), g = _value_and_grad(loss_fn, params, micro)
            if gacc is None:
                gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
                total = torch.zeros((), dtype=torch.float32, device=t.device)
                metrics = {k: [] for k in m}
            gacc = tree_map(lambda a, gg: a + gg.float(), gacc, g)
            total = total + t
            for k, v in m.items():
                metrics[k].append(v)
        grads = tree_map(lambda a: a / grad_accum, gacc)
        return (total / grad_accum, {k: torch.stack(v).mean() for k, v in metrics.items()}), grads

    def train_step(state: TrainState, batch):
        (total, metrics), grads = grads_of(state.params, batch)
        gnorm = clip_by_global_norm_(grads, grad_clip)
        if optimizer.update_ is not None:
            optimizer.update_(state.params, grads, state.opt_state, state.step)
            params, opt_state = state.params, state.opt_state
        else:
            with torch.no_grad():
                params, opt_state = optimizer.update(state.params, grads, state.opt_state, state.step)
        metrics = dict(metrics, total_loss=total, grad_norm=gnorm)
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


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
