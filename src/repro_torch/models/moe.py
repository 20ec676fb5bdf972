"""Mixture-of-Experts layer: top-k softmax router + SwiGLU experts.

The port of ``src/repro/models/moe.py``.  Three dispatches of one layer:

  * :func:`moe_mlp`, the dense dispatch: every token's hidden state meets
    every expert, and a (T, E) combine matrix that is zero outside the
    top k weighs the expert outputs.  Shapes are static, so it runs under
    ``torch.func.vmap`` with autograd (the federated MoE cohort);
  * :func:`moe_mlp_grouped`, GShard's capacity dispatch (tokens in groups,
    at most C tokens per expert and group, overflow dropped), which the
    transformer's full-sequence layers take from 4096 tokens a call
    (``decode_step`` never does);
  * :func:`moe_mlp_sparse`, which gathers only the chosen experts' weights
    per token; no model path calls it.

:func:`moe_mlp_serve` is the dense dispatch of the serving functions
(``transformer.prefill`` and ``decode_step``): its combine matrix comes from
the ``topk_gating`` kernel, which equals :func:`router_topk`'s combine
(``tests/test_torch_moe.py``), and it returns no router losses, which the
reference discards there.

Where the reference differs from PyTorch's idiom:

  * ``lax.top_k`` picks the lowest index among equal values; ``torch.topk``
    promises no order for ties, so :func:`_top_k` takes the first k of a
    stable descending sort;
  * every one-hot is a comparison with ``arange`` (``F.one_hot`` reads its
    range back to the host, which ``torch.func.vmap`` refuses, and raises
    on an index out of range, where ``jax.nn.one_hot`` gives zeros: the
    capacity dispatch relies on that for overflowing tokens);
  * the reference's ``preferred_element_type=f32`` on bf16 operands is a
    product with an fp32 output on the card (``torch.bmm(..., out_dtype=)``)
    and an upcast on the CPU, which lacks that product, and under
    autograd, where that product has no derivative;
  * the reference's sharding hints (``constrain`` on the dispatch and
    expert tensors) have no counterpart here: on DTensors the block runs
    on each rank's tokens and experts (:func:`moe_ffn`).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.axes import is_dtensor
from repro_torch.kernels.topk_gating import topk_gating
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import _normal, dense, dense_init


def moe_init(gen: torch.Generator, cfg: ModelConfig):
    """The router (fp32 whatever the model's dtype) and three (E, d_in,
    d_out) expert stacks, each expert scaled as ``dense_init``."""
    assert cfg.moe is not None
    dt, e, d_ff = cfg.param_dtype, cfg.moe.n_experts, cfg.d_ff

    def expert_stack(d_in, d_out):
        return _normal(gen, (e, d_in, d_out), 1.0 / np.sqrt(d_in), dt)

    return {
        "router": dense_init(gen, cfg.d_model, e, torch.float32),
        "wi": expert_stack(cfg.d_model, d_ff),
        "wg": expert_stack(cfg.d_model, d_ff),
        "wo": expert_stack(d_ff, cfg.d_model),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: zeros for an index outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values descending, the lower index
    first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _bmm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over b's leading expert axis (a (T, K) is shared by every
    expert), accumulated and returned in fp32."""
    if a.dtype == b.dtype == torch.float32:
        return torch.matmul(a, b)
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.is_cuda and a.dtype == b.dtype and not grad:  # the fp32-output product has no derivative
        if a.dim() == 2:
            a = a.expand(b.shape[0], *a.shape)
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _switch_loss(frac: torch.Tensor, mean_prob: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss: E * sum_e (fraction_tokens_e * mean_prob_e)."""
    return frac.shape[-1] * (frac * mean_prob).sum(dim=-1)


def router_topk(logits: torch.Tensor, top_k: int, *, sums: bool = False):
    """Return (combine_weights (T, E), aux_loss, z_loss) for router logits
    (T, E).  ``sums``: (combine, (routed, probs, lse2)), the loss terms'
    token sums ((E,), (E,), ()), from which a caller holding part of the
    batch forms the whole batch's losses (:func:`moe_ffn`)."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_vals, top_idx = _top_k(probs, top_k)
    # renormalize the selected experts' probabilities (DBRX/Mixtral convention)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    one_hot = _one_hot(top_idx, probs.shape[-1], probs.dtype)  # (T, K, E)
    combine = torch.einsum("tk,tke->te", top_vals, one_hot)
    routed = one_hot.sum(dim=1)  # (T, E) picks per token (incl. multi-k)
    lse2 = torch.logsumexp(logits.float(), dim=-1).square()
    if sums:
        return combine, (routed.sum(dim=0), probs.sum(dim=0), lse2.sum())
    return combine, _switch_loss(routed.mean(dim=0), probs.mean(dim=0)), lse2.mean()


def _dense_experts(p, xt: torch.Tensor, combine: torch.Tensor, experts=None) -> torch.Tensor:
    """Every token through every expert, weighed by ``combine`` (T, E):
    (T, d) in, (T, d) fp32 out.  The expert products stay (E, T, ...).
    ``experts`` (a slice) names the experts the stacks hold, when they
    hold a model rank's share of them."""
    if experts is not None:
        combine = combine[:, experts]
    hi = _bmm32(xt, p["wi"])  # (E, T, F)
    hg = _bmm32(xt, p["wg"])
    h = (F.silu(hi) * hg).to(xt.dtype)
    out_e = _bmm32(h, p["wo"])  # (E, T, d)
    return torch.einsum("etd,te->td", out_e, combine.float())


def moe_mlp(p, cfg: ModelConfig, x, *, experts=None, sums: bool = False):
    """x: (B, S, d) -> (out, aux_loss, z_loss); with ``sums``, (out,
    (routed, probs, lse2)), the router's token sums (:func:`router_topk`)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = dense(p["router"], xt.float())
    combine, *losses = router_topk(logits, cfg.moe.top_k, sums=sums)  # (T, E)
    return (_dense_experts(p, xt, combine, experts).to(x.dtype).reshape(b, s, d), *losses)


def moe_ffn(p, cfg: ModelConfig, x, *, grouped: bool):
    """The training layers' MoE block: :func:`moe_mlp_grouped` (capacity
    dispatch) or :func:`moe_mlp` (dense dispatch): (out, aux, z).  On
    DTensors it runs expert- or ff-parallel over the model axis
    (:func:`moe_sharded`), and the router losses are those of the whole
    batch, formed from the ranks' summed terms: the dense dispatch's
    load-balance loss is a product of two token means, the capacity
    dispatch's a mean over its groups, whose rows the ranks split."""
    if not is_dtensor(x):
        return (moe_mlp_grouped if grouped else moe_mlp)(p, cfg, x)
    b, s = x.shape[:2]
    if grouped:
        g, tg = group_shape(b, s)
        out, aux, lse2 = moe_sharded(functools.partial(moe_mlp_grouped, group=tg, sums=True), p, cfg, x)
        return out, aux / g, lse2 / (b * s)
    out, routed, probs, lse2 = moe_sharded(functools.partial(moe_mlp, sums=True), p, cfg, x)
    t = b * s
    return out, _switch_loss(routed / t, probs / t), lse2 / t


def moe_sharded(fn, p, cfg: ModelConfig, x):
    """``fn`` (a dispatch taking ``experts=``: a serving one returns the
    output alone, a training one given ``sums`` the output and its
    router's summed loss terms) on each rank's tokens (its batch rows) and
    its part of the experts: the whole bank of experts when the model axis
    divides E, else its slice of every expert's ff dim (the sharding
    rules' two layouts, the weights gathered over the batch axes).  Each
    model rank's output is its experts' (or ff slice's) part of the sum,
    reduced by the next layer.  The router runs whole on every rank, and
    the loss terms come out summed over the batch shards."""
    from repro_torch.distributed.axes import Summed, Whole, current_hints, kind_spec, on_shards
    from repro_torch.distributed.sharding import P

    h = current_hints()
    m, ms = h.model_axis, h.model_size
    e, f = cfg.moe.n_experts, cfg.d_ff
    by_expert = e % ms == 0 and e >= ms
    by_ff = not by_expert and f % ms == 0 and f >= ms
    if by_expert:
        w_in = w_out = P(m, None, None)
    else:
        w_in, w_out = (P(None, None, m), P(None, m, None)) if by_ff else (P(None, None, None),) * 2
    parted = (by_expert or by_ff) and ms > 1
    model = (m,) if parted else ()
    batch = tuple(h.batch_axes or ())
    rows = kind_spec(tuple(x.shape), "batch")
    summed = (batch if rows[0] is not None else ()) + model  # the model ranks' terms are the same: 1/ms each
    lo = e // ms * x.device_mesh.get_local_rank(m) if by_expert else 0
    experts = slice(lo, lo + e // ms) if by_expert else None
    router = p["router"]
    names = sorted(router)

    def local(xl, wi, wg, wo, *rw):
        q = {"router": dict(zip(names, rw)), "wi": wi, "wg": wg, "wo": wo}
        out = fn(q, cfg, xl, experts=experts)
        if not isinstance(out, tuple):  # a serving dispatch: no router losses
            return out
        out, terms = out
        return (out,) + tuple(t / ms if parted else t for t in terms)

    def out_specs(outs):
        return (Summed(rows) if parted else rows,) + tuple(Summed(P(*([None] * t.dim())), summed) for t in outs[1:])

    args = (x, p["wi"], p["wg"], p["wo"]) + tuple(router[k] for k in names)
    specs = (Whole(rows, model), Whole(w_in), Whole(w_in), Whole(w_out)) + tuple(
        Whole(P(*([None] * router[k].dim())), batch + model) for k in names)
    return on_shards(local, args, specs, out_specs)


def moe_mlp_serve(p, cfg: ModelConfig, x, *, experts=None):
    """:func:`moe_mlp`'s output with the combine matrix from the
    ``topk_gating`` kernel (one launch on the card): x (B, S, d) -> out.
    For the serving functions only, which take no gradient and map
    nothing: the kernel defines neither."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = dense(p["router"], xt.float())
    combine = topk_gating(logits, cfg.moe.top_k)
    return _dense_experts(p, xt, combine, experts).to(x.dtype).reshape(b, s, d)


GROUP_SIZE = 8192


def group_shape(b: int, s: int, group_size: int = GROUP_SIZE) -> Tuple[int, int]:
    """(groups, tokens a group) of the capacity dispatch of a (b, s) batch:
    a group is a batch row up to 2 * ``group_size`` tokens, else the
    flattened tokens in the fewest equal groups of <= ``group_size``."""
    if s <= 2 * group_size:
        return b, s
    t = b * s
    g = max(1, -(-t // group_size))  # ceil
    while t % g:
        g += 1
    return g, t // g


def moe_mlp_grouped(p, cfg: ModelConfig, x, *, capacity_factor: float = 1.25, group_size: int = GROUP_SIZE,
                    experts=None, group=None, sums: bool = False):
    """GShard-style grouped capacity dispatch — the production training path.

    Tokens are split into groups of <= ``group_size``; within each group
    every expert accepts at most C = ceil(group * top_k * capacity_factor /
    E) tokens (overflow dropped, standard practice).  Dispatch and combine
    are (g, T_g, E, C) tensors.  The reference's three-operand combine
    einsum is the elementwise product over (T_g, k, E) followed by one
    batched product over k, so no (g, T_g, k, E, C) tensor is formed.

    ``experts`` (a slice) names the experts the stacks hold, when they
    hold a model rank's share of them; ``group`` the tokens a group, when
    ``x`` is a rank's rows of a batch grouped whole (:func:`group_shape`).
    Returns (out, aux_loss, z_loss); with ``sums``, (out, (the groups'
    summed load-balance losses, the tokens' summed squared logsumexp)).
    """
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    if group is None:
        g, tg = group_shape(b, s, group_size)
    elif (b * s) % group:
        raise ValueError(f"{b * s} tokens do not split into groups of {group}")
    else:
        g, tg = b * s // group, group
    xg = x.reshape(g, tg, d)
    cap = min(int(np.ceil(tg * k * capacity_factor / e)), tg)

    logits = dense(p["router"], xg.float())  # (g, tg, E)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = _top_k(probs, k)  # (g, tg, k)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    one_hot = _one_hot(top_idx, e)  # (g, tg, k, E)
    # position of each (token, rank) within its expert queue (token-major,
    # then rank order): earlier tokens' picks + same token's earlier ranks
    per_token = one_hot.sum(dim=2)  # (g, tg, E)
    rank_off = torch.cumsum(per_token, dim=1) - per_token
    intra = torch.cumsum(one_hot, dim=2) - one_hot  # (g, tg, k, E)
    pos_sel = ((rank_off[:, :, None, :] + intra) * one_hot).sum(dim=-1)  # (g, tg, k)
    keep = pos_sel < cap  # overflow tokens dropped (standard)
    pos_oh = _one_hot(pos_sel.to(torch.int64), cap) * keep[..., None]  # (g, tg, k, C)
    # dispatch (g, tg, E, C): 1 where the token goes to (expert, slot)
    disp = torch.matmul(one_hot.transpose(-1, -2), pos_oh).to(x.dtype)
    combine = torch.matmul((top_vals[..., None] * one_hot).transpose(-1, -2), pos_oh)
    aux_e = e
    if experts is not None:  # this rank's experts only
        disp, combine = disp[:, :, experts], combine[:, :, experts]
        e = disp.shape[2]

    xe = torch.matmul(disp.reshape(g, tg, e * cap).transpose(1, 2), xg)  # (g, E*C, d)
    xe = xe.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    hi = _bmm32(xe, p["wi"])  # (E, g*C, F)
    hg = _bmm32(xe, p["wg"])
    h = (F.silu(hi) * hg).to(x.dtype)
    ye = _bmm32(h, p["wo"]).to(x.dtype)  # (E, g*C, d)
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    out = torch.matmul(combine.reshape(g, tg, e * cap), ye.float())  # (g, tg, d)

    frac = one_hot.sum(dim=2).mean(dim=1)  # (g, E)
    balance = (frac * probs.mean(dim=1)).sum(dim=-1)  # (g,)
    lse2 = torch.logsumexp(logits, dim=-1).square()
    out = out.to(x.dtype).reshape(b, s, d)
    if sums:
        return out, (aux_e * balance.sum(), lse2.sum())
    return out, aux_e * balance.mean(), lse2.mean()


def moe_mlp_sparse(p, cfg: ModelConfig, x):
    """Capacity-free *sparse* evaluation: gathers only the selected experts'
    weights per token.  O(T * k * d * f) instead of O(T * E * d * f)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = dense(p["router"], xt.float())
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = _top_k(probs, cfg.moe.top_k)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    wi, wg, wo = p["wi"][top_idx].float(), p["wg"][top_idx].float(), p["wo"][top_idx].float()  # (T, K, ., .)
    xf = xt.float()
    hi = torch.einsum("td,tkdf->tkf", xf, wi)
    hg = torch.einsum("td,tkdf->tkf", xf, wg)
    h = (F.silu(hi) * hg).to(x.dtype).float()
    out_k = torch.einsum("tkf,tkfd->tkd", h, wo)
    out = torch.einsum("tkd,tk->td", out_k, top_vals)
    return out.to(x.dtype).reshape(b, s, d)
