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
    and an upcast on the CPU, which lacks that product;
  * the reference's sharding hints (``constrain``) have no counterpart:
    they wait for the sharding half of the distributed package, ROADMAP.md
    Queue 1 item 13.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

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
    if a.is_cuda and a.dtype == b.dtype:
        if a.dim() == 2:
            a = a.expand(b.shape[0], *a.shape)
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def router_topk(logits: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (combine_weights (T, E), aux_loss, z_loss) for router logits (T, E)."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_vals, top_idx = _top_k(probs, top_k)
    # renormalize the selected experts' probabilities (DBRX/Mixtral convention)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    one_hot = _one_hot(top_idx, probs.shape[-1], probs.dtype)  # (T, K, E)
    combine = torch.einsum("tk,tke->te", top_vals, one_hot)
    # Switch load-balance loss: E * sum_e (fraction_tokens_e * mean_prob_e)
    frac = one_hot.sum(dim=1).mean(dim=0)  # (E,) fraction routed (incl. multi-k)
    aux = probs.shape[-1] * (frac * probs.mean(dim=0)).sum()
    z = torch.logsumexp(logits.float(), dim=-1).square().mean()
    return combine, aux, z


def _dense_experts(p, xt: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    """Every token through every expert, weighed by ``combine`` (T, E):
    (T, d) in, (T, d) fp32 out.  The expert products stay (E, T, ...)."""
    hi = _bmm32(xt, p["wi"])  # (E, T, F)
    hg = _bmm32(xt, p["wg"])
    h = (F.silu(hi) * hg).to(xt.dtype)
    out_e = _bmm32(h, p["wo"])  # (E, T, d)
    return torch.einsum("etd,te->td", out_e, combine.float())


def moe_mlp(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> (out, aux_loss, z_loss)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = dense(p["router"], xt.float())
    combine, aux, z = router_topk(logits, cfg.moe.top_k)  # (T, E)
    return _dense_experts(p, xt, combine).to(x.dtype).reshape(b, s, d), aux, z


def moe_mlp_serve(p, cfg: ModelConfig, x):
    """:func:`moe_mlp`'s output with the combine matrix from the
    ``topk_gating`` kernel (one launch on the card): x (B, S, d) -> out.
    For the serving functions only, which take no gradient and map
    nothing: the kernel defines neither."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = dense(p["router"], xt.float())
    combine = topk_gating(logits, cfg.moe.top_k)
    return _dense_experts(p, xt, combine).to(x.dtype).reshape(b, s, d)


def moe_mlp_grouped(p, cfg: ModelConfig, x, *, capacity_factor: float = 1.25, group_size: int = 8192):
    """GShard-style grouped capacity dispatch — the production training path.

    Tokens are split into groups of <= ``group_size``; within each group
    every expert accepts at most C = ceil(group * top_k * capacity_factor /
    E) tokens (overflow dropped, standard practice).  Dispatch and combine
    are (g, T_g, E, C) tensors.  The reference's three-operand combine
    einsum is the elementwise product over (T_g, k, E) followed by one
    batched product over k, so no (g, T_g, k, E, C) tensor is formed.

    Returns (out, aux_loss, z_loss).
    """
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    if s <= 2 * group_size:  # group == batch row
        g, tg = b, s
        xg = x
    else:
        t = b * s
        g = max(1, -(-t // group_size))  # ceil
        while t % g:
            g += 1
        tg = t // g
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

    xe = torch.matmul(disp.reshape(g, tg, e * cap).transpose(1, 2), xg)  # (g, E*C, d)
    xe = xe.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    hi = _bmm32(xe, p["wi"])  # (E, g*C, F)
    hg = _bmm32(xe, p["wg"])
    h = (F.silu(hi) * hg).to(x.dtype)
    ye = _bmm32(h, p["wo"]).to(x.dtype)  # (E, g*C, d)
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    out = torch.matmul(combine.reshape(g, tg, e * cap), ye.float())  # (g, tg, d)

    frac = one_hot.sum(dim=2).mean(dim=1)  # (g, E)
    aux = e * (frac * probs.mean(dim=1)).sum(dim=-1).mean()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return out.to(x.dtype).reshape(b, s, d), aux, z


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
