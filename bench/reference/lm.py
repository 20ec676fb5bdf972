"""Plain PyTorch reference of per-edge replicas of a dense decoder trained
by hierarchical FedAvg.

The model is phi3-mini's block (arXiv:2404.14219): token embedding;
per layer RMSNorm, causal multi-head attention with split-half rotary
position embeddings (theta 10,000), a residual, RMSNorm, a SwiGLU MLP,
a residual; a final RMSNorm and an untied output head; the loss is the
mean next-token cross entropy.  Each edge trains its own replica: the
gradient clipped by the edge's own global norm (1.0), then Adam; a sync
step ends with every replica set to the edges' weighted average (eq. 8).

Computed in float32 with TF32 off from the weights the benchmark drew;
the parameters are stored in the configuration's dtype (bf16), so each
update and each average is rounded to it, as the configuration states,
and the moments in float32.  Nothing of the program is imported.
``precision="fp8"`` runs every product's operands through float8 e4m3
with a per-tensor scale (the control); ``fault`` plants one of the faults
the comparison must catch ("unchanged", "half_batch", "answer").
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from bench.reference import fp32_products

E4M3_MAX = 448.0
ARCHITECTURES = {"Phi3ForCausalLM", "LlamaForCausalLM"}  # the block below, as config.json names it


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 at a per-tensor scale; the gradient
    passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


class Decoder:
    def __init__(self, cfg: dict, prec: str = "fp32"):
        if prec not in ("fp32", "fp8"):
            raise ValueError(prec)
        self.cfg, self.prec = cfg, prec
        self.n = cfg["num_hidden_layers"]
        self.h = cfg["num_attention_heads"]
        self.kv = cfg["num_key_value_heads"]
        self.dh = cfg["hidden_size"] // self.h
        if (cfg.get("hidden_act") != "silu" or "rms_norm_eps" not in cfg or cfg.get("rope_scaling")
                or not cfg.get("architectures") or not set(cfg["architectures"]) <= ARCHITECTURES):
            raise NotImplementedError("the reference is a bias-free SwiGLU (hidden_act silu) decoder with "
                                      f"RMSNorm and plain RoPE; {cfg.get('name')} states otherwise")
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]

    def mm(self, a, w):
        if self.prec == "fp8":
            a, w = _fp8(a), _fp8(w)
        return a @ w

    def norm(self, x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * scale

    def rope(self, x):  # (B, S, H, dh)
        s = x.shape[1]
        freqs = 1.0 / (self.theta ** (torch.arange(0, self.dh, 2, device=x.device, dtype=torch.float32) / self.dh))
        ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * freqs
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def loss(self, w: Dict[str, torch.Tensor], tokens, labels):
        b, s = tokens.shape
        x = w["embed"][tokens]
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        for l in range(self.n):
            p = lambda k: w[f"L{l}.{k}"]  # noqa: E731
            h = self.norm(x, p("norm1"))
            q = self.rope(self.mm(h, p("wq")).reshape(b, s, self.h, self.dh))
            k = self.rope(self.mm(h, p("wk")).reshape(b, s, self.kv, self.dh))
            v = self.mm(h, p("wv")).reshape(b, s, self.kv, self.dh)
            rep = self.h // self.kv
            k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
            att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.dh)
            att = torch.softmax(att.masked_fill(~mask, float("-inf")), dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, self.h * self.dh)
            x = x + self.mm(o, p("wo"))
            h = self.norm(x, p("norm2"))
            x = x + self.mm(F.silu(self.mm(h, p("wi"))) * self.mm(h, p("wg")), p("w2"))
        x = self.norm(x, w["final_norm"])
        head = w.get("lm_head", w["embed"])
        logits = self.mm(x, head.t())
        return F.cross_entropy(logits.reshape(b * s, -1), labels.reshape(-1))


def train_edges(cfg: dict, init: Dict[str, torch.Tensor], batches: List, *, lr: float, clip: float,
                sync_steps: tuple, b1=0.9, b2=0.999, eps=1e-8, prec: str = "fp32",
                store=torch.bfloat16, fault: Optional[str] = None, device="cpu") -> dict:
    """Every edge's replica through ``len(batches)`` steps from ``init``
    (float32 copies are made here); ``batches[s][e]`` is edge e's (tokens,
    labels) at step s, and after each step in ``sync_steps`` (0-based) the
    replicas become their average, the edges weighted alike (they hold
    equal tokens).

    Returns per step the mean of the edges' losses, per edge the first
    step's clipped gradient norm of every leaf, and the final replicas'
    change from ``init`` per edge and leaf.  Edges run one after another
    between syncs, each holding its replica and moments; a sync keeps
    only the running average."""
    dec = Decoder(cfg, prec)
    n_steps, n_edges = len(batches), len(batches[0])
    names = list(init)
    losses = [[0.0] * n_edges for _ in batches]
    grad1 = [dict() for _ in range(n_edges)]
    change = [None] * n_edges
    own = [None] * n_edges  # an edge's replica and moments between syncs
    ends = sorted(set(sync_steps) | {n_steps - 1})

    def change_of(params):
        return {k: float(torch.linalg.vector_norm(params[k] - init[k].to(device=device, dtype=torch.float32)))
                for k in names}

    with fp32_products():
        shared = {k: init[k].to(device=device, dtype=torch.float32) for k in names}
        first = 0
        for end in ends:
            avg = None
            for e in range(n_edges):
                if own[e] is None:
                    p = {k: shared[k].clone() for k in names}
                    m = {k: torch.zeros_like(p[k]) for k in names}
                    v = {k: torch.zeros_like(p[k]) for k in names}
                else:
                    p, m, v = own[e]
                    own[e] = None
                for s in range(first, end + 1):
                    tokens, labels = (t.to(device) for t in batches[s][e])
                    if fault == "half_batch":
                        half = tokens.shape[1] // 2
                        tokens, labels = tokens[:, :half], labels[:, :half]
                    leaves = {k: p[k].requires_grad_(True) for k in names}
                    loss = dec.loss(leaves, tokens, labels)
                    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
                    del leaves
                    losses[s][e] = float(loss.detach()) * (1.01 if fault == "answer" else 1.0)
                    with torch.no_grad():
                        g = dict(zip(names, grads))
                        del grads
                        norm = torch.sqrt(sum(torch.sum(x.square()) for x in g.values()))
                        scale = torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)
                        for k in names:
                            g[k].mul_(scale)
                        if s == 0:
                            grad1[e] = {k: float(torch.linalg.vector_norm(g[k])) for k in names}
                        t = s + 1
                        for k in names:
                            p[k] = p[k].detach()
                            if fault == "unchanged":
                                continue
                            m[k].mul_(b1).add_((1 - b1) * g[k])
                            v[k].mul_(b2).add_((1 - b2) * g[k].square())
                            upd = (m[k] / (1 - b1 ** t)) / (torch.sqrt(v[k] / (1 - b2 ** t)) + eps)
                            p[k] = (p[k] - lr * upd).to(store).to(torch.float32)
                        del g
                with torch.no_grad():
                    if end in sync_steps:
                        if avg is None:
                            avg = {k: p[k] / n_edges for k in names}
                        else:
                            for k in names:
                                avg[k].add_(p[k] / n_edges)
                        own[e] = (None, m, v) if end < n_steps - 1 else None
                    elif end < n_steps - 1:
                        own[e] = (p, m, v)
                    else:
                        change[e] = change_of(p)
                del p, m, v
            if avg is not None:
                shared = {k: x.to(store).to(torch.float32) for k, x in avg.items()}
                own = [None if o is None else ({k: shared[k].clone() for k in names}, o[1], o[2]) for o in own]
                if end == n_steps - 1:
                    change = [change_of(shared)] * n_edges
            first = end + 1
    return {"loss": [sum(ls) / n_edges for ls in losses], "grad1": grad1, "change": change}
