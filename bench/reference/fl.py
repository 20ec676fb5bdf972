"""Plain PyTorch reference of hierarchical FedAvg over a cohort of the
paper's 1-D CNN clients (arXiv:2107.06548).

A cloud round: every edge starts from the global model; each sampled
client runs one local epoch of Adam (fresh moments) on its own batches
(cross entropy, eq. 1), starting from its edge's model; each edge
averages its members' models weighted by their sample counts (eq. 6/8),
an edge without members keeping its model; the cloud averages the edge
models weighted by the edges' sample counts (eq. 9); the global model is
scored on the test set.

The convolutions are the library's ``conv1d`` ('same' padding, bias, ReLU,
then max-pool by 2), the local steps of a round's clients run together
under ``torch.func.vmap``, in float64 (``prec="fp64"``: the program's own
float32 rounding is then the only rounding its gap measures).  Nothing
of the program is imported.  ``prec="tf32"`` is the control: float32
with every product's operands rounded to TF32's 10-bit mantissa, forward
and backward (the library's own TF32 stays off, so the rounding is the
same on every device); ``fault`` plants one of the faults the comparison
must catch ("unchanged", "half_batch", "answer").
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bench.reference import fp32_products, sampling

LEAVES = ("conv1.w", "conv1.b", "conv2.w", "conv2.b", "fc1.w", "fc1.b", "fc2.w", "fc2.b")
PRECISIONS = {"fp64": torch.float64, "tf32": torch.float32}


def _round_tf32(v: torch.Tensor) -> torch.Tensor:
    """v rounded to the nearest TF32 value (10 mantissa bits)."""
    mag = torch.where(v != 0, v.abs(), torch.ones_like(v))
    e = torch.floor(torch.log2(mag))
    e = e + (mag >= torch.exp2(e + 1)).to(e.dtype) - (mag < torch.exp2(e)).to(e.dtype)  # log2's own rounding
    step = torch.exp2(e - 10)  # the spacing of 10-bit mantissas at this magnitude
    return torch.round(v / step) * step


class _TF32Grad(torch.autograd.Function):
    """Identity forward; the gradient rounded to TF32 on its way back, so
    the backward products take TF32 operands as the forward ones do."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def _tf32(x: torch.Tensor, emulate: bool) -> torch.Tensor:
    """A product's operand rounded to TF32 when ``emulate``; the gradient
    passes straight through."""
    if not emulate:
        return x
    v = x.detach()
    return x + (_round_tf32(v) - v)


def _product(y: torch.Tensor, emulate: bool) -> torch.Tensor:
    """A product's result, whose gradient (the backward products' operand)
    is rounded to TF32 when ``emulate``."""
    return _TF32Grad.apply(y) if emulate else y


def flat_params(tree: dict, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{"conv1.w": ...} copies of a {"conv1": {"w": ...}} tree."""
    return {f"{a}.{b}": tree[a][b].detach().to(dtype).clone() for a in ("conv1", "conv2", "fc1", "fc2")
            for b in ("w", "b")}


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, emulate: bool = False) -> torch.Tensor:
    """x: (B, L, Cin) -> logits (B, classes); ``emulate`` rounds every
    product's operands to TF32."""
    def conv(h, w, b):  # h (B, Cin, L); w (K, Cin, Cout)
        k = w.shape[0]
        h = F.pad(h, ((k - 1) // 2, k - 1 - (k - 1) // 2))
        return _product(F.conv1d(_tf32(h, emulate), _tf32(w.permute(2, 1, 0), emulate)), emulate) + b[:, None]

    def dense(h, w, b):
        return _product(_tf32(h, emulate) @ _tf32(w, emulate), emulate) + b

    h = x.transpose(1, 2)
    h = F.max_pool1d(torch.relu(conv(h, p["conv1.w"], p["conv1.b"])), 2)
    h = F.max_pool1d(torch.relu(conv(h, p["conv2.w"], p["conv2.b"])), 2)
    h = h.transpose(1, 2).reshape(h.shape[0], -1)  # (B, L/4 * C2), length-major as the layout
    h = torch.relu(dense(h, p["fc1.w"], p["fc1.b"]))
    return dense(h, p["fc2.w"], p["fc2.b"])


def accuracy(p, x: torch.Tensor, y: torch.Tensor, emulate: bool = False, chunk: int = 4096) -> float:
    hits = 0
    with torch.no_grad():
        for i in range(0, len(y), chunk):
            hits += int((forward(p, x[i:i + chunk], emulate).argmax(-1) == y[i:i + chunk]).sum())
    return hits / len(y)


def adam_steps(p0: Dict[str, torch.Tensor], xb, yb, lr: float, b1=0.9, b2=0.999, eps=1e-8, fault=None,
               emulate: bool = False):
    """C clients' local epochs at once: p0 leaves (C, ...), xb (C, S, B, L,
    Cin), yb (C, S, B).  Returns the trained leaves and each client's mean
    loss over its steps."""
    def loss_fn(p, x, y):
        return F.cross_entropy(forward(p, x, emulate), y)

    grad_value = torch.func.vmap(torch.func.grad_and_value(loss_fn))
    p = {k: v.clone() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses = []
    for s in range(xb.shape[1]):
        x, y = xb[:, s], yb[:, s]
        if fault == "half_batch":
            x, y = x[:, : x.shape[1] // 2], y[:, : y.shape[1] // 2]
        g, loss = grad_value(p, x, y)
        losses.append(loss)
        if fault == "unchanged":
            continue
        t = s + 1
        for k in p:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
            mh = m[k] / (1 - b1 ** t)
            vh = v2[k] / (1 - b2 ** t)
            p[k] = p[k] - lr * mh / (torch.sqrt(vh) + eps)
    return p, torch.stack(losses).mean(dim=0)


def run_rounds(pop, test, init: dict, *, cohort_seeds: List[int], cohort_size: int, engine_seed: int,
               n_edges: int, batch: int, lr: float, max_steps: int = 128, device="cpu", fault: Optional[str] = None,
               prec: str = "fp64") -> List[dict]:
    """The first rounds of the cell, one per entry of ``cohort_seeds``:
    per round its mean local loss, test accuracy and global model."""
    dev = torch.device(device)
    dt = PRECISIONS[prec]
    g = {k: v.to(dev) for k, v in flat_params(init, dt).items()}
    sizes = pop.sizes.astype(np.int64)
    edge_of = pop.edge_of.astype(np.int64)
    edge_w = torch.as_tensor(np.bincount(edge_of, weights=sizes, minlength=n_edges), dtype=dt, device=dev)
    xt = torch.as_tensor(test[0], device=dev, dtype=dt)
    yt = torch.as_tensor(test[1], device=dev).long()
    rng = np.random.default_rng(engine_seed)
    emulate = prec == "tf32"
    out = []
    with fp32_products():
        for spec_seed in cohort_seeds:
            members = sampling.cohort(spec_seed, cohort_size, len(sizes))
            steps = sampling.local_steps(sizes[members], batch, max_steps)
            idx = {int(c): sampling.batch_indices(rng, int(sizes[c]), int(s), batch)
                   for c, s in zip(members, steps)}
            order, rows, losses = [], {k: [] for k in g}, []
            for s in sorted(set(steps.tolist())):
                group = members[steps == s]
                xs = np.stack([pop.shard(int(c))[0][idx[int(c)]] for c in group])
                ys = np.stack([pop.shard(int(c))[1][idx[int(c)]] for c in group])
                p0 = {k: v[None].expand((len(group),) + tuple(v.shape)) for k, v in g.items()}
                xb = torch.as_tensor(xs, device=dev, dtype=dt)
                p, loss = adam_steps(p0, xb, torch.as_tensor(ys, device=dev).long(), lr, fault=fault, emulate=emulate)
                order.append(group)
                losses.append(loss)
                for k in g:
                    rows[k].append(p[k])
            order = np.concatenate(order)
            seg = torch.as_tensor(edge_of[order], device=dev)
            n = torch.as_tensor(sizes[order], dtype=dt, device=dev)
            edge_n = torch.zeros(n_edges, device=dev, dtype=dt).index_add_(0, seg, n)
            wn = n / edge_n[seg]
            has = edge_n > 0
            we = edge_w / edge_w.sum()
            new_g = {}
            for k in g:
                trained = torch.cat(rows[k])
                edge = torch.zeros((n_edges,) + tuple(g[k].shape), device=dev, dtype=dt)
                edge.index_add_(0, seg, trained * wn.reshape((-1,) + (1,) * g[k].dim()))
                edge = torch.where(has.reshape((-1,) + (1,) * g[k].dim()), edge, g[k][None])
                new_g[k] = torch.tensordot(we, edge, dims=1)
            g = new_g
            mean_loss = float(torch.cat(losses).mean())
            acc = accuracy(g, xt, yt, emulate)
            if fault == "answer":
                acc = acc + 0.01
            out.append({"loss": mean_loss, "acc": acc, "params": {k: v.detach().clone() for k, v in g.items()}})
    return out


def change_norms(params: Dict[str, torch.Tensor], init: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm((params[k].double() - init[k].double()))) for k in LEAVES}
