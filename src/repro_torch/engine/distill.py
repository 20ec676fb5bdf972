"""Distillation aggregation: fusing heterogeneous-architecture edge models.

In a capability-skewed fleet strong EUs carry the CNN and weak ones the
MLP.  Parameter averaging across architectures is meaningless, but their
logits on shared data are comparable when the programs emit one alphabet.
Once per cloud round each edge fuses its per-architecture models by
ensemble logit distillation on a small public shard (FedMD / FedDF style):

  1. per-architecture FedAvg has already produced one edge model per
     program group (``hier_segment_aggregate`` within each group);
  2. the TEACHER is the group ensemble: the mean of every group model's
     temperature-softened distribution on a public batch, computed from
     the PRE-fuse models, so every student sees the same fixed targets;
  3. each group's STUDENT takes ``DistillSpec.steps`` plain-SGD steps
     (``p <- p - lr * grad``, not the program's Adam and not
     ``torch.optim``) on the soft cross-entropy against those targets.

Two forms of one function:

  * ``distill_edge``      — parameter trees, one edge at a time: the
                            readable simulator's (``HeteroHFLSimulation``);
  * ``distill_fuse_flat`` — every edge at once on the (E, D_g) matrices:
                            what the engines run.  The rows are independent,
                            so the gradient of the SUM of the per-edge
                            losses is each edge's own gradient; one batched
                            forward (``apply_logits_cohort``) per step.

The fuse is plain PyTorch, as the reference's is plain ``jnp``: no kernel
of the port runs under it.  With a single group the teacher would be the
student itself; the engines skip the fuse for homogeneous populations,
which keeps those runs bit-identical to the single-program pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine.flatten import unravel_batched
from repro_torch.telemetry import NULL_TELEMETRY, step_loop
from repro_torch.utils.tree import TreeSpec, tree_leaves, tree_map, tree_paths, tree_unflatten


@dataclasses.dataclass(frozen=True)
class DistillSpec:
    """Knobs of one edge-side distillation fuse.

    ``steps`` SGD steps of size ``lr`` on batches of ``batch`` public
    samples; ``temperature`` softens teacher and student alike (the loss
    carries the classic T^2 scale, so its gradient is temperature-
    invariant); ``weight`` scales the whole KD loss.
    """

    steps: int = 4
    batch: int = 16
    temperature: float = 2.0
    lr: float = 1e-3
    weight: float = 1.0

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError(f"distill steps must be >= 1, got {self.steps}")
        if self.batch < 1:
            raise ValueError(f"distill batch must be >= 1, got {self.batch}")
        if self.temperature <= 0.0:
            raise ValueError(f"temperature must be > 0, got {self.temperature}")


def draw_public_batches(rng: np.random.Generator, sizes, spec: DistillSpec) -> np.ndarray:
    """Per-edge public-shard sample indices for one fuse: one ``(steps,
    batch)`` integer draw per edge, in edge order, from the engine's own
    generator (the simulator and every engine draw it at the same point of
    the stream).  Returns an ``(E, steps, batch)`` int32 array."""
    return np.stack([rng.integers(0, int(n), (spec.steps, spec.batch)) for n in sizes]).astype(np.int32)


def soft_targets(programs: Sequence, params_list: Sequence, x, temperature: float) -> torch.Tensor:
    """The ensemble teacher's distribution on one public batch: the mean
    over groups of ``softmax(apply_logits / T)`` over the last axis."""
    probs = None
    for prog, params in zip(programs, params_list):
        p = torch.softmax(prog.apply_logits(params, x) / temperature, dim=-1)
        probs = p if probs is None else probs + p
    return probs / len(programs)


def _target_logp(logits: torch.Tensor, targets: torch.Tensor, temperature: float) -> torch.Tensor:
    """``sum(targets * log_softmax(logits / T))`` per example, over the
    last axis."""
    return (targets * torch.log_softmax(logits / temperature, dim=-1)).sum(dim=-1)


def kd_loss(program, params, x, targets, spec: DistillSpec) -> torch.Tensor:
    """Soft cross-entropy of the student against the ensemble targets,
    ``-T^2 * weight * mean(sum(targets * log_softmax(student / T)))``
    averaged over every leading axis: the KL form's gradient (the teacher
    entropy is constant in the student)."""
    ce = -_target_logp(program.apply_logits(params, x), targets, spec.temperature).mean()
    return spec.weight * spec.temperature**2 * ce


# ---------------------------------------------------------------------------
# tree form: the readable simulator's per-edge fuse
# ---------------------------------------------------------------------------
def distill_edge(programs: Sequence, params_list: Sequence, xb, spec: DistillSpec) -> Tuple[List, List[float]]:
    """Fuse one edge's per-group models on its public batches.

    ``xb`` is the edge's drawn public data, ``(steps, B, *feat)``.  Returns
    the post-fuse parameter trees (in ``programs`` order) and each group's
    mean KD loss over the steps.  The teachers are the PRE-fuse models on
    every step's batch; each student then descends on its own.
    """
    device = tree_leaves(params_list[0])[0].device
    xb = torch.as_tensor(np.asarray(xb), device=device)
    with torch.no_grad():
        targets = [soft_targets(programs, params_list, xb[s], spec.temperature) for s in range(spec.steps)]
    fused, losses = [], []
    for prog, params in zip(programs, params_list):
        p = params
        total = 0.0
        for s in range(spec.steps):
            q = tree_map(lambda t: t.detach().requires_grad_(True), p)
            loss = kd_loss(prog, q, xb[s], targets[s], spec)
            leaves = tree_leaves(q)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                p = tree_unflatten(tree_paths(q), [a - spec.lr * g for a, g in zip(leaves, grads)])
            total += float(loss.detach())
        fused.append(p)
        losses.append(total / spec.steps)
    return fused, losses


# ---------------------------------------------------------------------------
# flat form: every edge of a group in one batched pass
# ---------------------------------------------------------------------------
def _targets_steps(k: int, args, kwargs):
    """``_kd_targets_all``'s arguments cut to ``k`` steps (for
    ``Telemetry.jit_cost``)."""
    mats, xb, programs, specs, dspec = args
    return dspec.steps, (mats, xb[:k], programs, specs, dataclasses.replace(dspec, steps=k)), kwargs


def _fuse_steps(k: int, args, kwargs):
    """``_distill_fuse_one``'s arguments cut to ``k`` steps."""
    flat, xb, targets, prog, spec, dspec = args
    return dspec.steps, (flat, xb[:k], targets[:k], prog, spec, dataclasses.replace(dspec, steps=k)), kwargs


@step_loop(_targets_steps)
def _kd_targets_all(mats, xb, programs, specs, dspec: DistillSpec) -> torch.Tensor:
    """The ensemble teacher targets for every step at once, (steps, E,
    B..., K), computed ONCE per fuse from the pre-fuse matrices and
    detached: every student group distills against this one tensor, so
    the order of the groups cannot matter."""
    with torch.no_grad():
        out = []
        for s in range(dspec.steps):
            probs = None
            for prog, spec, mat in zip(programs, specs, mats):
                logits = prog.apply_logits_cohort(unravel_batched(spec, mat), xb[s])
                p = torch.softmax(logits / dspec.temperature, dim=-1)
                probs = p if probs is None else probs + p
            out.append(probs / len(programs))
        return torch.stack(out)


@step_loop(_fuse_steps)
def _distill_fuse_one(flat, xb, targets, prog, spec: TreeSpec, dspec: DistillSpec):
    """One group's students on every edge: (E, D_g) in, (E, D_g) out, and
    the mean KD loss over steps and edges (a 0-d tensor)."""
    e = flat.shape[0]
    losses = []
    for s in range(dspec.steps):
        p = flat.detach().requires_grad_(True)
        logits = prog.apply_logits_cohort(unravel_batched(spec, p), xb[s])
        ce = -_target_logp(logits, targets[s], dspec.temperature).reshape(e, -1).mean(dim=1)
        loss = dspec.weight * dspec.temperature**2 * ce  # (E,): kd_loss of each edge
        (grad,) = torch.autograd.grad(loss.sum(), p)
        with torch.no_grad():
            flat = p.detach() - dspec.lr * grad
        losses.append(loss.detach())
    return flat, torch.stack(losses).mean()


def distill_fuse_flat(
    programs: Sequence,
    specs: Sequence[TreeSpec],
    mats: Sequence[torch.Tensor],
    xb: torch.Tensor,
    spec: DistillSpec,
    telemetry=None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Fuse every edge's per-group models, one batched pass per group.

    ``mats[g]`` is group g's (E, D_g) edge matrix, ``xb`` the (E, steps, B,
    *feat) public batches (edge-major, as the public store gathers them),
    on the matrices' device.  Returns the post-fuse matrices and each
    group's mean KD loss over steps and edges, a 0-d tensor on the device
    (the fuse makes the host wait for nothing; ``float()`` reads it).
    ``telemetry`` records the ``kd_fuse`` span with the summed analytic
    cost of the teachers (``"kd_targets"``) and every group's students
    (``"kd_fuse_one"``), and observes each loss into ``kd_loss`` after the
    round's eval (``Telemetry.observe_later``).
    """
    tel = telemetry if telemetry is not None else NULL_TELEMETRY
    with tel.span("kd_fuse", groups=len(programs), steps=spec.steps) as span:
        xb = xb.movedim(0, 1)  # (steps, E, B, *feat)
        programs, specs, mats = tuple(programs), tuple(specs), tuple(mats)
        cost = tel.jit_cost("kd_targets", _kd_targets_all, mats, xb, programs, specs, spec)
        targets = _kd_targets_all(mats, xb, programs, specs, spec)
        out, losses = [], []
        for prog, pspec, mat in zip(programs, specs, mats):
            c = tel.jit_cost("kd_fuse_one", _distill_fuse_one, mat, xb, targets, prog, pspec, spec)
            if c:
                cost = {k: cost.get(k, 0.0) + v for k, v in c.items()} if cost else c
            fused, loss = _distill_fuse_one(mat, xb, targets, prog, pspec, spec)
            out.append(fused)
            losses.append(loss)
        if cost:
            span.set(**cost)
        for loss in losses:
            tel.observe_later("kd_loss", loss)
    return out, losses


def check_public_shards(public_shards, n_edges: int) -> None:
    """One NON-EMPTY public shard per edge (shared by the engines and the
    readable simulator)."""
    if public_shards is None or len(public_shards) != n_edges:
        raise ValueError(
            f"distillation needs one public shard per edge ({n_edges}), got "
            f"{None if public_shards is None else len(public_shards)}"
        )
    if any(len(s) == 0 for s in public_shards):
        raise ValueError("distillation public shards must be non-empty")


def _dtype_name(dtype) -> str:
    """``"float32"`` for a torch or a numpy dtype: the reference compares
    ``jnp.dtype(...).name``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def check_distillable(programs: Sequence) -> None:
    """Distillation needs one shared logit alphabet and one shard layout."""
    k = {p.n_classes for p in programs}
    if len(k) > 1:
        raise ValueError(f"distillation fuse needs one shared label alphabet, got n_classes={sorted(k)}")
    feats = {(p.feat_shape, _dtype_name(p.feat_dtype)) for p in programs}
    if len(feats) > 1:
        raise ValueError(f"distillation fuse needs one shared public-shard layout, got {sorted(feats)}")
    # a sequence program scores a vocabulary, not the topic alphabet its
    # n_classes reports: that axis must agree too
    vocab = {getattr(getattr(p, "cfg", None), "vocab_size", None) for p in programs}
    if len(vocab) > 1:
        raise ValueError(
            f"distillation fuse needs one shared logit alphabet, got vocab sizes {sorted(map(str, vocab))}"
        )
