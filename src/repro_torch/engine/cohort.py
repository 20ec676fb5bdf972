"""Cohort-batched local training: one batched step per same-shape group.

Clients whose padded shard shape agrees — same steps bucket, local epoch
count, batch size and learning rate — are stacked on a leading *cohort*
axis C and trained together: each step is one forward of C models, one
backward of the SUM of the C per-client losses (the clients share no
parameter, so this gives every client exactly its own gradient), and one
elementwise Adam update of the (C, D) flat parameter matrix (Adam is
elementwise, so updating the flat matrix is the per-client update).

Batch indices replicate the reference's draws exactly (permutation, then
resample-padding, in global client order), so the engine consumes the numpy
RNG stream as the reference does and both train on identical batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine.flatten import FlatPack, ravel_batched, unravel_batched
from repro_torch.federated.client import FLClient
from repro_torch.federated.programs import ClientProgram, group_clients
from repro_torch.utils.tree import TreeSpec, tree_map, tree_size_bytes


@dataclasses.dataclass
class GroupState:
    """Per-architecture-group engine state, one entry per distinct program
    in first-appearance order.  This slice trains one architecture, so
    every list holds one entry."""

    programs: List[ClientProgram]
    group_of: np.ndarray  # (M,) client -> group index
    params: List[dict]
    packs: List[FlatPack]
    bits: List[float]  # per-group model bits
    uplink_bits: List[float]  # per-group EU->edge upload payload


def build_group_state(clients, program: ClientProgram, params, pack: FlatPack) -> GroupState:
    """The single group of a population that trains one program."""
    programs, group_of = group_clients(clients, fallback=program)
    if programs != [program]:
        raise NotImplementedError(
            "populations of more than one client program (model_mix) are not "
            "ported yet; see ROADMAP.md Queue 1, heterogeneous models"
        )
    bits = tree_size_bytes(params) * 8
    return GroupState([program], group_of, [params], [pack], [bits], [program.uplink_bits(bits)])


def draw_batch_indices(
    rng: np.random.Generator, n: int, steps: int, batch: int, epochs: int
) -> List[np.ndarray]:
    """The reference client's sampling, one draw pair per epoch."""
    out = []
    for _ in range(epochs):
        idx = rng.permutation(n)
        need = steps * batch
        if need > n:  # pad by resampling
            idx = np.concatenate([idx, rng.integers(0, n, need - n)])
        out.append(idx[:need].reshape(steps, batch))
    return out


def _cohort_epoch_flat(
    flat: torch.Tensor, xb, yb, spec: TreeSpec, program: ClientProgram, n_steps: int, lr: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One local epoch of C clients: (C, D) in, (C, D) out.

    xb: (C, n_steps, B, *feat); yb: (C, n_steps, B).  Returns the trained
    rows and each client's mean loss over its steps (C,).  The input is
    not modified.
    """
    opt = program.make_optimizer(lr)
    p = flat.detach().clone()
    state = opt.init(p)
    losses = []
    for s in range(n_steps):
        p.requires_grad_(True)
        loss = program.cohort_loss(unravel_batched(spec, p), xb[:, s], yb[:, s])
        (grad,) = torch.autograd.grad(loss.sum(), p)
        with torch.no_grad():
            p, state = opt.update(p.detach(), grad, state, s)
        losses.append(loss.detach())
    return p, torch.stack(losses).mean(dim=0)


def _cohort_epoch_body(params, xb, yb, program: ClientProgram, n_steps: int, lr: float):
    """Tree-major form of :func:`_cohort_epoch_flat`: params carry a leading
    cohort axis C on every leaf."""
    spec = FlatPack(tree_map(lambda v: v[0], params)).spec
    flat, loss = _cohort_epoch_flat(ravel_batched(params), xb, yb, spec, program, n_steps, lr)
    return unravel_batched(spec, flat), loss


@dataclasses.dataclass
class _PlanGroup:
    """One same-shape cohort of a ``CohortPlan`` after a round's draw."""

    members: np.ndarray  # (C,) participating client ids, in client order
    idx: np.ndarray  # (C, epochs, steps, batch) int32 sample indices
    steps: int
    batch: int
    lr: float
    program: ClientProgram = None

    @property
    def epochs(self) -> int:
        return self.idx.shape[1]


class CohortPlan:
    """Static cohort grouping for the device pipeline.

    Which cohort a client falls into depends only on its shard size and its
    (program, steps, batch, lr, epochs) tuple, computed once at engine
    construction.  Per round, :meth:`draw` consumes the numpy RNG stream
    draw for draw like the reference, in global client order, and fills
    each group's index tensor.
    """

    def __init__(self, clients: Sequence[FLClient], program: ClientProgram | None = None):
        self.program = program if program is not None else clients[0].program
        self.sizes = np.array([len(c.shard) for c in clients], np.int64)
        self.steps = np.zeros(len(clients), np.int64)
        self._epochs_override = [c.local_epochs for c in clients]
        self._single_step = [c.program.single_step for c in clients]
        self._group_key: Dict[int, Tuple] = {}
        for i, c in enumerate(clients):
            if self.sizes[i] == 0:
                continue
            self.steps[i] = c.plan_steps()
            self._group_key[i] = (c.program, int(self.steps[i]), c.batch_size, c.lr)

    def _epochs_of(self, i: int, schedule_epochs: int) -> int:
        if self._single_step[i]:
            return 1
        e = self._epochs_override[i]
        return e if e is not None else schedule_epochs

    def draw(
        self, rng: np.random.Generator, active: np.ndarray, epochs: int
    ) -> Tuple[List[_PlanGroup], np.ndarray]:
        """(groups, passthrough) for the ``active`` clients; ``passthrough``
        lists active clients with empty shards (they upload their start
        row untouched)."""
        members: Dict[Tuple, List[int]] = {}
        passthrough: List[int] = []
        for i in np.nonzero(active)[0]:
            if self.sizes[i] == 0:
                passthrough.append(int(i))
            else:
                key = self._group_key[int(i)] + (self._epochs_of(int(i), epochs),)
                members.setdefault(key, []).append(int(i))
        groups = [
            _PlanGroup(
                members=np.asarray(ids, np.int64),
                idx=np.zeros((len(ids), e, steps, batch), np.int32),
                steps=steps,
                batch=batch,
                lr=lr,
                program=prog,
            )
            for (prog, steps, batch, lr, e), ids in members.items()
        ]
        slot = {}
        for g in groups:
            for c, i in enumerate(g.members):
                slot[int(i)] = (g, c)
        # the draws themselves MUST run in global client order
        for i in np.nonzero(active)[0]:
            if self.sizes[i] == 0:
                continue
            g, c = slot[int(i)]
            n = int(self.sizes[i])
            need = g.steps * g.batch
            for e in range(g.epochs):
                idx = rng.permutation(n)
                if need > n:  # pad by resampling
                    idx = np.concatenate([idx, rng.integers(0, n, need - n)])
                g.idx[c, e] = idx[:need].reshape(g.steps, g.batch)
        return groups, np.asarray(passthrough, np.int64)
