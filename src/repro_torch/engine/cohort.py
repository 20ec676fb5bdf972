"""Cohort-batched local training: one batched step per same-shape group.

Clients whose padded shard shape agrees — same steps bucket, local epoch
count, batch size and learning rate — are stacked on a leading *cohort*
axis C and trained together: each step is one forward of C models, one
backward of the SUM of the C per-client losses (the clients share no
parameter, so this gives every client exactly its own gradient), and one
elementwise optimizer update of the (C, D) flat parameter matrix (Adam and
SGD are elementwise, so updating the flat matrix is the per-client update).

Batch indices replicate the reference's draws exactly (permutation, then
resample-padding, in global client order), so the engine consumes the numpy
RNG stream as the reference does and both train on identical batches.

Three ways in: the device pipeline's ``CohortPlan`` (grouping fixed at
construction, batches gathered from a ``DeviceShardStore``), the host
pipeline's ``LocalJob`` list through ``run_cohorts`` (grouping per round,
batches stacked from the numpy shards), and the streaming engine's
``StreamCohortPlan`` (grouping per round from the shard sizes alone).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine.flatten import FlatPack, ravel_batched, unravel_batched
from repro_torch.federated.client import _BUCKETS, FLClient
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


def build_group_state(clients, program: ClientProgram, params, pack: FlatPack, compression=None) -> GroupState:
    """The single group of a population that trains one program.

    The uplink payload is ``compression.bits`` of the flat (D,) row the
    engines compress (one global top-k, not the readable simulator's
    per-leaf one) when a compression is given, else the program's own
    (FedSGD's gradient payload, else the model)."""
    programs, group_of = group_clients(clients, fallback=program)
    if programs != [program]:
        raise NotImplementedError(
            "populations of more than one client program (model_mix) are not "
            "ported yet; see ROADMAP.md Queue 1, heterogeneous models"
        )
    bits = tree_size_bytes(params) * 8
    if compression is not None and compression.kind != "none":
        uplink = compression.bits(torch.zeros((pack.dim,), dtype=torch.float32))
    else:
        uplink = program.uplink_bits(bits)
    return GroupState([program], group_of, [params], [pack], [bits], [uplink])


@dataclasses.dataclass
class LocalJob:
    """One client's local training for a round, its start as a flat (D,)
    row."""

    client: FLClient
    start_flat: torch.Tensor  # (D,)
    idx: List[np.ndarray]  # per-epoch (steps, batch) sample indices
    steps: int

    @property
    def key(self) -> Tuple:
        """Cohort key: jobs stack into one cohort only when their program,
        padded step count, epoch count, batch size and learning rate agree."""
        return (self.client.program, self.steps, len(self.idx), self.client.batch_size, self.client.lr)


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


def make_job(client: FLClient, start_flat, rng: np.random.Generator, epochs: int) -> LocalJob:
    """One client's round job, its batch indices drawn from ``rng``.
    ``epochs`` is the schedule's; the client's ``local_epochs`` and a
    ``single_step`` program override it, as in ``FLClient.local_update``."""
    n = len(client.shard)
    if n == 0:
        return LocalJob(client, start_flat, [], 0)
    steps = client.plan_steps()
    epochs = client.epochs_for(epochs)
    return LocalJob(client, start_flat, draw_batch_indices(rng, n, steps, client.batch_size, epochs), steps)


def _cohort_epoch_flat(
    flat: torch.Tensor,
    xb,
    yb,
    spec: TreeSpec,
    program: ClientProgram,
    n_steps: int,
    lr: float,
    impl: str = "gemm",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One local epoch of C clients: (C, D) in, (C, D) out.

    xb: (C, n_steps, B, *feat); yb: (C, n_steps, B).  Returns the trained
    rows and each client's mean loss over its steps (C,).  The input is
    not modified.  ``impl`` is the forward's form (``cohort_loss``): "gemm"
    for the device pipeline, "xla" (the library convolution, mapped over
    the clients) for the host pipeline.
    """
    opt = program.make_optimizer(lr)
    p = flat.detach().clone()
    state = opt.init(p)
    losses = []
    for s in range(n_steps):
        p.requires_grad_(True)
        loss = program.cohort_loss(unravel_batched(spec, p), xb[:, s], yb[:, s], impl=impl)
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
class CohortResult:
    """The trained rows of one ``run_cohorts`` call: one (P, D) matrix (the
    port trains one program per population), each client's row in it and
    its loss (the mean over its last epoch's steps)."""

    matrix: torch.Tensor
    index: Dict[int, int]  # client id -> row
    loss: Dict[int, float]

    def row(self, cid: int) -> torch.Tensor:
        return self.matrix[self.index[cid]]

    def gather(self, cids: Sequence[int]) -> torch.Tensor:
        """(len(cids), D) rows, stacked from views: no index goes to the
        device."""
        return torch.stack([self.row(c) for c in cids])


def _stack_starts(jobs: Sequence[LocalJob]) -> torch.Tensor:
    """The jobs' start rows as one (C, D) matrix.  The reference stacks
    each distinct row once and gathers, to keep its dispatches O(edges);
    here a stack of C views is one launch either way."""
    return torch.stack([j.start_flat for j in jobs])


def run_cohorts(
    jobs: Sequence[LocalJob], program: ClientProgram, pack: FlatPack, store=None, impl: str = "gemm"
) -> CohortResult:
    """Train every job, same-shape jobs together as one cohort.

    Each epoch's batches are gathered on the device from ``store`` (a
    ``DeviceShardStore``; only the sample indices go to the device), or,
    with no store, stacked from the clients' numpy shards on the host and
    uploaded: the same samples either way, so the result does not depend
    on the route.  The cohort's rows carry across epochs.  Every job must
    train ``program``: a mixed-program list raises
    ``NotImplementedError`` (heterogeneous models are queued).
    """
    for job in jobs:
        if job.client.program != program:
            raise NotImplementedError(
                "jobs of more than one client program (model_mix) are not ported "
                "yet; see ROADMAP.md Queue 1 item 8, heterogeneous models"
            )
    device = jobs[0].start_flat.device if jobs else torch.device("cpu")
    groups: Dict[Tuple, List[LocalJob]] = {}
    passthrough: List[LocalJob] = []
    for job in jobs:
        if job.steps == 0:  # empty shard: the start row passes through
            passthrough.append(job)
        else:
            groups.setdefault(job.key, []).append(job)
    mats: List[torch.Tensor] = []
    index: Dict[int, int] = {}
    loss_of: Dict[int, float] = {}
    offset = 0
    for (_, steps, epochs, _, lr), members in groups.items():
        flat = _stack_starts(members)
        cids = [j.client.cid for j in members]
        for e in range(epochs):
            if store is not None:
                xb, yb = store.gather(cids, np.stack([j.idx[e] for j in members]))
            else:
                xb = torch.as_tensor(np.stack([j.client.shard.x[j.idx[e]] for j in members]), device=device)
                yb = torch.as_tensor(np.stack([j.client.shard.y[j.idx[e]] for j in members]), device=device)
            flat, loss = _cohort_epoch_flat(flat, xb, yb, pack.spec, program, steps, lr, impl=impl)
        mats.append(flat)
        loss = loss.cpu().numpy()
        for c, job in enumerate(members):
            index[job.client.cid] = offset + c
            loss_of[job.client.cid] = float(loss[c])
        offset += len(members)
    if passthrough:
        mats.append(_stack_starts(passthrough))
        for c, job in enumerate(passthrough):
            index[job.client.cid] = offset + c
            loss_of[job.client.cid] = 0.0
    if not mats:
        return CohortResult(torch.zeros((0, pack.dim), dtype=torch.float32, device=device), {}, {})
    return CohortResult(mats[0] if len(mats) == 1 else torch.cat(mats, dim=0), index, loss_of)


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


class StreamCohortPlan:
    """``CohortPlan`` over an analytic population: no per-client objects.

    ``CohortPlan`` walks M ``FLClient`` objects when it is built, which
    alone breaks the streaming budget at M = 1M.  This plan takes the
    source's (M,) ``sizes`` and one set of hyperparameters, and derives a
    member's padded step count when it is drawn (``FLClient``'s bucketing,
    vectorized).  :meth:`draw` works on the round's member ids: it consumes
    the RNG as ``draw_batch_indices`` does, one permutation (and the
    resampling pad) per member and epoch, in ascending client id, which is
    what ``CohortPlan`` consumes for the same members, so the streaming and
    the sync engine train on the same batches.
    """

    def __init__(
        self,
        sizes: np.ndarray,
        program: ClientProgram,
        *,
        batch_size: int = 10,
        lr: float = 1e-3,
        max_steps: int = 128,
    ):
        self.program = program
        self.batch = int(batch_size)
        self.lr = float(lr)
        self.max_steps = int(max_steps)
        # the source's (M,) array, shared: the plan holds no O(M) state
        self.sizes = np.asarray(sizes)
        self._buckets = np.asarray(_BUCKETS, np.int64)

    def steps_for(self, members: np.ndarray) -> np.ndarray:
        """Padded step count per member (``FLClient.plan_steps``)."""
        s = self.sizes[members].astype(np.int64)
        if self.program.single_step:
            return (s > 0).astype(np.int64)
        raw = np.clip((s + self.batch - 1) // self.batch, 1, self.max_steps)
        pos = np.minimum(np.searchsorted(self._buckets, raw, side="left"), len(self._buckets) - 1)
        return np.where(s > 0, self._buckets[pos], 0)

    def draw(
        self, rng: np.random.Generator, members: np.ndarray, epochs: int
    ) -> Tuple[List[_PlanGroup], np.ndarray]:
        """(groups, passthrough) for the cohort ``members`` (sorted ids)."""
        epochs = 1 if self.program.single_step else int(epochs)
        members = np.asarray(members, np.int64)
        steps_of = dict(zip(members.tolist(), self.steps_for(members).tolist()))
        grouped: Dict[int, List[int]] = {}
        passthrough: List[int] = []
        for i in members:
            if self.sizes[i] == 0:
                passthrough.append(int(i))
            else:
                grouped.setdefault(steps_of[int(i)], []).append(int(i))
        groups = [
            _PlanGroup(
                members=np.asarray(ids, np.int64),
                idx=np.zeros((len(ids), epochs, steps, self.batch), np.int32),
                steps=steps,
                batch=self.batch,
                lr=self.lr,
                program=self.program,
            )
            for steps, ids in grouped.items()
        ]
        slot = {}
        for g in groups:
            for c, i in enumerate(g.members):
                slot[int(i)] = (g, c)
        for i in members:  # the draws in ascending client id
            if self.sizes[i] == 0:
                continue
            g, c = slot[int(i)]
            n = int(self.sizes[i])
            need = g.steps * g.batch
            for e in range(epochs):
                idx = rng.permutation(n)
                if need > n:  # pad by resampling
                    idx = np.concatenate([idx, rng.integers(0, n, need - n)])
                g.idx[c, e] = idx[:need].reshape(g.steps, g.batch)
        return groups, np.asarray(passthrough, np.int64)
