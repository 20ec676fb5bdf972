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

A heterogeneous-model population (clients of more than one program) never
stacks two architectures' rows: the program leads every cohort key, and
``run_cohorts`` returns one block of rows per program.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine.flatten import FlatPack, ravel_batched, unravel_batched
from repro_torch.federated.client import _BUCKETS, FLClient
from repro_torch.federated.programs import ClientProgram, group_clients
from repro_torch.federated.simulation import initial_params
from repro_torch.telemetry import NULL_TELEMETRY, client_map, step_loop
from repro_torch.utils.tree import TreeSpec, tree_leaves, tree_map, tree_size_bytes


@functools.lru_cache(maxsize=None)
def pack_for(program: ClientProgram) -> FlatPack:
    """The ``FlatPack`` of ``program``'s parameter layout, one per program
    (a layout depends on the program alone, not on parameter values): for
    the callers that meet a program through a client, not a constructor
    argument (mixed-program cohorts, the engines' other groups)."""
    return FlatPack(program.init(torch.Generator().manual_seed(0)))


@dataclasses.dataclass
class GroupState:
    """Per-architecture-group engine state (heterogeneous-model
    federation), one entry per distinct client program in first-appearance
    order: parameter trees, flat packs, model bits and the per-EU uplink
    payload.  The sync and async engines both build it here, so the two
    cannot drift apart."""

    programs: List[ClientProgram]
    group_of: np.ndarray  # (M,) client -> group index
    params: List[dict]
    packs: List[FlatPack]
    bits: List[float]  # per-group model bits
    uplink_bits: List[float]  # per-group EU->edge upload payload


def build_group_state(
    clients, program: ClientProgram, params, pack: FlatPack, seed: int, compression=None
) -> GroupState:
    """Partition ``clients`` by program and build each group's state.

    ``program`` / ``params`` / ``pack`` are the engine's own: the group of
    ``program`` reuses them (which keeps a homogeneous run bit-identical to
    the single-group engine), and every other group starts from
    ``initial_params`` with the same ``seed``, on ``params``' device.  An
    engine program that no client trains raises ``ValueError`` (the
    accounting defaults would follow an unused model).  The uplink payload
    is ``compression.bits`` of the group's flat (D_g,) row, the layout the
    engines compress (one global top-k, not the readable simulator's
    per-leaf one), when a compression is given, else the program's own
    (FedSGD's gradient payload, else the model).
    """
    programs, group_of = group_clients(clients, fallback=program)
    if clients and program not in programs:
        raise ValueError(
            f"engine program {program.name!r} matches none of the clients' "
            f"programs {[p.name for p in programs]}"
        )
    device = tree_leaves(params)[0].device
    group_params = [params if p == program else initial_params(p, seed, device) for p in programs]
    packs = [pack if p == program else FlatPack(t) for p, t in zip(programs, group_params)]
    bits = [tree_size_bytes(t) * 8 for t in group_params]
    if compression is not None and compression.kind != "none":
        uplink = [compression.bits(torch.zeros((pk.dim,), dtype=torch.float32)) for pk in packs]
    else:
        uplink = [p.uplink_bits(b) for p, b in zip(programs, bits)]
    return GroupState(programs, group_of, group_params, packs, bits, uplink)


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


def _epoch_steps(k: int, args, kwargs):
    """``_cohort_epoch_flat``'s arguments cut to ``k`` steps (for
    ``Telemetry.jit_cost``)."""
    flat, xb, yb, spec, program, n_steps, *rest = args
    return n_steps, (flat, xb[:, :k], yb[:, :k], spec, program, k, *rest), kwargs


def _epoch_clients(args, kwargs):
    """``_cohort_epoch_flat``'s arguments cut to one client when its program
    maps the cohort (for ``Telemetry.jit_cost``); None for the batched form."""
    flat, xb, yb, spec, program, *rest = args
    impl = rest[2] if len(rest) > 2 else kwargs.get("impl", "gemm")
    if not program.cohort_is_mapped(impl):
        return None
    return flat.shape[0], (flat[:1], xb[:1], yb[:1], spec, program, *rest), kwargs


@client_map(_epoch_clients)
@step_loop(_epoch_steps)
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
    """The trained rows of one ``run_cohorts`` call, in one (P_b, D_b)
    block per distinct program (rows of different architectures have
    different widths), each client's (block, row) and its loss (the mean
    over its last epoch's steps).  A single-program call has one block,
    :attr:`matrix`."""

    blocks: List[torch.Tensor]
    index: Dict[int, Tuple[int, int]]  # client id -> (block, row)
    loss: Dict[int, float]

    @property
    def matrix(self) -> torch.Tensor:
        """The one block of a single-program result."""
        if len(self.blocks) != 1:
            raise ValueError(
                f"CohortResult holds {len(self.blocks)} program blocks; "
                "use row()/gather() for mixed-program results"
            )
        return self.blocks[0]

    def row(self, cid: int) -> torch.Tensor:
        b, r = self.index[cid]
        return self.blocks[b][r]

    def gather(self, cids: Sequence[int]) -> torch.Tensor:
        """(len(cids), D) rows of one program block, stacked from views: no
        index goes to the device."""
        if len({self.index[c][0] for c in cids}) > 1:
            raise ValueError("gather() tags span program blocks")
        return torch.stack([self.row(c) for c in cids])


def _stack_starts(jobs: Sequence[LocalJob]) -> torch.Tensor:
    """The jobs' start rows as one (C, D) matrix.  The reference stacks
    each distinct row once and gathers, to keep its dispatches O(edges);
    here a stack of C views is one launch either way."""
    return torch.stack([j.start_flat for j in jobs])


def run_cohorts(
    jobs: Sequence[LocalJob],
    program: ClientProgram,
    pack: FlatPack,
    store=None,
    impl: str = "gemm",
    telemetry=None,
) -> CohortResult:
    """Train every job, same-shape jobs of one program together as one
    cohort.

    ``program`` / ``pack`` are the engine's own; a job whose client trains
    another program (a heterogeneous-model population) uses that program's
    ``pack_for`` and lands in its own result block, blocks in order of the
    programs' first job.  Each epoch's batches are gathered on the device
    from ``store`` (a ``DeviceShardStore``; only the sample indices go to
    the device), or, with no store, stacked from the clients' numpy shards
    on the host and uploaded: the same samples either way, so the result
    does not depend on the route.  The cohort's rows carry across epochs.
    ``telemetry`` (a ``Telemetry``) records one ``cohort_epoch`` span per
    cohort, with the analytic cost of its first epoch (key
    ``"cohort_epoch"``), and observes ``cohort_size`` and
    ``cohort_padding_waste``.
    """
    tel = telemetry if telemetry is not None else NULL_TELEMETRY
    device = jobs[0].start_flat.device if jobs else torch.device("cpu")

    def pack_of(prog):
        return pack if prog == program else pack_for(prog)

    block_of: Dict[ClientProgram, int] = {}
    groups: Dict[Tuple, List[LocalJob]] = {}
    passthrough: Dict[ClientProgram, List[LocalJob]] = {}
    for job in jobs:
        block_of.setdefault(job.client.program, len(block_of))
        if job.steps == 0:  # empty shard: the start row passes through
            passthrough.setdefault(job.client.program, []).append(job)
        else:
            groups.setdefault(job.key, []).append(job)
    mats: Dict[ClientProgram, List[torch.Tensor]] = {p: [] for p in block_of}
    offsets: Dict[ClientProgram, int] = {p: 0 for p in block_of}
    index: Dict[int, Tuple[int, int]] = {}
    loss_of: Dict[int, float] = {}
    for (prog, steps, epochs, batch, lr), members in groups.items():
        with tel.span(
            "cohort_epoch", program=prog.name, clients=len(members), epochs=epochs, steps=steps, batch=batch,
        ) as sp:
            if tel.enabled:
                tel.metrics.observe("cohort_size", len(members))
                need = float(steps * batch)
                occ = [min(len(j.client.shard), need) / need for j in members]
                tel.metrics.observe("cohort_padding_waste", 1.0 - sum(occ) / len(occ))
            flat = _stack_starts(members)
            cids = [j.client.cid for j in members]
            for e in range(epochs):
                if store is not None:
                    xb, yb = store.gather(cids, np.stack([j.idx[e] for j in members]))
                else:
                    xb = torch.as_tensor(np.stack([j.client.shard.x[j.idx[e]] for j in members]), device=device)
                    yb = torch.as_tensor(np.stack([j.client.shard.y[j.idx[e]] for j in members]), device=device)
                if e == 0:
                    cost = tel.jit_cost(
                        "cohort_epoch", _cohort_epoch_flat, flat, xb, yb, pack_of(prog).spec, prog, steps, lr, impl
                    )
                    if cost:
                        sp.set(**cost)
                flat, loss = _cohort_epoch_flat(flat, xb, yb, pack_of(prog).spec, prog, steps, lr, impl)
        mats[prog].append(flat)
        loss = loss.cpu().numpy()
        for c, job in enumerate(members):
            index[job.client.cid] = (block_of[prog], offsets[prog] + c)
            loss_of[job.client.cid] = float(loss[c])
        offsets[prog] += len(members)
    for prog, jobs_pt in passthrough.items():
        mats[prog].append(_stack_starts(jobs_pt))
        for c, job in enumerate(jobs_pt):
            index[job.client.cid] = (block_of[prog], offsets[prog] + c)
            loss_of[job.client.cid] = 0.0
        offsets[prog] += len(jobs_pt)
    if not block_of:
        return CohortResult([torch.zeros((0, pack.dim), dtype=torch.float32, device=device)], {}, {})
    blocks = [torch.cat(m, dim=0) if len(m) > 1 else m[0] for m in mats.values()]
    return CohortResult(blocks, index, loss_of)


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
