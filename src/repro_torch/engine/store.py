"""Device-resident client shard stores.

All client shards are padded into ONE ``(M, n_max, *feat)`` tensor on the
device when the engine is built, so a cohort's per-step batches come from a
single gather whose only host->device traffic is the ``(C, steps, batch)``
sample indices the RNG stream draws anyway.  Indices are always drawn in
``[0, len(shard_i))``, so the zero padding is never read.  Padding is to the
LARGEST shard: the heartbeat population at full scale holds 18 x 17,060
samples of 187 floats, about 230 MB.  One pathologically large shard would
inflate the store M-fold: ``build_if_economical`` declines past
``MAX_PADDING_RATIO``, and its callers stack batches on the host instead.

``PagedShardStore`` is the streaming engine's store: a fixed slab of
``capacity`` client slots over a lazy ``ShardSource``, paged in LRU order,
so its device memory is O(cohort) whatever the population.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import upload

# past this padding blow-up the store costs more memory than it saves time
MAX_PADDING_RATIO = 16.0


class DeviceShardStore:
    """All client shards padded into one device tensor pair.

    ``clients`` is a sequence of ``FLClient``-like objects ordered by
    ``cid`` (checked — :meth:`gather` indexes by cid).  The feature block's
    shape and dtype follow the shards; labels are int64.
    """

    def __init__(self, clients: Sequence, device):
        if not clients:
            raise ValueError("DeviceShardStore needs at least one client")
        for i, c in enumerate(clients):
            if getattr(c, "cid", i) != i:
                raise ValueError(f"client at position {i} has cid {c.cid}")
        self._build([c.shard for c in clients], torch.device(device))

    @classmethod
    def from_shards(cls, shards: Sequence, device):
        """Store over bare ``Dataset`` shards, indexed by position."""
        obj = cls.__new__(cls)
        obj._build(list(shards), torch.device(device))
        return obj

    @classmethod
    def build_if_economical(cls, clients: Sequence, device):
        """A store, or None when padding to the largest shard would take
        more than ``MAX_PADDING_RATIO`` cells per real sample (checked
        before anything is allocated)."""
        sizes = np.array([len(c.shard) for c in clients] or [0])
        ratio = len(sizes) * max(1, int(sizes.max())) / max(1, int(sizes.sum()))
        return cls(clients, device) if ratio <= MAX_PADDING_RATIO else None

    def _build(self, shards: List, device: torch.device) -> None:
        if not shards:
            raise ValueError("DeviceShardStore needs at least one shard")
        self.sizes = np.array([len(s) for s in shards], np.int64)
        n_max = max(1, int(self.sizes.max()))
        feat = next((s.x.shape[1:] for s in shards if len(s)), shards[0].x.shape[1:])
        xs = np.zeros((len(shards), n_max) + tuple(feat), shards[0].x.dtype)
        ys = np.zeros((len(shards), n_max), np.int64)
        for i, s in enumerate(shards):
            if len(s) == 0:
                continue
            if s.x.shape[1:] != feat:
                raise ValueError(f"client {i} shard shape {s.x.shape[1:]} != store layout {feat}")
            xs[i, : len(s)] = s.x
            ys[i, : len(s)] = s.y
        self.device = device
        self.x = torch.as_tensor(xs, device=device)
        self.y = torch.as_tensor(ys, device=device)

    @property
    def n_clients(self) -> int:
        return int(self.x.shape[0])

    def gather(self, cids, idx) -> Tuple[torch.Tensor, torch.Tensor]:
        """cids: (C,) client ids; idx: (C, steps, batch) in-shard indices ->
        (C, steps, batch, *feat) batches and (C, steps, batch) labels.  The
        indices go to the device from pinned memory: the host does not wait
        for the card."""
        c = upload(np.asarray(cids, np.int64), self.device)[:, None, None]
        i = upload(np.asarray(idx, np.int64), self.device)
        return self.x[c, i], self.y[c, i]


class PagedShardStore:
    """Bounded device working set over a lazy ``ShardSource``.

    A fixed ``(capacity, n_max, *feat)`` slab (labels int64) and an LRU
    slot map: :meth:`ensure` pages the round's clients in, synthesizing the
    misses from the source and writing them with one batched ``index_copy_``
    (uploaded from pinned memory, so the host does not wait for the card),
    and :meth:`gather_slots` gathers the batches by slot.  Because
    ``source.shard(cid)`` is pure in ``(seed, cid)``, an evicted client
    comes back bit-identical.  The reference pads each miss batch to a
    power of two so that its jitted scatter compiles few shapes; eager
    PyTorch has no such cache, so the batch is the misses alone.

    ``capacity`` should exceed the cohort size: a call with more clients
    than slots raises.  ``hits``, ``misses`` and ``evictions`` count the
    paging.  Client ids within one ``ensure`` call must be unique (cohorts
    are).
    """

    def __init__(self, source, capacity: int, device, n_max: "int | None" = None):
        sizes = np.asarray(source.sizes)
        if len(sizes) == 0:
            raise ValueError("PagedShardStore needs a non-empty source")
        self.source = source
        self.sizes = sizes
        self.capacity = int(min(capacity, len(sizes)))
        if self.capacity < 1:
            raise ValueError("PagedShardStore needs capacity >= 1")
        self.n_max = int(n_max if n_max is not None else max(1, sizes.max()))
        self.device = torch.device(device)
        self._feat = tuple(source.feat_shape)
        self._np_dtype = np.dtype(source.feat_dtype)
        x_dtype = torch.as_tensor(np.zeros(0, self._np_dtype)).dtype
        self.x = torch.zeros((self.capacity, self.n_max) + self._feat, dtype=x_dtype, device=self.device)
        self.y = torch.zeros((self.capacity, self.n_max), dtype=torch.int64, device=self.device)
        self._slot_of: dict = {}  # cid -> slot
        self._lru: OrderedDict = OrderedDict()  # cid -> None, in order of use
        self._free = list(range(self.capacity - 1, -1, -1))
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @classmethod
    def from_shards(cls, shards: Sequence, capacity: int, device):
        """A paged store over shards already in memory (parity tests)."""
        return cls(_ShardListSource(list(shards)), capacity, device)

    @property
    def device_bytes(self) -> int:
        return self.x.element_size() * self.x.numel() + self.y.element_size() * self.y.numel()

    def _take_slot(self) -> int:
        if self._free:
            return self._free.pop()
        victim, _ = self._lru.popitem(last=False)
        self.evictions += 1
        return self._slot_of.pop(victim)

    def ensure(self, cids) -> np.ndarray:
        """Page the given clients in; return their (C,) int64 slot ids.

        Residents are touched (made most recent) before any eviction, so a
        miss never evicts a slot this same call needs.
        """
        cids = np.asarray(cids, np.int64)
        if len(cids) > self.capacity:
            raise ValueError(f"cohort of {len(cids)} exceeds paged-store capacity {self.capacity}")
        slots = np.empty(len(cids), np.int64)
        missing: List[int] = []
        for p, c in enumerate(cids.tolist()):
            s = self._slot_of.get(c)
            if s is None:
                missing.append(p)
            else:
                slots[p] = s
                self.hits += 1
                self._lru.move_to_end(c)
        if missing:
            bx = np.zeros((len(missing), self.n_max) + self._feat, self._np_dtype)
            by = np.zeros((len(missing), self.n_max), np.int64)
            for k, p in enumerate(missing):
                c = int(cids[p])
                shard = self.source.shard(c)
                n = len(shard)
                if n > self.n_max:
                    raise ValueError(f"shard {c} ({n} samples) exceeds n_max {self.n_max}")
                bx[k, :n] = shard.x
                by[k, :n] = shard.y
                s = self._take_slot()
                self._slot_of[c] = s
                self._lru[c] = None
                slots[p] = s
                self.misses += 1
            # one batched write per call: the host-to-device traffic is the
            # round's misses, never the population
            sl = upload(slots[missing], self.device)
            self.x.index_copy_(0, sl, upload(bx, self.device))
            self.y.index_copy_(0, sl, upload(by, self.device))
        return slots

    def gather_slots(self, slots: torch.Tensor, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """slots: (C,) int64 slot ids and idx: (C, steps, batch) int64
        in-shard indices, both on the store's device -> (C, steps, batch,
        *feat) batches and (C, steps, batch) labels."""
        s = slots[:, None, None]
        return self.x[s, idx], self.y[s, idx]

    def gather(self, cids, idx) -> Tuple[torch.Tensor, torch.Tensor]:
        """cids: (C,) client ids; idx: (C, steps, batch) in-shard indices."""
        slots = self.ensure(cids)
        return self.gather_slots(upload(slots, self.device), upload(np.asarray(idx, np.int64), self.device))


class _ShardListSource:
    """The ``ShardSource`` interface over a list of shards in memory."""

    def __init__(self, shards: List):
        self._shards = shards
        self.n_clients = len(shards)
        self.sizes = np.array([len(s) for s in shards], np.int64)
        first = next((s for s in shards if len(s)), shards[0])
        self.feat_shape = tuple(first.x.shape[1:])
        self.feat_dtype = first.x.dtype

    def shard(self, cid: int):
        return self._shards[cid]
