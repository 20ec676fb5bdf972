"""Device-resident client shard store.

All client shards are padded into ONE ``(M, n_max, *feat)`` tensor on the
device when the engine is built, so a cohort's per-step batches come from a
single gather whose only host->device traffic is the ``(C, steps, batch)``
sample indices the RNG stream draws anyway.  Indices are always drawn in
``[0, len(shard_i))``, so the zero padding is never read.  Padding is to the
LARGEST shard: the heartbeat population at full scale holds 18 x 17,060
samples of 187 floats, about 230 MB.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


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
        (C, steps, batch, *feat) batches and (C, steps, batch) labels."""
        c = torch.as_tensor(np.asarray(cids, np.int64), device=self.device)[:, None, None]
        i = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        return self.x[c, i], self.y[c, i]
