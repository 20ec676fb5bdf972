"""A heartbeat-shaped IoT population, made in bulk from the seed.

The benchmark's own copy of the port's lazy health population
(``data/shard_source.py::HealthShardSource`` over ``make_dataset``),
rewritten to draw everything in a few large calls on the device instead
of one client at a time on the host:

  * each client holds ``min_per_class``-``max_per_class`` samples of every
    class plus ``dom_boost`` of one dominant class (the paper's per-device
    class imbalance); the set of these compositions is the same for every
    seed, which deals them to the clients in its own order;
  * a sample of class c is a sinusoid of frequency 2 + 3c with a random
    phase and amplitude, a Gaussian spike at 0.2 + 0.15c of its length
    (QRS-like), and N(0, 0.35) noise, as ``make_dataset`` draws it;
  * a client's samples come in a random order;
  * edges are striped: each dominant-class family round robin over the
    edges, so every edge's class histogram approaches the population's
    (the port's ``striped_assignment``);
  * the test set holds ``n_test_per_class`` samples of every class.

The same seed gives the same bytes on the same device.  Nothing here
imports the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_SIGNAL_CHUNK = 1 << 20  # samples drawn in one call
_COMPOSITION_SEED = 0x5EED_0001


@dataclasses.dataclass
class Population:
    x: np.ndarray  # (S, L, C) float32, every client's samples back to back
    y: np.ndarray  # (S,) int32
    offsets: np.ndarray  # (M + 1,) int64: client i holds rows offsets[i]:offsets[i + 1]
    dominant: np.ndarray  # (M,) int64
    edge_of: np.ndarray  # (M,) int32
    n_classes: int

    @property
    def sizes(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    @property
    def n_clients(self) -> int:
        return len(self.offsets) - 1

    def shard(self, cid: int):
        lo, hi = int(self.offsets[cid]), int(self.offsets[cid + 1])
        return self.x[lo:hi], self.y[lo:hi]


def _signals(gen: torch.Generator, labels: torch.Tensor, length: int, channels: int) -> torch.Tensor:
    """(S, L, C) float32 signals of the given classes (``make_dataset``'s
    morphology), drawn on ``labels``' device."""
    dev = labels.device
    s = labels.shape[0]
    cls = labels.to(torch.float32)[:, None, None]
    t = torch.linspace(0, 1, length, device=dev, dtype=torch.float32)[None, :, None]
    phase = torch.rand((s, 1, 1), generator=gen, device=dev) * (2 * np.pi)
    amp = 0.8 + 0.4 * torch.rand((s, 1, 1), generator=gen, device=dev)
    sig = amp * torch.sin(2 * np.pi * (2.0 + 3.0 * cls) * t + phase)
    center = torch.floor(length * (0.2 + 0.15 * cls))
    width = max(3, length // 40)
    pos = torch.arange(length, device=dev, dtype=torch.float32)[None, :, None]
    sig = sig + (1.5 + 0.5 * cls) * torch.exp(-0.5 * ((pos - center) / width) ** 2)
    chan = torch.arange(channels, device=dev, dtype=torch.float32)[None, None, :]
    sig = sig * (1.0 + 0.3 * torch.sin(chan * (cls + 1)))
    return sig + 0.35 * torch.randn((s, length, channels), generator=gen, device=dev)


def make_population(seed: int, n_clients: int, n_edges: int, *, n_classes: int, length: int, channels: int,
                    min_per_class: int, max_per_class: int, dom_boost: int, device="cpu") -> Population:
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    m, k = int(n_clients), int(n_classes)
    # one set of shard compositions for every seed (so the work, the largest
    # shard and the store's size are too), dealt to the clients in the seed's order
    fixed = torch.Generator(device=dev).manual_seed(_COMPOSITION_SEED)
    counts = torch.randint(min_per_class, max_per_class + 1, (m, k), generator=fixed, device=dev)
    dominant = torch.randint(0, k, (m,), generator=fixed, device=dev)
    counts[torch.arange(m, device=dev), dominant] += dom_boost
    deal = torch.randperm(m, generator=gen, device=dev)
    counts, dominant = counts[deal], dominant[deal]
    sizes = counts.sum(dim=1)
    labels = torch.repeat_interleave(torch.arange(k, device=dev).repeat(m), counts.reshape(-1))
    owner = torch.repeat_interleave(torch.arange(m, device=dev), sizes)
    # a random order inside each client: sort by owner, then by a random key
    order = torch.argsort(owner.to(torch.float64) + torch.rand(owner.shape, generator=gen, device=dev,
                                                                dtype=torch.float64) * 0.5)
    labels = labels[order]
    x = np.empty((labels.shape[0], length, channels), np.float32)
    for lo in range(0, labels.shape[0], _SIGNAL_CHUNK):
        x[lo:lo + _SIGNAL_CHUNK] = _signals(gen, labels[lo:lo + _SIGNAL_CHUNK], length, channels).cpu().numpy()
    offsets = np.zeros(m + 1, np.int64)
    offsets[1:] = np.cumsum(sizes.cpu().numpy())
    dom = dominant.cpu().numpy().astype(np.int64)
    return Population(x, labels.cpu().numpy().astype(np.int32), offsets, dom,
                      striped_edges(dom, k, n_edges), k)


def striped_edges(dominant: np.ndarray, n_classes: int, n_edges: int) -> np.ndarray:
    """(M,) int32 edge of each client: each dominant-class family round
    robin over the edges, in client order."""
    edge_of = np.empty(len(dominant), np.int32)
    for c in range(n_classes):
        sel = np.flatnonzero(dominant == c)
        edge_of[sel] = np.arange(len(sel)) % n_edges
    return edge_of


def make_test_set(seed: int, n_per_class: int, *, n_classes: int = 5, length: int = 187, channels: int = 1,
                  device="cpu"):
    """(x, y): ``n_per_class`` samples of every class, shuffled."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed((int(seed) + 0x7E57) % (1 << 63))
    labels = torch.arange(n_classes, device=dev).repeat_interleave(n_per_class)
    labels = labels[torch.randperm(len(labels), generator=gen, device=dev)]
    x = _signals(gen, labels, length, channels)
    return x.cpu().numpy(), labels.cpu().numpy().astype(np.int32)


def cnn_init(seed: int, cfg: dict, device="cpu") -> dict:
    """The 1-D CNN's initial float32 weights in its published layout
    (convolution ``w`` (K, Cin, Cout), dense ``w`` (din, dout), zero
    biases), scaled as the paper's model is: 1/sqrt(fan in)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed((int(seed) + 0xC22) % (1 << 63))
    k, cin, c1, c2, h, n = cfg["kernel"], cfg["in_channels"], cfg["c1"], cfg["c2"], cfg["hidden"], cfg["n_classes"]
    flat = (cfg["seq_len"] // 2 // 2) * c2

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) / np.sqrt(fan_in)

    def zeros(c):
        return torch.zeros((c,), device=dev)

    return {
        "conv1": {"w": normal((k, cin, c1), k * cin), "b": zeros(c1)},
        "conv2": {"w": normal((k, c1, c2), k * c1), "b": zeros(c2)},
        "fc1": {"w": normal((flat, h), flat), "b": zeros(h)},
        "fc2": {"w": normal((h, n), h), "b": zeros(n)},
    }
