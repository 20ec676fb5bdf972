"""Synthetic ECG/EEG-like datasets matching the paper's class structure.

MIT-BIH Heartbeat and the AUBMC Seizure recordings are not available offline;
we synthesize separable-but-noisy 1-D signals whose *class-count structure*
matches the paper exactly (Tables 2-3).  Each class is a distinct mixture of
sinusoids + transient spikes so that a small CNN can reach high accuracy and
imbalance effects mirror the real experiments (see DESIGN.md Sec. 8).

Heartbeat: 5 classes, 1 channel, length 187 (kaggle segmented ECG format).
Seizure:   3 classes, 19 channels (10-20 electrode montage), length 178.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    x: np.ndarray  # (N, L, C) float32
    y: np.ndarray  # (N,) int32
    n_classes: int

    def subset(self, idx) -> "Dataset":
        return Dataset(self.x[idx], self.y[idx], self.n_classes)

    def __len__(self):
        return len(self.y)


def _class_signal(rng, cls: int, n: int, length: int, channels: int) -> np.ndarray:
    """Distinct per-class morphology: base frequency + class-specific spike."""
    t = np.linspace(0, 1, length, dtype=np.float32)
    base_freq = 2.0 + 3.0 * cls
    phase = rng.uniform(0, 2 * np.pi, (n, 1, 1)).astype(np.float32)
    amp = (0.8 + 0.4 * rng.random((n, 1, 1))).astype(np.float32)
    chan_mix = (1.0 + 0.3 * np.sin(np.arange(channels) * (cls + 1))).astype(np.float32)
    sig = amp * np.sin(2 * np.pi * base_freq * t[None, :, None] + phase)
    # class-specific transient (QRS-like for ECG / spike-wave for EEG)
    center = int(length * (0.2 + 0.15 * cls))
    width = max(3, length // 40)
    spike = np.exp(-0.5 * ((np.arange(length) - center) / width) ** 2).astype(np.float32)
    sig = sig + (1.5 + 0.5 * cls) * spike[None, :, None]
    sig = sig * chan_mix[None, None, :]
    noise = rng.normal(0, 0.35, (n, length, channels)).astype(np.float32)
    return sig + noise


def make_dataset(
    rng: np.random.Generator,
    class_counts: np.ndarray,
    length: int,
    channels: int,
) -> Dataset:
    xs, ys = [], []
    for cls, cnt in enumerate(np.asarray(class_counts, dtype=int)):
        if cnt <= 0:
            continue
        xs.append(_class_signal(rng, cls, cnt, length, channels))
        ys.append(np.full((cnt,), cls, np.int32))
    x = np.concatenate(xs, 0)
    y = np.concatenate(ys, 0)
    perm = rng.permutation(len(y))
    return Dataset(x[perm], y[perm], n_classes=len(class_counts))


def heartbeat_like(rng, class_counts) -> Dataset:
    return make_dataset(rng, class_counts, length=187, channels=1)


def seizure_like(rng, class_counts) -> Dataset:
    return make_dataset(rng, class_counts, length=178, channels=19)
