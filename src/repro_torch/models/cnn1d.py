"""The paper's client model: a small 1-D CNN classifier.

conv(k=5) -> relu -> maxpool2 -> conv(k=5) -> relu -> maxpool2 -> flatten ->
dense(32) -> relu -> dense(n_classes), in the reference's layout: conv
``w`` is (K, Cin, Cout), activations are (B, L, C), dense ``w`` is
(din, dout).

Two forms of the convolution, as in the reference:

  * ``"xla"``  — a library convolution (``F.conv1d``) of one model, the
                 evaluation path;
  * ``"gemm"`` — window-concat + one batched matrix product, the form the
                 cohort step trains C clients with (one (C, B*L, K*Cin) @
                 (C, K*Cin, Cout) product per layer).  It pools BEFORE the
                 bias and relu — exact, since max commutes with the
                 monotone bias-add and relu — so the elementwise work runs
                 on the half-length tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    in_channels: int = 1
    n_classes: int = 5
    seq_len: int = 187  # heartbeat dataset sample length
    c1: int = 16
    c2: int = 16
    hidden: int = 32
    kernel: int = 5

    @property
    def flat_dim(self) -> int:
        l1 = self.seq_len // 2
        l2 = l1 // 2
        return l2 * self.c2


HEARTBEAT_CNN = CNNConfig(in_channels=1, n_classes=5, seq_len=187)
SEIZURE_CNN = CNNConfig(in_channels=19, n_classes=3, seq_len=178)


def cnn_init(generator: torch.Generator, cfg: CNNConfig) -> dict:
    """Fresh float32 parameters on the CPU, drawn from ``generator`` with the
    reference's scales (its draws come from ``jax.random`` and cannot be
    repeated here)."""

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    def conv_w(cin, cout):
        return normal(cfg.kernel, cin, cout) * (1.0 / np.sqrt(cfg.kernel * cin))

    def lin_w(din, dout):
        return normal(din, dout) / np.sqrt(din)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32)

    return {
        "conv1": {"w": conv_w(cfg.in_channels, cfg.c1), "b": zeros(cfg.c1)},
        "conv2": {"w": conv_w(cfg.c1, cfg.c2), "b": zeros(cfg.c2)},
        "fc1": {"w": lin_w(cfg.flat_dim, cfg.hidden), "b": zeros(cfg.hidden)},
        "fc2": {"w": lin_w(cfg.hidden, cfg.n_classes), "b": zeros(cfg.n_classes)},
    }


def _same_pad(k: int):
    """'SAME' padding of a stride-1 window k: (k-1)//2 left, the rest right."""
    pad_l = (k - 1) // 2
    return pad_l, k - 1 - pad_l


def _conv1d_same(x, w, b):
    """x: (B, L, Cin); w: (K, Cin, Cout) -> (B, L, Cout), 'same' padding."""
    pad_l, pad_r = _same_pad(w.shape[0])
    xp = F.pad(x.transpose(1, 2), (pad_l, pad_r))  # (B, Cin, L + K - 1)
    out = F.conv1d(xp, w.permute(2, 1, 0))  # weight (Cout, Cin, K)
    return out.transpose(1, 2) + b


def _maxpool2(x):
    """Max over neighbour pairs of axis -2; an odd trailing element is dropped."""
    l = x.shape[-2] - (x.shape[-2] % 2)
    x = x[..., :l, :]
    return x.reshape(x.shape[:-2] + (l // 2, 2, x.shape[-1])).amax(dim=-2)


def _conv1d_same_gemm(x, w):
    """Cohort form of :func:`_conv1d_same` (bias excluded).

    x: (C, B, L, Cin); w: (C, K, Cin, Cout) -> (C, B, L, Cout) as one batched
    (C, B*L, K*Cin) @ (C, K*Cin, Cout) product; the windows concatenate
    K-major, matching ``w.reshape(K*Cin, Cout)``."""
    c, bsz, l, cin = x.shape
    k, cout = w.shape[1], w.shape[3]
    pad_l, pad_r = _same_pad(k)
    xp = F.pad(x, (0, 0, pad_l, pad_r))
    win = torch.cat([xp[:, :, j : j + l] for j in range(k)], dim=-1)
    out = torch.bmm(win.reshape(c, bsz * l, k * cin), w.reshape(c, k * cin, cout))
    return out.reshape(c, bsz, l, cout)


def cnn_apply_cohort(params, cfg: CNNConfig, x):
    """C models at once, GEMM form: params with a leading cohort axis C on
    every leaf, x: (C, B, L, Cin) -> logits (C, B, n_classes)."""
    del cfg  # shapes come from the parameters
    h = _maxpool2(_conv1d_same_gemm(x, params["conv1"]["w"]))
    h = torch.relu(h + params["conv1"]["b"][:, None, None, :])
    h = _maxpool2(_conv1d_same_gemm(h, params["conv2"]["w"]))
    h = torch.relu(h + params["conv2"]["b"][:, None, None, :])
    h = h.reshape(h.shape[0], h.shape[1], -1)
    h = torch.relu(torch.bmm(h, params["fc1"]["w"]) + params["fc1"]["b"][:, None, :])
    return torch.bmm(h, params["fc2"]["w"]) + params["fc2"]["b"][:, None, :]


def cnn_apply(params, cfg: CNNConfig, x, *, conv_impl: str = "xla"):
    """x: (B, L, Cin) float32 -> logits (B, n_classes) of one model.

    ``conv_impl``: "xla" — library convolution; "gemm" — the cohort form
    with a cohort of one."""
    if conv_impl == "gemm":
        stacked = {k: {kk: v[None] for kk, v in d.items()} for k, d in params.items()}
        return cnn_apply_cohort(stacked, cfg, x[None])[0]
    if conv_impl != "xla":
        raise ValueError(f"conv_impl must be 'xla' or 'gemm', got {conv_impl!r}")
    h = torch.relu(_conv1d_same(x, params["conv1"]["w"], params["conv1"]["b"]))
    h = _maxpool2(h)
    h = torch.relu(_conv1d_same(h, params["conv2"]["w"], params["conv2"]["b"]))
    h = _maxpool2(h)
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(h @ params["fc1"]["w"] + params["fc1"]["b"])
    return h @ params["fc2"]["w"] + params["fc2"]["b"]
