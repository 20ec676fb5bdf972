"""Classifier cross-entropy (the paper's eq. 1) and accuracy."""
from __future__ import annotations

import torch


def _logsumexp(x):
    """``log(sum(exp(x - max))) + max`` with the max held constant, as JAX
    writes it: its gradient is then ``exp(x - max) * (1 / sum)``, rounded
    as the reference rounds it.  ``torch.logsumexp`` differentiates to
    ``exp(x - logz)`` instead; on a trained model the correct class's
    gradient ``p - 1`` is a few float32 ulps, and Adam's first step after
    each restart (``g / (|g| + eps)``) turns that rounding difference into
    parameter moves of up to ``lr``."""
    m = x.detach().amax(dim=-1, keepdim=True)
    return torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]


def softmax_nll(logits, labels):
    """Per-example cross entropy. logits (..., V) -> (...) in fp32."""
    logits = logits.to(torch.float32)
    logz = _logsumexp(logits)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return logz - gold


def softmax_xent(logits, labels, mask=None):
    """Mean cross entropy. logits (..., V); labels (...)."""
    nll = softmax_nll(logits, labels)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))
