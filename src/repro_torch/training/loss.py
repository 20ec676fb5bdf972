"""Loss functions: classifier cross-entropy (the paper's eq. 1), LM
next-token cross-entropy (whole and chunked over the sequence) and
accuracy."""
from __future__ import annotations

import torch

from repro_torch.distributed.axes import is_dtensor


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
    if is_dtensor(logits):
        # DTensor cannot gather along a sharded vocabulary: pick the gold
        # logit by a one-hot sum, the same value (one nonzero term)
        hit = labels.to(torch.int64)[..., None] == torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(hit, logits, 0.0).sum(dim=-1)
    else:
        gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return logz - gold


def softmax_xent(logits, labels, mask=None):
    """Mean cross entropy. logits (..., V); labels (...)."""
    nll = softmax_nll(logits, labels)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def lm_loss(logits, tokens, *, shift: bool = True):
    """Next-token prediction: predict tokens[t+1] from logits[t]."""
    if shift:
        logits = logits[:, :-1]
        labels = tokens[:, 1:]
    else:
        labels = tokens
    return softmax_xent(logits, labels)


def chunked_lm_loss(hidden, emb, labels, *, chunk: int = 512):
    """Unembed and cross-entropy, one sequence chunk at a time.

    The full (B, S, V) logits would dominate activation memory at a large
    vocabulary; a loop over ``chunk``-long pieces of the sequence holds one
    (B, chunk, V) block of logits at a time (the reference scans the same
    chunks).  hidden: (B, S, d) final normed activations; emb: (V, d) output
    table; labels: (B, S) int.  Products are of the inputs' values in fp32
    with fp32 accumulation, as the reference's ``preferred_element_type``.
    Returns the mean token NLL.
    """
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    table = emb.float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        logits = _chunk_logits(hidden[:, i:i + chunk].float(), table)
        total = total + softmax_nll(logits, labels[:, i:i + chunk]).sum()
    return total / (b * s)


def _chunk_logits(h, table):
    """(B, c, d) x (V, d) -> (B, c, V) fp32 logits; for DTensors, each
    model rank's vocabulary slice from its table shard (vocab-parallel;
    the hidden states' gradient is then a sum over the model ranks)."""
    if not is_dtensor(table):
        return torch.einsum("bcd,vd->bcv", h, table)
    from repro_torch.distributed.axes import Whole, current_hints, kind_spec, on_shards
    from repro_torch.distributed.sharding import P

    hints = current_hints()
    m = hints.model_axis
    vocab = m if (m and table.shape[0] % hints.model_size == 0 and table.shape[0] >= hints.model_size) else None
    rows = kind_spec(tuple(h.shape), "batch")
    out = P(rows[0], None, vocab)
    return on_shards(lambda a, t: torch.einsum("bcd,vd->bcv", a, t), (h, table),
                     (Whole(rows, (m,) if vocab else ()), Whole(P(vocab, None))), (out,))


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))
