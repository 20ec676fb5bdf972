"""The CUDA kernels' arithmetic replayed in numpy, shared by the CPU tests
(held against the reference's Pallas kernels) and the card tests (held
against the kernels).  Imports neither JAX nor torch."""
import numpy as np


def segment_kernel_replay(x, ids, w, e):
    """The CUDA segment kernel's loop (``csrc/aggregate.cu``) replayed in
    numpy, fp32: per segment (one block each), the member rows listed in
    row order, the weights summed in that order and clamped at 1e-30, then
    each member's product w / W * x rounded and added in that order; ids
    outside [0, e) match no segment.  ``x`` (N, D), ``ids`` and ``w`` (N,)."""
    x, w, ids = np.asarray(x, np.float32), np.asarray(w, np.float32), np.asarray(ids, np.int64)
    out = np.zeros((e, x.shape[1]), np.float32)
    for s in range(e):
        members = np.nonzero(ids == s)[0]
        den = np.float32(0)
        for i in members:
            den = np.float32(den + w[i])
        den = np.maximum(den, np.float32(1e-30))
        for i in members:
            out[s] = out[s] + np.float32(w[i] / den) * x[i]  # fp32: the product rounded, then the sum
    return out


def aggregate_kernel_replay(x, w):
    """The CUDA ``hier_aggregate`` kernel, the segment kernel's code with
    every row in one segment: the raw weights summed in row order and
    clamped at 1e-30, each divided by the sum, and the rounded products
    added in row order.  ``x`` (N, D), ``w`` (N,); returns (D,) fp32."""
    return segment_kernel_replay(x, np.zeros(len(w), np.int64), w, 1)[0]


def topk_kernel_replay(logits, k):
    """The CUDA top-k gating kernels (``csrc/topk_gating.cu``) replayed in
    numpy, fp32, for every row at once.

    Softmax in the order of PyTorch's warp softmax, which both of the
    kernel's layouts keep: lane l of 32 holds experts l + 32 i (a slot past
    E holds 0), adds its values in i order, then the xor butterfly 16, 8, 4,
    2, 1 adds the lanes' sums.  Then the sweeps on the
    probabilities' bits: the unsigned maximum of what remains is the top, a
    row whose top is 0 stops, the lowest expert index holding the top is
    chosen and its remainder zeroed, and the top is added to ``total``.  A
    chosen expert is one whose probability is > 0 and whose remainder is 0;
    it gets probs / max(total, 1e-9).  ``logits`` (T, E); returns (T, E)."""
    x = np.asarray(logits, np.float32)
    t, e = x.shape
    width = 32 * max(1, -(-e // 32))
    valid = np.arange(width) < e
    padded = np.full((t, width), -np.inf, np.float32)
    padded[:, :e] = x
    mx = padded.max(axis=1, keepdims=True)
    p = np.where(valid, np.exp(padded - mx), np.float32(0)).astype(np.float32)
    lanes = np.zeros((t, 32), np.float32)
    for i in range(width // 32):
        lanes = lanes + p[:, 32 * i : 32 * (i + 1)]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ off]
    probs = (p / lanes[:, :1]).astype(np.float32)
    rem = probs.view(np.uint32).copy()
    total = np.zeros(t, np.float32)
    live = np.ones(t, bool)
    rows = np.arange(t)
    for _ in range(k):
        top = rem.max(axis=1)
        live &= top > 0
        if not live.any():
            break
        first = np.argmax(rem == top[:, None], axis=1)  # the lowest index at the top
        total[live] = total[live] + top[live].view(np.float32)
        rem[rows[live], first[live]] = 0
    chosen = (rem == 0) & (probs > 0)
    out = np.where(chosen, probs / np.maximum(total, np.float32(1e-9))[:, None], np.float32(0))
    return out[:, :e].astype(np.float32)
