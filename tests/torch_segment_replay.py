"""The CUDA segment kernel's loop replayed in numpy, shared by the CPU tests
(held against the reference's Pallas kernel) and the card tests (held
against the kernel).  Imports neither JAX nor torch."""
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
