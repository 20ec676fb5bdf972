"""Adam's update of one parameter leaf, in place.

Replaces no TPU kernel: the reference writes Adam out in ``jnp``
(``src/repro/training/optimizers.py``) and leaves its fusion to XLA.  It
was added because the eager port's Adam, some 18 PyTorch elementwise
operations over each 16M-element slice of a leaf, every intermediate an
fp32 tensor written to device memory and read back (~184 bytes a
parameter), was half of the phi3-mini edge replicas' training step.
``training/optimizers.py``'s ``adam(...).update_`` calls it once a leaf.

What bounds it on an H100: bytes.  It reads p, g, m and v once and
writes p, m and v once: 22 bytes a parameter for bf16 p and g with fp32
moments, about 0.1 flop a byte.

Design (``csrc/adam.cu``): one launch a leaf on PyTorch's current stream,
nothing allocated, no synchronisation; a grid-stride loop over enough
blocks to fill every SM, 8 elements a thread an iteration as 16-byte
loads and stores with streaming cache hints, a scalar path for the ragged
tail and for pointers that are not 16-byte aligned.  Every operation is
the plain version's, in its order, each rounded on its own (no FMA), the
new moments rounded to their dtype before the parameter's update reads
them, and the scalars are the float32 PyTorch makes of the same Python
floats: the kernel writes the plain version's bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.common import UPDATE_DTYPES, check_launch, ptr, stream_of, takes_plain

# elements of a leaf the plain version handles at a time, so an update
# holds one slice's fp32 temporaries beside the model
_SLICE = 1 << 24


def _check(p, g, m, v, name: str) -> None:
    """p, g, m, v: tensors of one shape on one device, contiguous, p and g
    fp32 or bf16, m and v both fp32 or both bf16."""
    for what, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {what} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in UPDATE_DTYPES:
            raise TypeError(f"{name}: {what} must be float32 or bfloat16, got {t.dtype}")
        if t.shape != p.shape:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, p {tuple(p.shape)}")
        if t.device != p.device:
            raise ValueError(f"{name}: {what} is on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if m.dtype != v.dtype:
        raise TypeError(f"{name}: m is {m.dtype} and v {v.dtype}; the moments share one dtype")


@torch.no_grad()
def adam_update_ref_(p, g, m, v, *, b1, b2, eps, lr_t, mh_scale, vh_scale, weight_decay=0.0) -> None:
    """Plain PyTorch version: ``adam``'s ``new_m``, ``new_v`` and ``new_p``
    (``training/optimizers.py``) over one ``_SLICE`` of the leaf at a time,
    written into p, m and v."""
    mdt = m.dtype
    p1, g1, m1, v1 = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
    for i in range(0, p1.numel(), _SLICE):
        s = slice(i, i + _SLICE)
        m1[s] = (b1 * m1[s].float() + (1 - b1) * g1[s].float()).to(mdt)
        v1[s] = (b2 * v1[s].float() + (1 - b2) * torch.square(g1[s].float())).to(mdt)
        upd = (m1[s].float() * mh_scale) / (torch.sqrt(v1[s].float() * vh_scale) + eps)
        if weight_decay:
            upd = upd + weight_decay * p1[s].float()
        p1[s] = (p1[s].float() - lr_t * upd).to(p.dtype)


def _launch(p, g, m, v, *, b1, b2, eps, lr_t, mh_scale, vh_scale, weight_decay=0.0) -> None:
    """Launch the CUDA kernel on checked, non-empty CUDA inputs.  Counts
    nothing."""
    lib = load_library()
    bf16 = lambda t: int(t.dtype == torch.bfloat16)  # noqa: E731
    f32 = ctypes.c_float  # the float32 PyTorch makes of a Python float: round to nearest
    with torch.cuda.device(p.device):
        code = lib.repro_adam_update(
            ptr(p), ptr(g), ptr(m), ptr(v), p.numel(), bf16(p), bf16(g), bf16(m),
            f32(b1), f32(1 - b1), f32(b2), f32(1 - b2), f32(eps), f32(lr_t), f32(mh_scale), f32(vh_scale),
            f32(weight_decay), int(bool(weight_decay)), stream_of(p.device))
    check_launch(code, "adam_update")


def adam_update_(p, g, m, v, *, b1, b2, eps, lr_t, mh_scale, vh_scale, weight_decay=0.0) -> None:
    """One Adam step of a leaf, written into p, m and v.

    p: the parameters, g their gradients (fp32 or bf16 each); m, v the
    moments (both fp32 or both bf16); all of one shape, contiguous, on one
    device.  b1, b2, eps, weight_decay as ``adam`` takes them; lr_t the
    step's learning rate, mh_scale and vh_scale the bias corrections.

    CPU, meta and fake tensors take the plain version; CUDA tensors launch
    the kernel (one launch, counted in ``adam_update_.launches``, and
    nothing that waits for the card) or raise.
    """
    _check(p, g, m, v, "adam_update")
    kw = dict(b1=b1, b2=b2, eps=eps, lr_t=lr_t, mh_scale=mh_scale, vh_scale=vh_scale, weight_decay=weight_decay)
    if takes_plain(p):
        adam_update_ref_(p, g, m, v, **kw)
        return
    if p.numel() == 0:
        return
    _launch(p, g, m, v, **kw)
    adam_update_.launches += 1


adam_update_.launches = 0
