"""Input checks and launch plumbing shared by the kernels' wrappers."""
from __future__ import annotations

import ctypes

import torch

UPDATE_DTYPES = (torch.float32, torch.bfloat16)
# the devices whose tensors take a kernel's plain version: the CPU, and
# meta (shapes without storage), on which ``Telemetry.jit_cost`` counts a
# program's FLOPs and bytes; a CUDA tensor never does
PLAIN_DEVICES = ("cpu", "meta")


def takes_plain(t: torch.Tensor) -> bool:
    """Whether ``t`` goes to a kernel's plain version: a tensor on the CPU
    or meta, or a fake tensor whatever device it claims (the dry run's,
    which has no storage to launch on)."""
    from torch._subclasses.fake_tensor import is_fake

    return t.device.type in PLAIN_DEVICES or is_fake(t)


def check_no_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` when autograd would differentiate through a
    kernel that defines no gradient (the reference's kernel has none): a
    CUDA launch writes into a fresh tensor, so its output would be silently
    detached on the card while the plain version is differentiable on the
    CPU.  Raised on every device, so the CPU shows what the card would do."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} defines no gradient (the reference's kernel has none): call it under "
            "torch.no_grad() or torch.inference_mode(), or on inputs that do not require grad"
        )


def check_updates(updates, name: str) -> None:
    """The (N, D) update matrix: a contiguous 2-D fp32 or bf16 tensor."""
    if not isinstance(updates, torch.Tensor):
        raise TypeError(f"{name}: updates must be a torch.Tensor, got {type(updates).__name__}")
    if updates.dim() != 2:
        raise ValueError(f"{name}: updates must be (N, D), got shape {tuple(updates.shape)}")
    if updates.dtype not in UPDATE_DTYPES:
        raise TypeError(f"{name}: updates must be float32 or bfloat16, got {updates.dtype}")
    if not updates.is_contiguous():
        raise ValueError(f"{name}: updates must be contiguous")
    if updates.device.type not in PLAIN_DEVICES + ("cuda",):
        raise ValueError(f"{name}: updates must lie on the CPU, a CUDA device or meta, got {updates.device}")


def check_rows(vec, n: int, device: torch.device, what: str, name: str, *, integer: bool) -> None:
    """A (N,) per-row vector on the updates' device."""
    if not isinstance(vec, torch.Tensor):
        raise TypeError(f"{name}: {what} must be a torch.Tensor, got {type(vec).__name__}")
    if tuple(vec.shape) != (n,):
        raise ValueError(f"{name}: {what} must have shape ({n},), got {tuple(vec.shape)}")
    if vec.device != device:
        raise ValueError(f"{name}: {what} is on {vec.device}, updates on {device}")
    if integer and vec.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: {what} must be int32 or int64, got {vec.dtype}")
    if not integer and not vec.dtype.is_floating_point:
        raise TypeError(f"{name}: {what} must be floating point, got {vec.dtype}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``: kernels queue behind its work.

    PyTorch's caching allocator hands a freed block only to work queued
    later on the same stream, so a wrapper may drop the temporaries it
    passed to a launch (weights, row lists) as soon as the launch is
    queued."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(code: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch, or (a
    negative code) refused its inputs before launching."""
    if code < 0:
        raise RuntimeError(f"{name}: the C entry refused its inputs before any launch (code {code})")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")
