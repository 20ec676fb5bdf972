"""Top-k MoE router gating: the dense (T, E) combine matrix.

Replaces the Pallas kernel ``topk_gating`` of the reference
(``src/repro/kernels/topk_gating.py``: ``_gate_kernel``).  Nothing on a
model path calls it, in the reference or here: the reference's MoE router
uses ``lax.top_k`` (``src/repro/models/moe.py``).  It is ported so that
every kernel of the reference has its counterpart, and is held to it.

What it computes, per token row: probs = softmax(logits) in fp32; then k
sweeps, each adding the row maximum of what remains to ``total`` and
choosing the first expert (lowest index) at that maximum among those still
> 0, which it removes; the output is probs / max(total, 1e-9) at the chosen
experts and 0 elsewhere.  Fewer than k experts are chosen where
probabilities underflow to 0.

What bounds it on an H100: bytes; the kernel (``csrc/topk_gating.cu``) is
one warp per row with the row in registers, launch-bound at router sizes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.common import check_launch, ptr, stream_of

MAX_EXPERTS = 1024  # 32 lanes x 32 registers (csrc/topk_gating.cu)


def _check(logits, k, name: str) -> int:
    if not isinstance(logits, torch.Tensor):
        raise TypeError(f"{name}: logits must be a torch.Tensor, got {type(logits).__name__}")
    if logits.dim() != 2:
        raise ValueError(f"{name}: logits must be (T, E), got shape {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: logits must be float32 or bfloat16, got {logits.dtype}")
    if int(k) != k or k < 0:
        raise ValueError(f"{name}: k must be a non-negative int, got {k!r}")
    return int(k)


def topk_gating_ref(logits, k: int) -> torch.Tensor:
    """Plain PyTorch version, sweep for sweep as the TPU kernel."""
    k = _check(logits, k, "topk_gating_ref")
    probs = torch.softmax(logits.float(), dim=-1)
    remaining = probs
    picked = torch.zeros_like(probs)
    total = torch.zeros((probs.shape[0], 1), dtype=torch.float32, device=probs.device)
    for _ in range(k):
        top = remaining.amax(dim=-1, keepdim=True)
        is_top = (remaining == top) & (remaining > 0)
        sel = is_top & (torch.cumsum(is_top.to(torch.int32), dim=-1) == 1)  # first max only
        picked = picked + torch.where(sel, probs, 0.0)
        total = total + top
        remaining = torch.where(sel, 0.0, remaining)
    return picked / total.clamp_min(1e-9)


def _launch(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the CUDA kernel on checked, contiguous inputs.  Counts nothing."""
    t, e = logits.shape
    out = torch.empty((t, e), dtype=torch.float32, device=logits.device)
    lib = load_library()
    entry = lib.repro_topk_gating_f32 if logits.dtype == torch.float32 else lib.repro_topk_gating_bf16
    with torch.cuda.device(logits.device):
        code = entry(ptr(logits), ptr(out), t, e, k, stream_of(logits.device))
    check_launch(code, "topk_gating")
    return out


def topk_gating(logits, k: int) -> torch.Tensor:
    """logits: (T, E) float32 or bfloat16 -> combine weights (T, E) fp32,
    zero off the chosen experts.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count one launch in ``topk_gating.launches``) or raise, also for
    E > ``MAX_EXPERTS`` or non-contiguous logits.
    """
    name = "topk_gating"
    k = _check(logits, k, name)
    if logits.device.type == "cpu":
        return topk_gating_ref(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"{name}: logits must lie on the CPU or a CUDA device, got {logits.device}")
    t, e = logits.shape
    if e > MAX_EXPERTS:
        raise ValueError(f"{name}: the CUDA kernel takes at most {MAX_EXPERTS} experts, got {e}")
    if not logits.is_contiguous():
        raise ValueError(f"{name}: logits must be contiguous")
    if t == 0 or e == 0:
        return torch.zeros((t, e), dtype=torch.float32, device=logits.device)
    out = _launch(logits, k)
    topk_gating.launches += 1
    return out


topk_gating.launches = 0
