"""Batched serving engine: static-batch prefill + greedy lock-step decode.

The port of ``src/repro/serving/engine.py``.  Fixed-capacity batch slots,
greedy sampling, per-slot stop lengths.  Prefill fills the KV caches for a
batch of prompts; decode steps all active slots in lock-step.

Ragged batches (mixed prompt lengths) are exact — batched output is
token-identical to serving each request alone: an attention-only stack
runs ONE left-padded prefill with a pad mask and per-slot position
offsets, then decodes with a shared buffer slot but per-row logical
positions.  A uniform batch (one prompt length) runs the plain prefill,
which is where ``cfg.use_flash`` sends attention to the flash kernel; the
pad-masked prefill never does.  Stacks with recurrent layers need one
exact-length prefill per distinct length (``_prefill_bucketed``), which is
not ported yet.

:meth:`swap` repoints the parameter tree between ``run`` calls (hot-swap
under traffic).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import configure_numerics, resolve_device
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import block_spec, decode_step, prefill, require_ported
from repro_torch.telemetry import NULL_TELEMETRY, coerce_telemetry


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (L,) int32 token ids
    max_new_tokens: int = 16
    out: Optional[np.ndarray] = None
    # set when the engine clamped max_new_tokens to the cache capacity
    # (on_overflow="truncate"); with the default on_overflow="error" an
    # over-capacity request raises instead of silently shortening `out`
    truncated: bool = False


class ServeEngine:
    """Greedy batched decoding for one ``ModelConfig`` on one device.

    params: a parameter tree on ``device`` (``repro_torch.convert`` carries
        one across from numpy), or None to draw one with
        ``torch.Generator(device).manual_seed(seed)`` — not the reference's
        ``jax.random`` draws, so the same seed gives other weights than the
        reference's engine.
    on_overflow: what to do when a request cannot fit its prompt plus
        ``max_new_tokens`` generated tokens into ``max_seq`` cache slots —
        ``"error"`` (default) raises up front; ``"truncate"`` clamps the
        budget and sets ``Request.truncated``.  The left-padded ragged
        layout shares buffer slots across rows, so its capacity bound is
        ``max(prompt_len) + max(max_new_tokens) <= max_seq``; uniform
        batches bound per row.
    device: ``"cuda"`` (default) or ``"cpu"``; without CUDA the default
        raises (``repro_torch.device``).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params=None,
        *,
        max_seq: int = 256,
        seed: int = 0,
        telemetry=None,
        on_overflow: str = "error",
        device="cuda",
    ):
        if on_overflow not in ("error", "truncate"):
            raise ValueError(f"on_overflow must be 'error'|'truncate', got {on_overflow!r}")
        self.device = resolve_device(device)
        configure_numerics(self.device)
        require_ported(cfg)
        self.cfg = cfg
        if params is None:
            params = init_params(torch.Generator(self.device).manual_seed(seed), cfg)
        self.params = params
        self.max_seq = max_seq
        self.on_overflow = on_overflow
        specs, _ = block_spec(cfg)
        self._recurrent = any(s.kind != "attn" for s in specs)
        self.tel = coerce_telemetry(telemetry) or NULL_TELEMETRY
        self.version = None  # opaque tag of the currently served model

    def swap(self, params, *, version=None) -> None:
        """Hot-swap the served parameter tree (same config and shapes).

        ``version`` is an opaque tag (e.g. the cloud round the tree came
        from) used for staleness accounting.
        """
        with self.tel.span("swap", model=self.cfg.name):
            self.params = params
            self.version = version

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _prefill(self, toks, **kw):
        return prefill(self.params, self.cfg, self._tokens(toks), max_seq=self.max_seq, **kw)

    # -- prefill layouts ------------------------------------------------
    def _prefill_ragged_attn(self, requests, lens, plen):
        """One left-padded prefill with pad mask + per-slot position offsets."""
        b = len(requests)
        offs = plen - lens  # (B,) left-pad count per row
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(requests):
            toks[i, offs[i]:] = r.prompt
        slots = np.arange(plen)[None, :]
        positions = np.maximum(slots - offs[:, None], 0)
        pad_mask = torch.as_tensor(slots >= offs[:, None], device=self.device)
        return self._prefill(toks, positions=self._tokens(positions), pad_mask=pad_mask)

    def _prefill_bucketed(self, requests, lens):
        """Exact-length prefill per distinct prompt length (recurrent stacks)."""
        raise NotImplementedError(
            "exact-length bucketed prefill serves recurrent stacks, which are not ported yet "
            "(ROADMAP.md Queue 1 item 11)"
        )

    # -- serving --------------------------------------------------------
    def run(self, requests: List[Request]) -> List[Request]:
        if not requests:
            return requests
        tel = self.tel
        b = len(requests)
        lens = np.asarray([len(r.prompt) for r in requests], np.int32)
        if (lens < 1).any():
            raise ValueError("empty prompt")
        plen = int(lens.max())
        if plen > self.max_seq:
            raise ValueError(f"prompt length {plen} exceeds max_seq={self.max_seq}")
        ragged = bool((lens != plen).any())
        # buffer layout: exact-length rows start decoding at their own
        # length; a left-padded ragged batch shares the buffer high-water
        # slot, so every row starts at max(lens)
        aligned = (not ragged) or self._recurrent
        starts = lens if aligned else np.full(b, plen, np.int32)
        # capacity: each row stores its prompt plus budget-1 generated
        # tokens (the last token is emitted, never cached), so
        # `start + budget <= max_seq` is a safe uniform bound, tight at
        # `plen + max_new_tokens == max_seq`
        want = np.asarray([r.max_new_tokens for r in requests], np.int32)
        if (want < 1).any():
            raise ValueError("max_new_tokens must be >= 1")
        cap = self.max_seq - starts
        if (want > cap).any():
            if self.on_overflow == "error":
                i = int(np.argmax(want - cap))
                raise ValueError(
                    f"request {i}: prompt ({lens[i]}) + max_new_tokens "
                    f"({want[i]}) exceeds max_seq={self.max_seq}"
                    + ("" if aligned else
                       " (left-padded ragged batches share buffer slots: "
                       "the bound is max(prompt_len) + max_new_tokens)")
                )
            budgets = np.minimum(want, np.maximum(cap, 1))
        else:
            budgets = want
        for i, r in enumerate(requests):
            r.truncated = bool(budgets[i] < want[i])
        if (budgets < 1).any() or (starts >= self.max_seq).any():
            raise ValueError(f"no cache room to generate any token (max_seq={self.max_seq})")
        with torch.inference_mode():
            with tel.span("prefill", model=self.cfg.name, batch=b, prompt_len=plen) as sp:
                if not ragged:
                    cost = tel.jit_cost("serve_prefill", self._prefill)
                    if cost:
                        sp.set(**cost)
                    logits, cache = self._prefill(np.stack([r.prompt for r in requests]))
                elif self._recurrent:
                    logits, cache = self._prefill_bucketed(requests, lens)
                else:
                    logits, cache = self._prefill_ragged_attn(requests, lens, plen)
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                outs = [tok[:, 0].cpu().numpy()]  # host sync: the span covers real prefill work
                sp.set(tokens=b)  # prefill emits one token per slot
            budget = int(budgets.max())
            starts_t = self._tokens(starts)
            lens_t = self._tokens(lens)
            with tel.span("decode", model=self.cfg.name, batch=b) as sp:
                steps = 0
                emitted = 0  # decode-emitted tokens actually kept in some `out`
                for i in range(budget - 1):
                    pos = lens_t + i  # per-row logical position of the new token
                    # per-row buffer slot; rows already past their own budget
                    # keep stepping (lock-step batch) — clamp them in-bounds,
                    # their outputs are sliced away below
                    slot = torch.clamp(starts_t + i, max=self.max_seq - 1)
                    if steps == 0:
                        cost = tel.jit_cost("serve_decode_step", decode_step)
                        if cost:
                            sp.set(**cost)
                    logits, cache = decode_step(self.params, self.cfg, tok, cache, pos, slot=slot)
                    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                    outs.append(tok[:, 0].cpu().numpy())
                    steps += 1
                    emitted += int((budgets > i + 1).sum())
                sp.set(steps=steps, tokens=emitted)
        gen = np.stack(outs, axis=1).astype(np.int32)  # (b, T)
        for i, r in enumerate(requests):
            r.out = gen[i, : budgets[i]]
        return requests
