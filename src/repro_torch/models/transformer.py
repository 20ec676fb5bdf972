"""Model assembly for attention-only dense stacks.

The port of ``src/repro/models/transformer.py``, in its parameter layout::

    {
      "embed":      {"emb": (V, d)},
      "blocks":     tuple over block positions (one, for a dense stack); each
                    element is a dict whose leaves have a leading n_blocks axis,
      "final_norm": {...},
      "lm_head":    {"emb": (V, d)} (absent if tied),
    }

Caches mirror it: a tuple of ``{"k", "v"}`` dicts, each (n_blocks, B,
max_seq, Hkv, D).  Where the reference scans the stacked blocks with
``lax.scan``, the port loops over the layer axis in Python, taking views of
each layer's slice.

The other families (moe, hybrid mamba, ssm rwkv, encdec, vlm) load their
configs but raise ``NotImplementedError`` here (ROADMAP.md Queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import apply_norm, embed, embedding_init, norm_init, unembed


# ---------------------------------------------------------------------------
# block structure
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str  # attn | mamba | rwkv
    is_moe: bool
    cross: bool = False  # add cross-attention (encoder-decoder decoder)


def block_spec(cfg: ModelConfig) -> Tuple[List[LayerSpec], int]:
    """Return (per-position layer specs within one block, n_blocks)."""
    kinds = cfg.layer_kinds()
    block = cfg.hybrid_block if cfg.family == "hybrid" else 1
    n_blocks = cfg.n_layers // block
    specs = [
        LayerSpec(kind=kinds[pos], is_moe=cfg.is_moe_layer(pos), cross=(cfg.family == "encdec"))
        for pos in range(block)
    ]
    return specs, n_blocks


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a family the port does not carry yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (ROADMAP.md Queue 1 "
            "item 10); the port runs attention-only dense stacks"
        )


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _layer(block, l: int):
    """Views of layer ``l`` of a stacked block (parameters or caches)."""
    return _tree_map(lambda a: a[l], block)


# ---------------------------------------------------------------------------
# single layer init/apply
# ---------------------------------------------------------------------------
def layer_init(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec):
    if spec.kind != "attn" or spec.is_moe or spec.cross:
        raise NotImplementedError(f"layer {spec} is not ported yet (ROADMAP.md Queue 1 item 10)")
    dt, dev = cfg.param_dtype, gen.device
    return {
        "norm1": norm_init(cfg.d_model, dt, cfg.norm, device=dev),
        "mixer": attn.attn_init(gen, cfg),
        "norm2": norm_init(cfg.d_model, dt, cfg.norm, device=dev),
        "ffn": mlpm.mlp_init(gen, cfg),
    }


def _stacked_layers(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec, n: int):
    """n layers drawn one at a time into preallocated (n, ...) leaves, so
    only one layer's draws are alive beside the stack."""
    first = layer_init(gen, cfg, spec)
    stacked = _tree_map(lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype, device=a.device), first)

    def put(dst, src, l):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, l)
            else:
                dst[k][l].copy_(v)

    put(stacked, first, 0)
    for l in range(1, n):
        put(stacked, layer_init(gen, cfg, spec), l)
    return stacked


def _zeros(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def layer_apply_full(p, cfg: ModelConfig, spec: LayerSpec, x, positions, *, window=None):
    """Full-sequence layer. Returns (x, aux, z); aux and z, the MoE losses,
    are 0 for a dense layer."""
    h = apply_norm(p["norm1"], x, cfg.norm_eps)
    h = attn.full_attention(p["mixer"], cfg, h, positions, window=window)
    x = x + h
    h = apply_norm(p["norm2"], x, cfg.norm_eps)
    return x + mlpm.mlp(p["ffn"], cfg, h), _zeros(x), _zeros(x)


def layer_apply_decode(p, cfg: ModelConfig, spec: LayerSpec, x, cache, position, *, window=None, slot=None):
    """One-token decode. ``cache`` is this layer's ``{"k", "v"}`` dict of
    (B, S, Hkv, D) views; returns (x, cache).

    ``position`` (B,) is each row's logical token position (RoPE + validity);
    ``slot`` (B,) its cache-buffer slot — they differ for left-padded ragged
    batches, where every row writes the shared slot ``max_len + step`` but
    row i's token logically sits at ``len_i + step``.  Defaults to
    ``position``.

    The reference returns a new cache (``.at[bidx, slot].set``); here the
    token's k and v are written into the cache in place, which saves a copy
    of the whole cache per layer and step.
    """
    if slot is None:
        slot = position
    h = apply_norm(p["norm1"], x, cfg.norm_eps)
    # one projection for q, k and v (the reference projects twice, through
    # project_decode_kv and decode_attention, and XLA merges the two)
    q, k_new, v_new = attn.qkv_project(p["mixer"], cfg, h, positions=position[..., None])
    bidx = torch.arange(x.shape[0], device=x.device)
    cache["k"][bidx, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v_new[:, 0].to(cache["v"].dtype)
    h = attn.decode_attend(p["mixer"], q, cache["k"], cache["v"], position, window=window, slot=slot)
    x = x + h
    h = apply_norm(p["norm2"], x, cfg.norm_eps)
    return x + mlpm.mlp(p["ffn"], cfg, h), cache


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, on ``gen``'s device.

    The draws are not those of the reference's ``init_params(PRNGKey)``:
    the two generators differ.  Tests carry the reference's parameters
    across instead (``repro_torch.convert``)."""
    cfg.validate()
    require_ported(cfg)
    specs, n_blocks = block_spec(cfg)
    params: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype),
        "blocks": tuple(_stacked_layers(gen, cfg, spec, n_blocks) for spec in specs),
        "final_norm": norm_init(cfg.d_model, cfg.param_dtype, cfg.norm, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _positions(tokens: torch.Tensor) -> torch.Tensor:
    return torch.arange(tokens.shape[1], device=tokens.device)[None, :]


def forward_hidden(params, cfg: ModelConfig, tokens):
    """Like ``forward`` but stops at the final norm: returns (hidden, aux)."""
    require_ported(cfg)
    specs, n_blocks = block_spec(cfg)
    x = embed(params["embed"], tokens)
    positions = _positions(tokens)
    aux = z = _zeros(x)
    for l in range(n_blocks):
        for pos, spec in enumerate(specs):
            x, a, zz = layer_apply_full(
                _layer(params["blocks"][pos], l), cfg, spec, x, positions, window=cfg.sliding_window
            )
            aux, z = aux + a, z + zz
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    return x, {"moe_aux": aux, "moe_z": z}


def forward(params, cfg: ModelConfig, tokens):
    """tokens: (B, S) int -> (logits (B, S, V) fp32, aux_losses dict)."""
    x, aux = forward_hidden(params, cfg, tokens)
    head = params.get("lm_head", params["embed"])
    return unembed(head, x), aux


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that also fills the decode caches
# ---------------------------------------------------------------------------
def layer_apply_prefill(p, cfg: ModelConfig, spec: LayerSpec, x, positions, max_seq, *, pad_mask=None):
    """Full-sequence layer that returns (x, cache) for decode handoff: the
    layer's k and v, zero-padded to ``max_seq`` slots, in the param dtype."""
    h = apply_norm(p["norm1"], x, cfg.norm_eps)
    h, k, v = attn.full_attention(
        p["mixer"], cfg, h, positions, window=cfg.sliding_window, return_kv=True, pad_mask=pad_mask
    )
    pad = max_seq - x.shape[1]
    cache = {
        "k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)).to(cfg.param_dtype),
        "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).to(cfg.param_dtype),
    }
    x = x + h
    hh = apply_norm(p["norm2"], x, cfg.norm_eps)
    return x + mlpm.mlp(p["ffn"], cfg, hh), cache


def prefill(params, cfg: ModelConfig, tokens, *, max_seq=None, positions=None, pad_mask=None):
    """Process the prompt, returning (last-position logits, decode cache).

    max_seq: cache capacity (>= prompt length); defaults to prompt length.
    positions: (B, S) per-slot LOGICAL positions (defaults to ``arange``);
        left-padded ragged batches pass ``max(slot - n_pads_row, 0)`` so RoPE
        sees each row's true token positions.
    pad_mask: (B, S) bool, True at real tokens — excludes left-pad slots
        from the attention key set.
    """
    require_ported(cfg)
    specs, n_blocks = block_spec(cfg)
    if pad_mask is not None and any(s.kind != "attn" for s in specs):
        raise ValueError(
            "pad-masked prefill requires an attention-only stack; "
            f"{cfg.name} has recurrent layers — use exact-length batches"
        )
    max_seq = max_seq or tokens.shape[1]
    x = embed(params["embed"], tokens)
    if positions is None:
        positions = _positions(tokens)
    cache = init_cache(cfg, tokens.shape[0], max_seq, device=tokens.device)
    for l in range(n_blocks):
        for pos, spec in enumerate(specs):
            x, c = layer_apply_prefill(
                _layer(params["blocks"][pos], l), cfg, spec, x, positions, max_seq, pad_mask=pad_mask
            )
            cache[pos]["k"][l] = c["k"]
            cache[pos]["v"][l] = c["v"]
    x = apply_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return unembed(head, x), cache


# ---------------------------------------------------------------------------
# decode caches + serve step
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device="cuda"):
    """Zeroed per-block-position caches (leading n_blocks axis)."""
    require_ported(cfg)
    dev = resolve_device(device)
    specs, n_blocks = block_spec(cfg)
    shape = (n_blocks, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return tuple(
        {"k": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
         "v": torch.zeros(shape, dtype=cfg.param_dtype, device=dev)}
        for _ in specs
    )


def decode_step(params, cfg: ModelConfig, token, cache, position, *, slot=None):
    """token: (B, 1) int; position: (B,) int logical token position.

    ``slot`` (B,) — the cache-buffer slot each row's k/v lands in —
    defaults to ``position``.  Left-padded ragged batches pass the shared
    buffer slot while ``position`` stays per-row.

    Returns (logits (B, 1, V) fp32, cache); the cache is updated in place
    (``layer_apply_decode``) and returned.
    """
    require_ported(cfg)
    specs, n_blocks = block_spec(cfg)
    x = embed(params["embed"], token)
    for l in range(n_blocks):
        for pos, spec in enumerate(specs):
            x, _ = layer_apply_decode(
                _layer(params["blocks"][pos], l), cfg, spec, x, _layer(cache[pos], l), position,
                window=cfg.sliding_window, slot=slot,
            )
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return unembed(head, x), cache
