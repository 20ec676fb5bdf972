"""Model assembly for every family: dense, vlm, MoE, hybrid (Mamba), ssm
(RWKV) and encdec (whisper).

The port of ``src/repro/models/transformer.py``, in its parameter layout::

    {
      "embed":      {"emb": (V, d)},
      "blocks":     tuple over block positions (one, for a dense stack); each
                    element is a dict whose leaves have a leading n_blocks axis,
      "final_norm": {...},
      "lm_head":    {"emb": (V, d)} (absent if tied),
      # encdec only:
      "enc_blocks": a one-tuple of n_encoder_layers stacked layers,
      "enc_final_norm": {...},
    }

Caches mirror it: a tuple over block positions of dicts whose leaves have a
leading n_blocks axis: ``{"k", "v"}`` (n_blocks, B, max_seq, Hkv, D) for
an attention layer (plus ``"cross_k"``, ``"cross_v"`` (n_blocks, B, F,
Hkv, D), the encoder's cross-attention K and V, for an encdec decoder
layer), ``{"h", "conv"}`` for a Mamba layer and ``{"s", "x_prev"}`` for an
RWKV layer (the recurrent states in fp32, whatever the model's dtype, as
the reference's).  Where the reference scans the stacked blocks with
``lax.scan``, the port loops over the layer axis in Python, taking views
of each layer's slice; with ``cfg.remat`` under autograd each layer runs
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``, per
layer).

A vlm config runs as the dense stack it is: as in the reference, no model
code reads its ``n_patch_tokens``.  An MoE layer's feed-forward block is a
routed expert bank (``models.moe``): the full-sequence layers (``forward``,
``prefill``) take the capacity dispatch from 4096 tokens a call (under
``torch.func.vmap`` that is one mapped call's B * S, as in the reference),
else the dense dispatch; ``decode_step`` always takes the dense dispatch,
as the reference does.  The serving functions (``prefill``,
``decode_step``) take the dense dispatch's combine weights from the
``topk_gating`` kernel, ``forward`` from ``router_topk``.  A hybrid stack
(jamba) repeats a block of one attention layer and ``hybrid_block - 1``
Mamba layers (``models.mamba``), an ssm stack is RWKV layers
(``models.rwkv``).  An encdec stack (whisper) runs a bidirectional
encoder over precomputed frame embeddings (``enc_embeds`` (B, F, d), the
stub frontend's), and each decoder layer adds cross-attention to the
encoder output after its causal self-attention; ``cfg.use_flash`` sends
the decoder's self-attention to the kernel, never the encoder's.
``forward`` writes into no tensor in place and reads no value back to the
host, so it runs under ``torch.func.vmap`` with autograd (the federated LM,
MoE, Mamba and RWKV cohorts).  Given DTensor parameters (the sharded train
step, the dry run; under ``distributed.axes.sharding_hints``) every
function keeps the residual stream in the ``"batch"`` layout
(``constrain``) and runs the parts DTensor does not cover on local shards
(``distributed.axes.on_shards``); plain tensors take the paths above.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.axes import constrain, is_dtensor, on_batch_shards, on_shards, redistribute_to, spec_of
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem
from repro_torch.models import rwkv as rwk
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import apply_norm, dense, embed, embedding_init, norm_init, unembed


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


# from this many tokens in one call an MoE layer takes the capacity dispatch
GROUPED_DISPATCH_TOKENS = 4096
# the encoder's layers: bidirectional self-attention, no cross-attention
ENCODER_SPEC = LayerSpec(kind="attn", is_moe=False, cross=False)


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
_MIXER_INIT = {"attn": attn.attn_init, "mamba": mam.mamba_init, "rwkv": rwk.rwkv_init}


def layer_init(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec, *, causal: bool = True):
    dt, dev = cfg.param_dtype, gen.device
    p = {
        "norm1": norm_init(cfg.d_model, dt, cfg.norm, device=dev),
        "mixer": _MIXER_INIT[spec.kind](gen, cfg),
        "norm2": norm_init(cfg.d_model, dt, cfg.norm, device=dev),
        "ffn": moem.moe_init(gen, cfg) if spec.is_moe else mlpm.mlp_init(gen, cfg),
    }
    if spec.cross and causal:  # an encdec decoder layer gets cross-attention
        p["norm_x"] = norm_init(cfg.d_model, dt, cfg.norm, device=dev)
        p["cross"] = attn.attn_init(gen, cfg, cross=True)
    return p


def _stacked_layers(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec, n: int, *, causal: bool = True):
    """n layers drawn one at a time into preallocated (n, ...) leaves, so
    only one layer's draws are alive beside the stack."""
    first = layer_init(gen, cfg, spec, causal=causal)
    stacked = _tree_map(lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype, device=a.device), first)

    def put(dst, src, l):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, l)
            else:
                dst[k][l].copy_(v)

    put(stacked, first, 0)
    for l in range(1, n):
        put(stacked, layer_init(gen, cfg, spec, causal=causal), l)
    return stacked


def _zeros(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _grouped(h: torch.Tensor) -> bool:
    return h.shape[0] * h.shape[1] >= GROUPED_DISPATCH_TOKENS


def layer_apply_full(p, cfg: ModelConfig, spec: LayerSpec, x, positions, *, enc_kv=None, window=None,
                     causal=True):
    """Full-sequence layer. Returns (x, aux, z); aux and z, the MoE losses,
    are 0 for a dense layer.  ``causal=False`` is the encoder's
    bidirectional attention (plain ``sdpa``, no mask); ``enc_kv``, the
    encoder's (k, v) for this layer, adds the cross-attention residual."""
    h = apply_norm(p["norm1"], x, cfg.norm_eps)
    if spec.kind == "attn":
        if causal:
            h = attn.full_attention(p["mixer"], cfg, h, positions, window=window)
        else:
            q, k, v = attn.qkv_project(p["mixer"], cfg, h, positions)
            o = attn._on_heads(lambda q, k, v: attn.sdpa(q, attn._repeat_kv(k, cfg.q_per_kv),
                                                         attn._repeat_kv(v, cfg.q_per_kv), mask=None), q, k, v)
            h = dense(p["mixer"]["wo"], attn._merge_heads(o))
    elif spec.kind == "mamba":
        h = mam.mamba_mixer(p["mixer"], cfg, h)
    else:
        h = rwk.rwkv_mixer(p["mixer"], cfg, h)
    x = x + constrain(h, "batch")
    if "cross" in p and enc_kv is not None:
        h = apply_norm(p["norm_x"], x, cfg.norm_eps)
        x = x + constrain(attn.cross_attention(p["cross"], cfg, h, enc_kv), "batch")
    h = apply_norm(p["norm2"], x, cfg.norm_eps)
    if not spec.is_moe:
        return x + constrain(mlpm.mlp(p["ffn"], cfg, h), "batch"), _zeros(x), _zeros(x)
    h, aux, z = moem.moe_ffn(p["ffn"], cfg, h, grouped=_grouped(h))
    return x + constrain(h, "batch"), aux, z


def _ffn_serve(p, cfg: ModelConfig, spec: LayerSpec, h, *, capacity: bool):
    """The feed-forward block of the serving functions: with ``capacity``
    (the prefill layer), an MoE layer's capacity dispatch from 4096 tokens
    a call; otherwise its dense dispatch with the ``topk_gating`` kernel's
    combine weights (decode, at any batch, as the reference).  The router
    losses are dropped, as the reference drops them there."""
    if not spec.is_moe:
        return mlpm.mlp(p["ffn"], cfg, h)
    if capacity and _grouped(h):
        tg = moem.group_shape(h.shape[0], h.shape[1])[1]  # the whole batch's groups, on each rank's rows
        fn = lambda q, c, x, **kw: moem.moe_mlp_grouped(q, c, x, group=tg, **kw)[0]  # noqa: E731
    else:
        fn = moem.moe_mlp_serve
    if is_dtensor(h):  # each rank's tokens and experts
        return moem.moe_sharded(fn, p["ffn"], cfg, h)
    return fn(p["ffn"], cfg, h)


def _flat_step(step, p, cfg, h, state, keys):
    """A recurrent decode step's (out, *new state in ``keys`` order)."""
    out, new = step(p, cfg, h, state)
    return (out,) + tuple(new[k] for k in keys)


def layer_apply_decode(p, cfg: ModelConfig, spec: LayerSpec, x, cache, position, *, window=None, slot=None):
    """One-token decode. ``cache`` is this layer's dict of views: ``{"k",
    "v"}`` (B, S, Hkv, D) for attention, the recurrent state otherwise;
    returns (x, cache).

    ``position`` (B,) is each row's logical token position (RoPE + validity);
    ``slot`` (B,) its cache-buffer slot — they differ for left-padded ragged
    batches, where every row writes the shared slot ``max_len + step`` but
    row i's token logically sits at ``len_i + step``.  Defaults to
    ``position``.

    The reference returns a new cache (``.at[bidx, slot].set``, or the
    mixer's new state); here the token's k and v, or the new recurrent
    state, are written into the cache's views in place, which saves a copy
    of the whole cache per layer and step.
    """
    if slot is None:
        slot = position
    h = apply_norm(p["norm1"], x, cfg.norm_eps)
    if spec.kind == "attn":
        # one projection for q, k and v (the reference projects twice, through
        # project_decode_kv and decode_attention, and XLA merges the two)
        q, k_new, v_new = attn.qkv_project(p["mixer"], cfg, h, positions=position[..., None])
        if is_dtensor(cache["k"]):
            h = attn.decode_write_attend_sharded(p["mixer"], q, k_new, v_new, cache["k"], cache["v"], position,
                                                 window=window, slot=slot)
        else:
            bidx = torch.arange(x.shape[0], device=x.device)
            cache["k"][bidx, slot] = k_new[:, 0].to(cache["k"].dtype)
            cache["v"][bidx, slot] = v_new[:, 0].to(cache["v"].dtype)
            h = attn.decode_attend(p["mixer"], q, cache["k"], cache["v"], position, window=window, slot=slot)
    else:
        step = mam.mamba_decode_step if spec.kind == "mamba" else rwk.rwkv_decode_step
        if is_dtensor(h):  # data-parallel, the weights gathered, the state back in the cache's layout
            keys = sorted(cache)
            out = on_batch_shards(lambda p, h, *st: _flat_step(step, p, cfg, h, dict(zip(keys, st)), keys),
                                  p["mixer"], h, *(cache[k] for k in keys))
            h, new_state = out[0], dict(zip(keys, out[1:]))
            new_state = {k: redistribute_to(v, spec_of(cache[k])) for k, v in new_state.items()}
        else:
            h, new_state = step(p["mixer"], cfg, h, cache)
        for key, value in new_state.items():
            cache[key].copy_(value)
    x = x + constrain(h, "batch")
    if "cross" in p and "cross_k" in cache:
        h = apply_norm(p["norm_x"], x, cfg.norm_eps)
        x = x + constrain(attn.cross_attention(p["cross"], cfg, h, (cache["cross_k"], cache["cross_v"])), "batch")
    h = apply_norm(p["norm2"], x, cfg.norm_eps)
    return x + constrain(_ffn_serve(p, cfg, spec, h, capacity=False), "batch"), cache


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, on ``gen``'s device.

    The draws are not those of the reference's ``init_params(PRNGKey)``:
    the two generators differ.  Tests carry the reference's parameters
    across instead (``repro_torch.convert``)."""
    cfg.validate()
    specs, n_blocks = block_spec(cfg)
    params: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype),
        "blocks": tuple(_stacked_layers(gen, cfg, spec, n_blocks) for spec in specs),
        "final_norm": norm_init(cfg.d_model, cfg.param_dtype, cfg.norm, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype)
    if cfg.family == "encdec":
        params["enc_blocks"] = (_stacked_layers(gen, cfg, ENCODER_SPEC, cfg.n_encoder_layers, causal=False),)
        params["enc_final_norm"] = norm_init(cfg.d_model, cfg.param_dtype, cfg.norm, device=gen.device)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _positions(tokens: torch.Tensor) -> torch.Tensor:
    return torch.arange(tokens.shape[1], device=tokens.device)[None, :]


def _n_stacked(blocks) -> int:
    """The leading (layer) axis of a stacked block tuple."""
    leaf = blocks[0]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def _scan_blocks(blocks, cfg: ModelConfig, specs, x, positions, *, enc_out=None, causal=True):
    """Every layer of the stacked ``blocks`` over x: returns (x, aux, z).

    With ``enc_out`` each layer that has cross-attention computes its
    encoder K and V from it (inside the layer, as the reference's
    ``_scan_blocks_with_cross``).  With ``cfg.remat`` under autograd each
    layer runs under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward instead of kept, as the reference's
    ``jax.checkpoint`` (per layer, for single- and multi-layer blocks)."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux = z = _zeros(x)
    for l in range(_n_stacked(blocks)):
        for pos, spec in enumerate(specs):
            p = _layer(blocks[pos], l)

            def layer(x, p=p, spec=spec):
                kv = attn.encoder_kv(p["cross"], cfg, enc_out) if enc_out is not None and "cross" in p else None
                return layer_apply_full(p, cfg, spec, x, positions, enc_kv=kv, window=cfg.sliding_window,
                                        causal=causal)

            x, a, zz = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
            aux, z = aux + a, z + zz
    return x, aux, z


def _require_enc(cfg: ModelConfig, enc_embeds) -> None:
    if enc_embeds is None:
        raise ValueError(f"{cfg.name}: an encdec model needs enc_embeds (B, n_audio_frames, d_model)")


def encode(params, cfg: ModelConfig, enc_embeds):
    """Whisper encoder over precomputed frame embeddings (B, F, d)."""
    pos = torch.arange(enc_embeds.shape[1], device=enc_embeds.device)[None, :]
    x, _, _ = _scan_blocks(params["enc_blocks"], cfg, [ENCODER_SPEC], enc_embeds, pos, causal=False)
    return apply_norm(params["enc_final_norm"], x, cfg.norm_eps)


def forward_hidden(params, cfg: ModelConfig, tokens, *, enc_embeds=None):
    """Like ``forward`` but stops at the final norm: returns (hidden, aux)."""
    specs, _ = block_spec(cfg)
    x = constrain(embed(params["embed"], tokens), "batch")
    enc_out = None
    if cfg.family == "encdec":
        _require_enc(cfg, enc_embeds)
        enc_out = encode(params, cfg, constrain(enc_embeds.to(x.dtype), "batch"))
    x, aux, z = _scan_blocks(params["blocks"], cfg, specs, x, _positions(tokens), enc_out=enc_out)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    return x, {"moe_aux": aux, "moe_z": z}


def forward(params, cfg: ModelConfig, tokens, *, enc_embeds=None):
    """tokens: (B, S) int -> (logits (B, S, V) fp32, aux_losses dict).

    For encdec, ``enc_embeds`` (B, F, d) are the stub frontend's frame
    embeddings; each decoder layer computes its cross-attention K and V
    from the one encoder output."""
    x, aux = forward_hidden(params, cfg, tokens, enc_embeds=enc_embeds)
    head = params.get("lm_head", params["embed"])
    return unembed(head, x), aux


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that also fills the decode caches
# ---------------------------------------------------------------------------
def _pad_slots(t, pad: int, dtype):
    """(B, S, H, D) k or v zero-padded to S + ``pad`` slots, in ``dtype``;
    a DTensor on its shards (its sequence is whole on every rank)."""
    fn = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)).to(dtype)  # noqa: E731
    if is_dtensor(t):
        return on_shards(fn, (t,), (spec_of(t),), (spec_of(t),))
    return fn(t)


def _stack_layers(values):
    """A DTensor prefill's per-layer caches stacked on a leading layer axis,
    on the shards."""
    from repro_torch.distributed.sharding import P

    spec = spec_of(values[0])
    return on_shards(lambda *v: torch.stack(v), tuple(values), (spec,) * len(values), (P(None, *spec),))


def layer_apply_prefill(p, cfg: ModelConfig, spec: LayerSpec, x, positions, max_seq, *, enc_kv=None,
                        pad_mask=None):
    """Full-sequence layer that returns (x, cache) for decode handoff: an
    attention layer's k and v, zero-padded to ``max_seq`` slots, in the
    param dtype (and, given ``enc_kv``, its cross-attention K and V as
    ``cross_k``, ``cross_v``); a recurrent layer's final state."""
    h = apply_norm(p["norm1"], x, cfg.norm_eps)
    if spec.kind == "mamba":
        h, cache = mam.mamba_mixer(p["mixer"], cfg, h, return_state=True)
    elif spec.kind == "rwkv":
        h, cache = rwk.rwkv_mixer(p["mixer"], cfg, h, return_state=True)
    else:
        h, k, v = attn.full_attention(
            p["mixer"], cfg, h, positions, window=cfg.sliding_window, return_kv=True, pad_mask=pad_mask
        )
        pad = max_seq - x.shape[1]
        cache = {"k": _pad_slots(k, pad, cfg.param_dtype), "v": _pad_slots(v, pad, cfg.param_dtype)}
    x = x + constrain(h, "batch")
    if "cross" in p and enc_kv is not None:
        hq = apply_norm(p["norm_x"], x, cfg.norm_eps)
        x = x + constrain(attn.cross_attention(p["cross"], cfg, hq, enc_kv), "batch")
        cache["cross_k"], cache["cross_v"] = enc_kv
    hh = apply_norm(p["norm2"], x, cfg.norm_eps)
    return x + constrain(_ffn_serve(p, cfg, spec, hh, capacity=True), "batch"), cache


def prefill(params, cfg: ModelConfig, tokens, *, max_seq=None, enc_embeds=None, positions=None, pad_mask=None):
    """Process the prompt, returning (last-position logits, decode cache).

    max_seq: cache capacity (>= prompt length); defaults to prompt length.
    enc_embeds: (B, F, d) frame embeddings, required by an encdec model:
        the encoder runs once, and each decoder layer's cross K and V go
        into its cache.
    positions: (B, S) per-slot LOGICAL positions (defaults to ``arange``);
        left-padded ragged batches pass ``max(slot - n_pads_row, 0)`` so RoPE
        sees each row's true token positions.
    pad_mask: (B, S) bool, True at real tokens — excludes left-pad slots
        from the attention key set.  Only attention-only stacks take it:
        pad tokens would enter a Mamba or RWKV recurrence whatever the
        mask, so such stacks serve exact-length batches (``ServeEngine``'s
        buckets) and a mask raises ``ValueError``.
    """
    specs, n_blocks = block_spec(cfg)
    if pad_mask is not None and any(s.kind != "attn" for s in specs):
        raise ValueError(
            "pad-masked prefill requires an attention-only stack; "
            f"{cfg.name} has recurrent layers — use exact-length batches"
        )
    max_seq = max_seq or tokens.shape[1]
    x = constrain(embed(params["embed"], tokens), "batch")
    if positions is None:
        positions = _positions(tokens)
    enc_out = None
    if cfg.family == "encdec":
        _require_enc(cfg, enc_embeds)
        enc_out = encode(params, cfg, enc_embeds.to(x.dtype))
    frames = None if enc_out is None else enc_out.shape[1]
    sharded = is_dtensor(x)
    # a DTensor prefill stacks its layers' caches (DTensor cannot write a
    # shard into a preallocated whole); otherwise they fill the zeroed cache
    cache = [dict() for _ in specs] if sharded else _zeros_cache(cfg, tokens.shape[0], max_seq, tokens.device,
                                                                 frames=frames)
    for l in range(n_blocks):
        for pos, spec in enumerate(specs):
            p = _layer(params["blocks"][pos], l)
            kv = attn.encoder_kv(p["cross"], cfg, enc_out) if enc_out is not None and "cross" in p else None
            x, c = layer_apply_prefill(p, cfg, spec, x, positions, max_seq, enc_kv=kv, pad_mask=pad_mask)
            for key, value in c.items():
                if sharded:
                    cache[pos].setdefault(key, []).append(value)
                else:
                    cache[pos][key][l] = value
    if sharded:
        cache = tuple({k: _stack_layers(v) for k, v in c.items()} for c in cache)
    x = apply_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return unembed(head, x), cache


# ---------------------------------------------------------------------------
# decode caches + serve step
# ---------------------------------------------------------------------------
def _zeros_cache(cfg: ModelConfig, batch: int, max_seq: int, dev: torch.device, *, frames=None):
    """Zeroed per-block-position caches (leading n_blocks axis): k and v in
    the param dtype (with ``frames``, also an encdec layer's ``cross_k``
    and ``cross_v`` over that many encoder frames), the recurrent states in
    fp32.  Every leaf is its own zeroed tensor (the reference broadcasts one
    state over the blocks; a decode step here writes into the views, so no
    two rows or layers may share memory)."""
    specs, n_blocks = block_spec(cfg)
    heads = (cfg.n_kv_heads, cfg.d_head)
    zeros = lambda s: torch.zeros((n_blocks, batch, s) + heads, dtype=cfg.param_dtype, device=dev)  # noqa: E731
    caches = []
    for spec in specs:
        if spec.kind == "attn":
            c = {"k": zeros(max_seq), "v": zeros(max_seq)}
            if spec.cross and frames is not None:
                c["cross_k"], c["cross_v"] = zeros(frames), zeros(frames)
            caches.append(c)
        else:
            state = (mam.mamba_init_state if spec.kind == "mamba" else rwk.rwkv_init_state)(
                cfg, n_blocks * batch, device=dev)
            caches.append({k: v.reshape((n_blocks, batch) + tuple(v.shape[1:])) for k, v in state.items()})
    return tuple(caches)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, enc_embeds=None, params=None, device="cuda"):
    """Zeroed per-block-position caches on ``device`` (``_zeros_cache``).

    For encdec, each decoder layer's cross K and V are computed from the
    encoder output, which needs ``params`` and ``enc_embeds`` (on
    ``device``; ``"meta"`` gives the dry run's shapes)."""
    dev = resolve_device(device, meta=True)
    if cfg.family != "encdec":
        return _zeros_cache(cfg, batch, max_seq, dev)
    if params is None:
        raise ValueError(f"{cfg.name}: an encdec cache needs params to compute its cross K and V")
    _require_enc(cfg, enc_embeds)
    enc_out = encode(params, cfg, enc_embeds.to(cfg.param_dtype))
    caches = _zeros_cache(cfg, batch, max_seq, dev, frames=enc_out.shape[1])
    for pos, c in enumerate(caches):
        for l in range(c["k"].shape[0]):
            c["cross_k"][l], c["cross_v"][l] = attn.encoder_kv(_layer(params["blocks"][pos], l)["cross"], cfg, enc_out)
    return caches


def decode_step(params, cfg: ModelConfig, token, cache, position, *, slot=None):
    """token: (B, 1) int; position: (B,) int logical token position.

    ``slot`` (B,) — the cache-buffer slot each row's k/v lands in —
    defaults to ``position``.  Left-padded ragged batches pass the shared
    buffer slot while ``position`` stays per-row.

    Returns (logits (B, 1, V) fp32, cache); the cache is updated in place
    (``layer_apply_decode``; an encdec layer's cross K and V stay as they
    are) and returned.
    """
    specs, n_blocks = block_spec(cfg)
    x = constrain(embed(params["embed"], token), "batch")
    for l in range(n_blocks):
        for pos, spec in enumerate(specs):
            x, _ = layer_apply_decode(
                _layer(params["blocks"][pos], l), cfg, spec, x, _layer(cache[pos], l), position,
                window=cfg.sliding_window, slot=slot,
            )
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return unembed(head, x), cache
