"""A dense decoder's initial weights, made from the seed on the device.

One draw per stacked tensor (every layer's copy of a weight in one
(n_layers, ...) call), in the layout of the published model's products
(``w`` (d_in, d_out)): normal(0, 1/sqrt(d_in)) for the products,
normal(0, 0.02) for the two vocabulary tables, ones for the RMSNorm
scales.  Drawn in float32 and cast to the served dtype.  Nothing here
imports the program.
"""
from __future__ import annotations

import numpy as np
import torch


def init_weights(seed: int, cfg: dict, device="cpu", dtype=torch.bfloat16) -> dict:
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed((int(seed) + 0x1A) % (1 << 63))
    n, d, h = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["num_attention_heads"]
    kv, ff, v = cfg["num_key_value_heads"], cfg["intermediate_size"], cfg["vocab_size"]
    dh = d // h

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    layers = {
        "norm1": {"scale": ones((n, d))},
        "mixer": {
            "wq": {"w": normal((n, d, h * dh), 1 / np.sqrt(d))},
            "wk": {"w": normal((n, d, kv * dh), 1 / np.sqrt(d))},
            "wv": {"w": normal((n, d, kv * dh), 1 / np.sqrt(d))},
            "wo": {"w": normal((n, h * dh, d), 1 / np.sqrt(h * dh))},
        },
        "norm2": {"scale": ones((n, d))},
        "ffn": {
            "wi": {"w": normal((n, d, ff), 1 / np.sqrt(d))},
            "wg": {"w": normal((n, d, ff), 1 / np.sqrt(d))},
            "wo": {"w": normal((n, ff, d), 1 / np.sqrt(ff))},
        },
    }
    params = {"embed": {"emb": normal((v, d), 0.02)}, "blocks": (layers,), "final_norm": {"scale": ones((d,))}}
    if not cfg.get("tie_word_embeddings"):
        params["lm_head"] = {"emb": normal((v, d), 0.02)}
    return params


# (name in the reference, path in the layout, stacked over layers)
LAYER_LEAVES = (
    ("norm1", ("norm1", "scale")),
    ("wq", ("mixer", "wq", "w")),
    ("wk", ("mixer", "wk", "w")),
    ("wv", ("mixer", "wv", "w")),
    ("wo", ("mixer", "wo", "w")),
    ("norm2", ("norm2", "scale")),
    ("wi", ("ffn", "wi", "w")),
    ("wg", ("ffn", "wg", "w")),
    ("w2", ("ffn", "wo", "w")),
)


def leaves(tree: dict, n_layers: int, lead: tuple = ()) -> dict:
    """{leaf name: tensor} of a weight tree in the layout above, every
    stacked weight split into its layers ("L3.wq"); ``lead`` indexes any
    leading axes first (an edge replica's)."""
    out = {"embed": tree["embed"]["emb"][lead], "final_norm": tree["final_norm"]["scale"][lead]}
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]["emb"][lead]
    blk = tree["blocks"][0]
    for name, path in LAYER_LEAVES:
        x = blk
        for k in path:
            x = x[k]
        x = x[lead]
        for layer in range(n_layers):
            out[f"L{layer}.{name}"] = x[layer]
    return out
