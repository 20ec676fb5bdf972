"""Operations, bytes and peaks: the benchmark's yardstick.

Every count here comes from shapes alone, never from the program.  A
kernel's roofline share is the least time the chip could take for the
work (the larger of operations over peak rate and bytes over peak
bandwidth, each input read once and each output written once) divided by
the kernel's measured device time.  A model FLOP utilization counts the
operations the forward and backward passes require, no recomputation.

Peaks are NVIDIA's H100 SXM data sheet, dense rates at the full 700 W
power limit; each traced run records the card's own limit beside them.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet (dense, no sparsity)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # CUDA cores: the port keeps TF32 off
PEAK_HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int64": 8, "int32": 4}


def roofline_seconds(flops: float, bytes_moved: float, peak_flops: float) -> float:
    """The least time of a kernel: operations at the peak rate or bytes at
    the memory rate, whichever takes longer."""
    return max(flops / peak_flops, bytes_moved / PEAK_HBM_BYTES_PER_S)


# --- the paper's 1-D CNN -----------------------------------------------------
def cnn_layer_dims(cfg: dict) -> dict:
    """Lengths and widths of the 1-D CNN: 'same' convolutions, each
    followed by a max-pool of 2 that drops an odd trailing element."""
    l1 = cfg["seq_len"]
    l2 = l1 // 2
    flat = (l2 // 2) * cfg["c2"]
    return {"l1": l1, "l2": l2, "flat": flat}


def cnn_params(cfg: dict) -> int:
    dims = cnn_layer_dims(cfg)
    k, cin, c1, c2, h, n = cfg["kernel"], cfg["in_channels"], cfg["c1"], cfg["c2"], cfg["hidden"], cfg["n_classes"]
    return (k * cin * c1 + c1) + (k * c1 * c2 + c2) + (dims["flat"] * h + h) + (h * n + n)


def cnn_forward_flops(cfg: dict) -> int:
    """Multiply-adds (x2) of one sample's forward: the two convolutions
    over every output position and the two dense layers."""
    dims = cnn_layer_dims(cfg)
    k, cin, c1, c2, h, n = cfg["kernel"], cfg["in_channels"], cfg["c1"], cfg["c2"], cfg["hidden"], cfg["n_classes"]
    conv1 = 2 * dims["l1"] * k * cin * c1
    conv2 = 2 * dims["l2"] * k * c1 * c2
    return conv1 + conv2 + 2 * dims["flat"] * h + 2 * h * n


def cnn_train_flops_per_sample(cfg: dict) -> int:
    """Forward and backward (the backward twice the forward: the
    gradients of the activations and of the weights)."""
    return 3 * cnn_forward_flops(cfg)


# --- the FedAvg kernels ------------------------------------------------------
def segment_aggregate_bytes(n: int, d: int, e: int, dtype: str = "float32", id_dtype: str = "int64") -> int:
    """Edge FedAvg, (N, D) -> (E, D): the updates, the ids and the weights
    read once, the edge rows written once."""
    b = DTYPE_BYTES[dtype]
    return n * d * b + e * d * b + n * DTYPE_BYTES[id_dtype] + n * 4


def segment_aggregate_flops(n: int, d: int) -> int:
    return 2 * n * d


def hier_aggregate_bytes(n: int, d: int, dtype: str = "float32") -> int:
    """One weighted average, (N, D) -> (D,): the updates and weights read
    once, the row written once."""
    b = DTYPE_BYTES[dtype]
    return n * d * b + d * b + n * 4


def hier_aggregate_flops(n: int, d: int) -> int:
    return 2 * n * d


# --- a dense decoder (phi3-mini) -----------------------------------------------
def lm_layer_matmul_params(cfg: dict) -> int:
    """Weights of one decoder layer's products: q, k, v, o and the SwiGLU
    MLP's three."""
    d, h, kv, ff = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["intermediate_size"]
    dh = d // h
    return d * h * dh + 2 * d * kv * dh + h * dh * d + 3 * d * ff


def lm_params(cfg: dict, layers: int | None = None) -> int:
    """Every parameter: two (V, d) tables (untied), per layer its products
    and two norm scales, the final norm."""
    n = cfg["num_hidden_layers"] if layers is None else layers
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    tables = v * d * (1 if cfg.get("tie_word_embeddings") else 2)
    return n * (lm_layer_matmul_params(cfg) + 2 * d) + tables + d


def lm_matmul_params(cfg: dict) -> int:
    """Parameters that take part in a product: the layers' and the output
    head (the input table is a lookup)."""
    return cfg["num_hidden_layers"] * lm_layer_matmul_params(cfg) + cfg["vocab_size"] * cfg["hidden_size"]


def lm_attention_flops_fwd(cfg: dict, seq: int) -> int:
    """Causal attention of one sequence, forward: the score and value
    products over the lower triangle, every layer and head."""
    d = cfg["hidden_size"]
    return cfg["num_hidden_layers"] * 2 * 2 * (seq * seq // 2) * d


def lm_train_flops(cfg: dict, batch: int, seq: int) -> int:
    """One training step's model FLOPs: 6 x matmul parameters x tokens
    plus three times the causal attention's forward."""
    return 6 * lm_matmul_params(cfg) * batch * seq + 3 * batch * lm_attention_flops_fwd(cfg, seq)


def mfu_pct(flops: float, seconds: float, peak: float) -> float:
    return 100.0 * flops / (seconds * peak)


def roofline_pct(flops: float, bytes_moved: float, seconds: float, peak_flops: float) -> float:
    if seconds <= 0 or not math.isfinite(seconds):
        raise ValueError(f"kernel time {seconds!r}")
    return 100.0 * roofline_seconds(flops, bytes_moved, peak_flops) / seconds
