"""The yardstick's counts against hand counts and against PyTorch's own
FLOP counter."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_smoke
from bench import harness, roofline
from bench.reference import fl as ref_fl
from bench.reference import lm as ref_lm

CNN = harness.load_json(bench_smoke.ROOT / "bench/configs/heartbeat-cnn1d-iot.json")["model"]
PHI3 = harness.load_json(bench_smoke.ROOT / "bench/configs/phi3-mini-3.8b-hfl5.json")


def test_cnn_counts_by_hand():
    # conv1: 187 outputs x 16 channels x 5 taps; conv2: 93 x 16 x (5 x 16); fc1 736 x 32; fc2 32 x 5
    fwd = 2 * (187 * 16 * 5 + 93 * 16 * 80 + 736 * 32 + 32 * 5)
    assert roofline.cnn_forward_flops(CNN) == fwd == 315_424
    assert roofline.cnn_train_flops_per_sample(CNN) == 3 * fwd
    assert roofline.cnn_params(CNN) == 25_141


def test_cnn_forward_against_the_flop_counter():
    init = ref_fl.flat_params({k: {kk: torch.zeros_like(vv) for kk, vv in v.items()}
                               for k, v in __import__("bench.gen.health", fromlist=["x"]).cnn_init(1, CNN).items()})
    x = torch.zeros(3, CNN["seq_len"], CNN["in_channels"])
    with FlopCounterMode(display=False) as fc:
        ref_fl.forward(init, x)
    assert fc.get_total_flops() == 3 * roofline.cnn_forward_flops(CNN)


def test_fedavg_bytes_by_hand():
    n, d, e = 4096, 25_141, 8
    assert roofline.segment_aggregate_bytes(n, d, e) == n * d * 4 + e * d * 4 + n * 8 + n * 4
    assert abs(roofline.segment_aggregate_bytes(n, d, e) / roofline.PEAK_HBM_BYTES_PER_S - 0.1233e-3) < 1e-6
    leaf = 8 * 3072 * 8192
    assert roofline.hier_aggregate_bytes(5, leaf, "bfloat16") == 5 * leaf * 2 + leaf * 2 + 5 * 4


def test_phi3_counts_by_hand():
    layer = 4 * 3072 * 3072 + 3 * 3072 * 8192
    assert roofline.lm_layer_matmul_params(PHI3) == layer == 113_246_208
    assert roofline.lm_params(PHI3) == 1_103_023_104  # 8 layers, the configuration's cut
    assert roofline.lm_params(PHI3, layers=32) == 3_821_079_552  # the published model
    tokens = 1024
    attn = 8 * 2 * 2 * (1024 * 1024 // 2) * 3072
    assert roofline.lm_train_flops(PHI3, 1, tokens) == 6 * (8 * layer + 32064 * 3072) * tokens + 3 * attn


def test_train_flops_against_the_flop_counter():
    cfg = dict(PHI3, **bench_smoke.LM_SMOKE_CONFIG)
    dec = ref_lm.Decoder(cfg)
    from bench.gen import lm as gen_lm

    w = {k: v.float().requires_grad_(True) for k, v in
         gen_lm.leaves(gen_lm.init_weights(3, cfg, dtype=torch.float32), cfg["num_hidden_layers"]).items()}
    b, s = 2, 32
    tok = torch.randint(0, cfg["vocab_size"], (b, s))
    with FlopCounterMode(display=False) as fc:
        dec.loss(w, tok, tok).backward()
    # the reference computes the whole score matrix, the count its causal half
    full_attention = 3 * b * roofline.lm_attention_flops_fwd(cfg, s)
    assert fc.get_total_flops() == roofline.lm_train_flops(cfg, b, s) + full_attention
