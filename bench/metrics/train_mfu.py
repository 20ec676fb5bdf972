"""The per-edge steps' model FLOP utilization: 6 x matmul parameters x
tokens plus the causal attention, every edge's tokens of every step in
the measured window, divided by the window (host clock) and by the
card's bf16 peak."""
from bench import roofline


def read(ctx):
    c = ctx["counters"]
    if not c.get("steps"):
        return None
    flops = roofline.lm_train_flops(ctx["cell"].config, c["batch"], c["seq"]) * c["edges"] * c["steps"]
    return roofline.mfu_pct(flops, c["window_s"], roofline.PEAK_BF16_FLOPS)
