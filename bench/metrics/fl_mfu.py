"""The cohort epoch's model FLOP utilization: the 1-D CNN's forward and
backward FLOPs over every sample trained in the measured window, divided
by the window (host clock) and by the card's float32 peak (TF32 is off)."""
from bench import roofline


def read(ctx):
    c = ctx["counters"]
    if not c.get("window_samples"):
        return None
    flops = roofline.cnn_train_flops_per_sample(ctx["cell"].config["model"]) * c["window_samples"]
    return roofline.mfu_pct(flops, c["window_s"], roofline.PEAK_FP32_FLOPS)
