"""``adam_update``'s share of its roofline in the per-edge Adam: one launch
a leaf an edge a step, its bytes from the shapes alone (p, g, m and v read
once, p, m and v written once: 22 bytes a parameter for bf16 parameters
and gradients with fp32 moments), its time the traced kernels'.  Its ~14
fp32 operations an element are far below the card's rate, so the bound is
the bytes'.  None unless the trace holds exactly one launch a leaf an edge
a step of the traced window (``sync_every`` steps a traced sync)."""
import re

from bench import roofline

NAME = re.compile(r"(?<![A-Za-z_])adam_update_kernel")


def step_bytes(config: dict, leaf_sizes, edges: int) -> int:
    """Bytes one step's updates of every edge's replica move."""
    p = roofline.DTYPE_BYTES[config["torch_dtype"]]
    g = p  # the gradients come in the parameters' dtype
    mom = roofline.DTYPE_BYTES[config["training"]["moments"]]
    read, written = p + g + 2 * mom, p + 2 * mom
    return edges * sum(leaf_sizes) * (read + written)


def read(ctx):
    trace, c, cell = ctx["trace"], ctx["counters"], ctx["cell"]
    count, secs = trace.op_seconds(lambda n: bool(NAME.search(n)))
    steps = cell.traffic["sync_every"] * c.get("traced_syncs", 0)
    if count == 0 or count != steps * c["edges"] * len(c["leaf_sizes"]):
        return None
    moved = steps * step_bytes(cell.config, c["leaf_sizes"], c["edges"])
    return roofline.roofline_pct(0, moved, secs, roofline.PEAK_FP32_FLOPS)
