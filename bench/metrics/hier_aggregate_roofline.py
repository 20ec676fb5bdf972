"""``hier_aggregate``'s share of its roofline at the replicas' average:
one launch a leaf at each sync step, E bf16 replicas of the leaf into one
row, its bytes from the shapes, its time the traced kernels'."""
import re

from bench import roofline

NAME = re.compile(r"(?<![A-Za-z_])aggregate_kernel")


def read(ctx):
    trace, c = ctx["trace"], ctx["counters"]
    count, secs = trace.op_seconds(lambda n: bool(NAME.search(n)))
    sizes = c["leaf_sizes"]
    if count == 0 or count != c["traced_syncs"] * len(sizes):
        return None
    dtype = ctx["cell"].config["torch_dtype"]
    flops = c["traced_syncs"] * sum(roofline.hier_aggregate_flops(c["edges"], d) for d in sizes)
    moved = c["traced_syncs"] * sum(roofline.hier_aggregate_bytes(c["edges"], d, dtype) for d in sizes)
    return roofline.roofline_pct(flops, moved, secs, roofline.PEAK_BF16_FLOPS)
