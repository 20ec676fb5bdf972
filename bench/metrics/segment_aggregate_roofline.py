"""``hier_segment_aggregate``'s share of its roofline at the edge FedAvg:
one launch a round over the round's (cohort, D) fp32 rows into E edge
rows, its bytes from the shapes, its time the traced kernels'."""
import re

from bench import roofline

NAME = re.compile(r"segment_aggregate_kernel")


def read(ctx):
    trace, c = ctx["trace"], ctx["counters"]
    count, secs = trace.op_seconds(lambda n: bool(NAME.search(n)))
    if count == 0 or count != c["traced_rounds"]:
        return None
    n, d, e = c["cohort"], c["dim"], c["edges"]
    flops = count * roofline.segment_aggregate_flops(n, d)
    moved = count * roofline.segment_aggregate_bytes(n, d, e)
    return roofline.roofline_pct(flops, moved, secs, roofline.PEAK_FP32_FLOPS)
