"""Milliseconds a traced round in which the card idles outside the
assignment, the page-in and the eval: ``cloud_round``'s own time, the
cohort epoch's, edge FedAvg's and the cloud reduce's spans, and the
harness's loop between rounds; from the spans pass (``bench/spans.py``).
With the other three it sums to the traced window's idle time a round."""
from bench import spans


def read(ctx):
    return spans.fl_idle_ms(ctx, "other")
