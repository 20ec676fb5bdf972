"""Milliseconds a traced round in which the card idles while the cohort is
drawn and its step buckets planned: the innermost open span is
``assignment`` or its ``cohort_draw`` (``CohortSpec.draw``) or
``batch_plan`` (``StreamCohortPlan.draw``); from the spans pass
(``bench/spans.py``)."""
from bench import spans


def read(ctx):
    return spans.fl_idle_ms(ctx, "assign")
