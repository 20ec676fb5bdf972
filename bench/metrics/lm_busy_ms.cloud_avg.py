"""Device-busy milliseconds a sync step (the program's ``sync_steps``) of
the operations launched while the ``cloud_avg`` span (``cloud_avg_``: a
``hier_aggregate`` launch a leaf and the copies back into every replica)
was innermost-open; from the spans pass (``bench/spans.py``)."""
from bench import spans


def read(ctx):
    return spans.lm_busy_ms(ctx, "cloud_avg", per="sync")
