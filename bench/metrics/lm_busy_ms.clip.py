"""Device-busy milliseconds a step (the program's ``tokens_trained`` over
the tokens a step) of the operations launched while an edge's ``clip``
span (``clip_by_global_norm_``) was innermost-open; from the spans pass
(``bench/spans.py``)."""
from bench import spans


def read(ctx):
    return spans.lm_busy_ms(ctx, "clip", per="step")
