"""Device-busy milliseconds a step (the program's ``tokens_trained`` over
the tokens a step) of the operations launched while an edge's ``adam``
span (``optimizer.update_``, the sliced in-place Adam) was
innermost-open; from the spans pass (``bench/spans.py``)."""
from bench import spans


def read(ctx):
    return spans.lm_busy_ms(ctx, "adam", per="step")
