"""Device-busy milliseconds a step (the program's ``tokens_trained`` over
the tokens a step) of the operations launched while an edge's
``loss_grad`` span (``_value_and_grad``: the forward, the chunked loss
and the backward) was innermost-open; from the spans pass
(``bench/spans.py``)."""
from bench import spans


def read(ctx):
    return spans.lm_busy_ms(ctx, "loss_grad", per="step")
