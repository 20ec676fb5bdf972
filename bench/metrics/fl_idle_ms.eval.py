"""Milliseconds a traced round in which the card idles while the global
model is evaluated: the innermost open span is ``eval`` (``evaluate`` and
its host reads); from the spans pass (``bench/spans.py``)."""
from bench import spans


def read(ctx):
    return spans.fl_idle_ms(ctx, "eval")
