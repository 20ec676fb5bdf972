"""Milliseconds a traced round in which the card idles while the round's
members are paged in: the innermost open span is ``page_in``
(``PagedShardStore.ensure`` and the slots' upload); from the spans pass
(``bench/spans.py``)."""
from bench import spans


def read(ctx):
    return spans.fl_idle_ms(ctx, "page")
