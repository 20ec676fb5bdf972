"""Share of the traced window in which no device operation ran, training cell."""


def read(ctx):
    return ctx["trace"].idle_pct()
