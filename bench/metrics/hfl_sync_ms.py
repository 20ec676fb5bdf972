"""What a sync step costs over a local one: the median sync step less the
median local step of the measured window (host clock; each step ends in
the host read of its loss)."""
from bench import harness


def read(ctx):
    c = ctx["counters"]
    if not c.get("sync_s") or not c.get("local_s"):
        return None
    return 1e3 * (harness.median(c["sync_s"]) - harness.median(c["local_s"]))
