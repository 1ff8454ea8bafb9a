"""% of the profiled training stretch in which no operation ran on the
card: 1 - (union of device intervals) / (host-clock length)."""

from benchmark.lib.readers import idle


def read(ctx):
    return idle(ctx, "train")
