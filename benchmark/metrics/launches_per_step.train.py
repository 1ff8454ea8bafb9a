"""Kernel launches the host makes per training step: the launch calls of
the CUDA runtime in the profiled stretch over its steps."""

from benchmark.lib.readers import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx, "train")
