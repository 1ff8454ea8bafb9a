"""Reads of a device value that block the host, a ranking pass: the port's
``utils/profiling.py:host_reads`` (each query batch's metric sums,
``ops/ranking.py:rank_metrics``), over every pass the run made (the
set-up pass, the window's and the profiled ones), which all read alike.  A
program without the counter, or a count the passes do not divide, reads
nothing."""


def read(ctx):
    if ctx.kind != "eval":
        return None
    from kgc_gcn_torch.utils import profiling
    reads = getattr(profiling, "host_reads", None)
    passes = 1 + ctx.untraced_units + ctx.traced_units
    if not reads or reads % passes:
        return None
    return reads / passes
