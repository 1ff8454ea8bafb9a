"""K8 (``ops/basis.py:basis_backward`` -> ``csrc/basis_rgcn.cu``,
``basis_bwd_kernel``): Σ bound / Σ device time over its calls in the
profiled training stretch."""

from benchmark.lib.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, "train", "basis_bwd", ("basis_bwd_kernel",))
