"""K7 (``ops/basis.py:basis_segment_sum`` -> ``csrc/basis_rgcn.cu``, passes
``basis_sum_kernel`` and ``basis_fixup_kernel``): Σ bound / Σ device time
over its calls in the profiled training stretch."""

from benchmark.lib.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, "train", "basis_sum",
                        ("basis_sum_kernel", "basis_fixup_kernel"))
