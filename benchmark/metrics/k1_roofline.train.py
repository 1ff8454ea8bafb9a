"""K1 (``ops/segment_sum.py`` -> ``csrc/segment_sum.cu``, passes
``chunk_sums`` and ``row_fixup``) in training: Σ bound / Σ device time over
its calls in the profiled stretch."""

from benchmark.lib.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, "train", "seg_sum", ("chunk_sums", "row_fixup"))
