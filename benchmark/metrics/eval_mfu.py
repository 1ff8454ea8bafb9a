"""% of the card's float32 peak in evaluation: the counted products of a
ranking pass (``lib/counts``) times the passes of the untraced stretch,
over its seconds."""

from benchmark.lib.readers import mfu


def read(ctx):
    return mfu(ctx, "eval")
