"""% of the card's float32 peak in the training step: the counted products
of a step (``lib/counts``) times the steps of the untraced stretch, over
its seconds."""

from benchmark.lib.readers import mfu


def read(ctx):
    return mfu(ctx, "train")
