"""Seconds of the program's data layer in set-up: the dataset from the id
triples (``data/dataset.py``), the graph (``data/graph.py``,
``utils/native.py``), the query banks (``data/batching.py``) and their move
to the card, by the host clock around those calls."""


def read(ctx):
    return ctx.data_setup_s
