"""The port's multi-GPU path on ``torch.distributed``: one process per rank,
a ``(data, graph)`` grid of ranks (``mesh.py``), the process set-up and the
collectives with their backward rules (``distributed.py``), and the
edge-partitioned aggregates (``edge_parallel.py``)."""
