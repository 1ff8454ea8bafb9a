"""The port's multi-GPU path on ``torch.distributed``: one process per rank,
a ``(data, graph)`` grid of ranks (``mesh.py``), the process set-up and the
collectives with their backward rules (``distributed.py``), the
edge-partitioned aggregates (``edge_parallel.py``) and the entity-sharded
schedules (``entity_sharding.py``: gather and ring in ``edge_parallel.py``,
boundary in ``boundary.py``)."""
