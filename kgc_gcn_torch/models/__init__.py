from typing import Optional

import torch

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.models.mgcn import MGCN

__all__ = ["MGCN", "build_model"]


def _unported(cfg: Config):
    """(flag, ROADMAP.md §1 item) for each setting the port cannot run yet."""
    item = {"rgat": 6, "rgcn": 7}.get(cfg.model, 4)
    return [
        (f"model={cfg.model!r}", item, cfg.model != "mgcn"),
        (f"decoder={cfg.decoder!r}", 4, cfg.decoder != "conve"),
        (f"num_layers={cfg.num_layers}", 4, cfg.num_layers > 1),
        (f"composition={cfg.composition!r}", 4, cfg.composition != "mult"),
        (f"agg_schedule={cfg.agg_schedule!r}", 4, cfg.agg_schedule != "fused"),
        (f"entity_sharded={cfg.entity_sharded!r}", 8,
         cfg.entity_sharded != "none"),
    ]


def build_model(cfg: Config, n_ent: int, n_rel: int, n_edge: int,
                e_pad: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> MGCN:
    """Model factory.  ``e_pad`` must equal the Graph's padded per-half edge
    count when the graph was built with a non-default ``pad_to``; the model
    is initialized on the CPU from ``generator`` (default: seeded from
    ``cfg.seed``) and moved with ``.to(device)``."""
    for flag, item, bad in _unported(cfg):
        if bad:
            raise NotImplementedError(
                f"{flag} is not ported to kgc_gcn_torch yet "
                f"(ROADMAP.md §1 item {item})")
    return MGCN(cfg, n_ent, n_rel, n_edge, e_pad, generator)
