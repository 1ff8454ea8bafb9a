from typing import Optional, Union

import torch

from kgc_gcn_torch.config import Config
from kgc_gcn_torch.models.mgcn import MGCN
from kgc_gcn_torch.models.rgat import RGAT
from kgc_gcn_torch.models.rgcn import RGCN

__all__ = ["MGCN", "RGAT", "RGCN", "build_model"]


def _unported(cfg: Config):
    """(flag, ROADMAP.md §1 item, refused) for each setting the port cannot
    run yet."""
    return [
        (f"entity_sharded={cfg.entity_sharded!r}", 8,
         cfg.entity_sharded != "none"),
    ]


def build_model(cfg: Config, n_ent: int, n_rel: int, n_edge: int,
                e_pad: Optional[int] = None,
                generator: Optional[torch.Generator] = None
                ) -> Union[MGCN, RGCN, RGAT]:
    """Model factory (``cfg.model``: mgcn | rgcn | rgat).  ``e_pad`` must equal the
    Graph's padded per-half edge count when the graph was built with a
    non-default ``pad_to`` (MGCN's per-edge table); the model is initialized
    on the CPU from ``generator`` (default: seeded from ``cfg.seed``) and
    moved with ``.to(device)``."""
    if cfg.model not in ("mgcn", "rgcn", "rgat"):
        raise ValueError(f"unknown model family: {cfg.model!r}")
    for flag, item, bad in _unported(cfg):
        if bad:
            raise NotImplementedError(
                f"{flag} is not ported to kgc_gcn_torch yet "
                f"(ROADMAP.md §1 item {item})")
    if cfg.model == "rgcn":
        return RGCN(cfg, n_ent, n_rel, n_edge, generator)
    if cfg.model == "rgat":
        return RGAT(cfg, n_ent, n_rel, n_edge, generator)
    return MGCN(cfg, n_ent, n_rel, n_edge, e_pad, generator)
