"""Experiment configuration (the port's copy of ``kgc_gcn_tpu/config.py``).

One frozen dataclass carries every flag of the reference driver with the same
name and default, plus the JAX package's own fields, so that a ``params.json``
written by either package loads in the other.

``spmm_mode`` (``halves``, ``stacked``, ``stacked_xla``) and ``ew_impl``
(``xla``, ``pallas``) pick MGCN's aggregation schedule, as in the JAX package
(``models/mgcn.py``, ``ops/scatter.py``).  The JAX package takes them only
with ``use_pallas``; the port always runs its kernels on the card, so it
reads them whatever ``use_pallas`` says.

``use_pallas`` marks the JAX package's kernel path: with it the opt-in bf16
cotangent streams (``KGC_MGCN_CONTRIB``, ``KGC_EDGE_CONTRIB``,
``KGC_BASIS_READBACK``) apply where they apply in the JAX package, and
MGCN's ``bwd_perm`` ``operands`` and ``fwdw`` take the backward's products
off K4b, as the JAX package takes them off its kernel; the port computes
``contrib``'s gradients for all three.

Fields that only steer the JAX package's TPU schedules are accepted and have
no effect here: ``prng_impl``, ``compile_cache_dir``, ``conv_impl``,
``rel_compose``, ``remat`` and ``scan_epoch``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Config:
    # ---- experiment / driver (reference main.py:19-28) ----
    dataset: str = "WN18RR"
    seed: int = 19960326
    restore_dir: Optional[str] = None
    restore_torch: Optional[str] = None  # reference last.ckpt to import
    batch_size: int = 128
    max_epoch: int = 500
    min_epoch: int = 50
    eval_every: int = 1
    ckpt_every: int = 0
    patience: float = 0.001          # min improvement counted as progress
    patience_num: int = -1           # early-stop after this many stale evals (<=0: off)

    # ---- optimizer (reference main.py:29-31, 43, 217-219) ----
    learning_rate: float = 0.001
    weight_decay: float = 0.0
    lbl_smooth: float = 0.1
    clip_grad: float = 1.0
    lr_step_size: int = 10           # StepLR(step_size=10, gamma=0.995), main.py:219
    lr_gamma: float = 0.995
    lr_schedule: str = "step"        # step | cosine | constant
    warmup_epochs: int = 0

    # ---- model: MGCN encoder (reference main.py:33-36) ----
    bias: bool = False
    gcn_in_dim: int = 100
    gcn_out_dim: int = 200
    gcn_drop: float = 0.3
    conv_drop: float = 0.1           # MGCNConv internal dropout (model.py:49,57)

    # ---- model: ConvE decoder (reference main.py:37-42) ----
    hidden_drop: float = 0.3
    feat_drop: float = 0.3
    k_w: int = 10
    k_h: int = 20
    num_filter: int = 200
    kernel_size: int = 7

    # ---- model family selection ----
    composition: str = "mult"        # mult | sub | corr
    model: str = "mgcn"              # mgcn | rgcn | rgat
    num_heads: int = 1
    decoder: str = "conve"           # conve | distmult | transe | complex | rotate
    num_layers: int = 1
    num_bases: int = 0
    num_blocks: int = 0

    # ---- training mode ----
    train_mode: str = "one_vs_all"   # one_vs_all | negative_sampling
    num_negatives: int = 64
    neg_loss: str = "bce"            # bce | margin | self_adversarial
    neg_margin: float = 1.0
    neg_adversarial_temp: float = 1.0
    edge_sample_size: int = 0

    # ---- execution ----
    compute_dtype: str = "float32"   # float32 | bfloat16: matmul operands and
                                     # aggregation messages; sums stay float32
    moment_dtype: str = "float32"    # Adam moment storage (training)
    conv_impl: str = "im2col"        # no effect on the port
    use_pallas: bool = False         # bwd_perm and the bf16 streams apply
    spmm_mode: str = "halves"        # halves | stacked | stacked_xla (MGCN)
    agg_schedule: str = "fused"      # fused | reference (bench-only schedule)
    ew_impl: str = "xla"             # xla | pallas (MGCN halves: K4a/K4b)
    bwd_perm: str = "contrib"        # contrib | operands | fwdw: one schedule
    rel_compose: str = "gather"      # no effect on the port
    loss_impl: str = "auto"          # auto | dense | sparse | fused (training)
    prng_impl: str = "rbg"           # no effect on the port
    remat: bool = False              # no effect on the port
    scan_epoch: bool = True          # no effect on the port
    eval_batch_size: int = 0         # 0: use batch_size
    data_axis: int = 1
    graph_axis: int = 1
    entity_sharded: str = "none"     # none | gather | ring | boundary
    partition: str = "contiguous"    # contiguous | locality

    # ---- bookkeeping ----
    do_train: bool = False
    do_test: bool = False
    experiments_dir: str = "experiments"
    data_dir: str = "data"
    compile_cache_dir: str = ""      # no effect on the port

    @property
    def label_key(self) -> str:
        return f"{self.dataset}-labels"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=4)

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


# Tuned values from the reference's experiment snapshots (reference
# experiments/<ds>/params.json), with the JAX package's kernel and dtype
# profile: FB15k-237 runs bf16 matmul operands and aggregation messages.
_PRESETS = {
    "WN18RR": dict(learning_rate=0.002, max_epoch=500, eval_every=2,
                   gcn_drop=0.2, feat_drop=0.2, hidden_drop=0.3,
                   use_pallas=True),
    "FB15k-237": dict(learning_rate=0.003, max_epoch=400, eval_every=2,
                      gcn_drop=0.2, feat_drop=0.2, hidden_drop=0.3,
                      use_pallas=True, compute_dtype="bfloat16",
                      moment_dtype="bfloat16"),
    "Toy": dict(seed=2020, batch_size=2, max_epoch=500, min_epoch=500,
                eval_every=1, patience=0.01, patience_num=10),
}


def dataset_preset(dataset: str, **overrides) -> Config:
    """Config with per-dataset tuned defaults, reference-compatible."""
    kw = dict(_PRESETS.get(dataset, {}))
    kw["dataset"] = dataset
    kw.update(overrides)
    return Config(**kw)
