"""Experiment CLI of the port, flag-compatible with ``kgc_gcn_tpu.cli``.

    python -m kgc_gcn_torch.cli --dataset Toy --do_train [--loss_impl fused]
    python -m kgc_gcn_torch.cli --dataset FB15k-237 --do_train --model rgcn \
        --decoder distmult --num_bases 30 --train_mode negative_sampling \
        --compute_dtype float32 --moment_dtype float32
    python -m kgc_gcn_torch.cli --dataset WN18RR --do_train --model rgat \\
        --decoder distmult --num_heads 4
    python -m kgc_gcn_torch.cli --dataset Toy --do_test --restore_dir experiments/Toy
    python -m kgc_gcn_torch.cli --dataset Toy --do_predict --predict_file q.txt \\
        --restore_dir experiments/Toy

Every flag of the JAX CLI (and so of the reference driver, main.py:18-46) is
accepted with the same name and default.  ``--do_train`` trains MGCN, basis
R-GCN (``--model rgcn``) or RGAT (``--model rgat --num_heads H``) with any
decoder (``--decoder conve|distmult|transe|complex|rotate``); MGCN also at
depth (``--num_layers``), with the ``sub`` and ``corr`` compositions
(``--composition``) and on sampled edges (``--edge_sample_size K``).  It
trains 1-vs-all or on sampled negatives (``--train_mode
negative_sampling``), and writes ``params.json``, ``train.log``,
``metrics.jsonl`` and, on every validation improvement, ``last.ckpt`` under
``<experiments_dir>/<dataset>``; with ``--restore_dir`` it resumes from that
checkpoint, optimizer state included, and ``--init_embeddings`` warm-starts
the embedding tables from an ``.npz`` first.  ``--do_test`` and
``--do_predict`` serve a checkpoint that either package wrote
(``--restore_dir``, whose ``params.json`` supplies the model-shape flags),
or the reference implementation's own PyTorch ``last.ckpt``
(``--restore_torch``; MGCN + ConvE with one layer, which training continues
from with fresh optimizer moments); ``--do_test --per_relation`` also
writes ``per_relation.json``.  ``--profile_dir D`` writes a
``torch.profiler`` trace of training epoch 2 into D; ``--ckpt_every K``
writes ``periodic.ckpt`` every K epochs in the background.
``--device`` (default ``cuda``) picks the card or, when asked for, the CPU.
``--partition locality`` renumbers the entities by graph communities
(``data/partition.py``; recorded in ``params.json`` and adopted on
restore).  ``--data_axis D --graph_axis G`` run on D x G ranks of a launcher
(``torchrun --nproc_per_node D*G -m kgc_gcn_torch.cli ...``; its
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``):
each step's batch is split over D, each half's edges and the per-edge table
over G (``parallel/``); NCCL where each rank has a card of its own, gloo
where ranks share one.  ``--entity_sharded gather|ring|boundary`` (with
``--graph_axis`` > 1) splits the entity rows over the graph ranks too
(``parallel/entity_sharding.py``: MGCN and basis R-GCN on every schedule,
RGAT on ``gather``); ``--do_predict`` serves on one process.
``--spmm_mode`` picks MGCN's aggregation schedule (``ew_impl``, as in the
JAX CLI, has no flag: it is a ``Config`` field).  The flags that steer only
the JAX package's TPU schedules (``--prng_impl``, ``--compile_cache_dir``,
``--rel_compose``, ``--remat``, ``--no_scan_epoch``,
``--use_pallas``, ``--no_use_pallas``) are accepted and have no effect,
except that ``sub``/``corr`` are refused with an explicit ``--use_pallas``
or with ``--edge_sample_size``, as in the JAX CLI, and that with
``use_pallas`` the opt-in bf16 cotangent streams (``KGC_MGCN_CONTRIB``,
``KGC_EDGE_CONTRIB``, ``KGC_BASIS_READBACK``) apply, as in the JAX package
(``--bwd_perm`` computes ``contrib``'s gradients whatever its value;
``config.py`` says where it differs).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

from kgc_gcn_torch.config import Config, dataset_preset
from kgc_gcn_torch.data.batching import make_banks
from kgc_gcn_torch.data.dataset import load_dataset
from kgc_gcn_torch.data.graph import build_graph
from kgc_gcn_torch.data.partition import partition_dataset
from kgc_gcn_torch.models import build_model
from kgc_gcn_torch.models.common import init_embeddings_from_npz
from kgc_gcn_torch.ops.ranking import corpus_from_per_rel
from kgc_gcn_torch.parallel.distributed import (
    launcher_env, maybe_initialize, shutdown)
from kgc_gcn_torch.parallel.mesh import check_mesh_shape, make_mesh, shard_like
from kgc_gcn_torch.serve import Predictor, serve_file, serve_stream
from kgc_gcn_torch.train.checkpoint import load_checkpoint
from kgc_gcn_torch.train.loop import (
    Trainer, evaluate, evaluate_per_relation, log_metrics, train_and_evaluate)
from kgc_gcn_torch.train.negative import NegativeSamplingTrainer
from kgc_gcn_torch.utils.device import resolve_device
from kgc_gcn_torch.utils.logging import set_logger
from kgc_gcn_torch.utils.torch_import import (
    apply_reference_state_dict, params_from_reference_state_dict,
    read_reference_checkpoint)

_NO_EFFECT = "accepted for compatibility with kgc_gcn_tpu; no effect here"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # reference flags (reference main.py:18-46)
    p.add_argument("--dataset", default="WN18RR")
    p.add_argument("--seed", default=19960326, type=int)
    p.add_argument("--restore_dir", default=None,
                   help="run directory holding a JAX npz last.ckpt")
    p.add_argument("--restore_torch", default=None,
                   help="import a reference (PyTorch) last.ckpt file")
    p.add_argument("--init_embeddings", default=None,
                   help="warm-start entity/relation tables from an .npz")
    p.add_argument("--multi_gpu", action="store_true", help=_NO_EFFECT)
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--max_epoch", default=500, type=int)
    p.add_argument("--min_epoch", default=50, type=int)
    p.add_argument("--eval_every", default=1, type=int)
    p.add_argument("--ckpt_every", default=0, type=int)
    p.add_argument("--patience", default=0.001, type=float)
    p.add_argument("--patience_num", default=-1, type=int)
    p.add_argument("--learning_rate", default=0.001, type=float)
    p.add_argument("--lr_schedule", default="step",
                   choices=["step", "cosine", "constant"])
    p.add_argument("--warmup_epochs", default=0, type=int)
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--lbl_smooth", default=0.1, type=float)
    p.add_argument("--num_workers", default=0, type=int, help=_NO_EFFECT)
    p.add_argument("--bias", action="store_true")
    p.add_argument("--gcn_in_dim", default=100, type=int)
    p.add_argument("--gcn_out_dim", default=200, type=int)
    p.add_argument("--gcn_drop", default=0.3, type=float)
    p.add_argument("--hidden_drop", default=0.3, type=float)
    p.add_argument("--feat_drop", default=0.3, type=float)
    p.add_argument("--k_w", default=10, type=int)
    p.add_argument("--k_h", default=20, type=int)
    p.add_argument("--num_filter", default=200, type=int)
    p.add_argument("--kernel_size", default=7, type=int)
    p.add_argument("--clip_grad", default=1.0, type=float)
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_test", action="store_true")
    p.add_argument("--do_predict", action="store_true",
                   help="serve top-k link prediction from a checkpoint")
    p.add_argument("--predict_file", default=None,
                   help="TSV of 'subject relation' query lines for "
                        "--do_predict ('-' streams stdin)")
    p.add_argument("--top_k", default=10, type=int)
    p.add_argument("--per_relation", action="store_true")
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--bi_direction", action="store_false", help=_NO_EFFECT)
    # JAX-package flags
    p.add_argument("--model", default="mgcn", choices=["mgcn", "rgcn", "rgat"])
    p.add_argument("--num_heads", default=1, type=int)
    p.add_argument("--decoder", default="conve",
                   choices=["conve", "distmult", "transe", "complex", "rotate"])
    p.add_argument("--num_layers", default=1, type=int)
    p.add_argument("--composition", default="mult",
                   choices=["mult", "sub", "corr"])
    p.add_argument("--num_bases", default=0, type=int)
    p.add_argument("--num_blocks", default=0, type=int)
    p.add_argument("--train_mode", default="one_vs_all",
                   choices=["one_vs_all", "negative_sampling"])
    p.add_argument("--num_negatives", default=64, type=int)
    p.add_argument("--neg_loss", default="bce",
                   choices=["bce", "margin", "self_adversarial"])
    p.add_argument("--neg_margin", default=1.0, type=float)
    p.add_argument("--neg_adversarial_temp", default=1.0, type=float)
    p.add_argument("--edge_sample_size", default=0, type=int)
    p.add_argument("--loss_impl", default="auto",
                   choices=["auto", "dense", "sparse", "fused"])
    # None default = "not specified": presets may set these, and an explicit
    # flag must override the preset in both directions
    p.add_argument("--moment_dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--prng_impl", default="rbg",
                   choices=["threefry", "rbg", "unsafe_rbg"], help=_NO_EFFECT)
    p.add_argument("--bwd_perm", default="contrib",
                   choices=["contrib", "operands", "fwdw"],
                   help="MGCN backward's permutation schedule; the port "
                        "computes contrib's gradients for all three")
    p.add_argument("--rel_compose", default="gather",
                   choices=["gather", "onehot"], help=_NO_EFFECT)
    p.add_argument("--compute_dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="matmul operands and aggregation messages; sums "
                        "stay float32")
    p.add_argument("--use_pallas", dest="use_pallas", action="store_const",
                   const=True, default=None,
                   help="the JAX package's kernel path: the bf16 streams "
                        "apply")
    p.add_argument("--no_use_pallas", dest="use_pallas",
                   action="store_const", const=False)
    p.add_argument("--spmm_mode", default="halves",
                   choices=["halves", "stacked", "stacked_xla"],
                   help="MGCN's aggregation schedule: per direction half "
                        "(K1), both halves over 2N rows (stacked_xla: K1) or "
                        "fused (stacked: K3)")
    p.add_argument("--remat", action="store_true", help=_NO_EFFECT)
    p.add_argument("--no_scan_epoch", action="store_true", help=_NO_EFFECT)
    p.add_argument("--eval_batch_size", default=0, type=int)
    p.add_argument("--data_axis", default=1, type=int)
    p.add_argument("--graph_axis", default=1, type=int)
    p.add_argument("--entity_sharded", default="none",
                   choices=["none", "gather", "ring", "boundary"])
    p.add_argument("--partition", default="contiguous",
                   choices=["contiguous", "locality"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--experiments_dir", default="experiments")
    p.add_argument("--compile_cache_dir", default="", help=_NO_EFFECT)
    # the port's own
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; fails without a card) "
                        "or cpu")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = dataset_preset(args.dataset)
    overrides = {}
    defaults = build_parser().parse_args([])
    for field in (
        "seed restore_dir restore_torch batch_size max_epoch min_epoch "
        "eval_every ckpt_every patience "
        "patience_num learning_rate lr_schedule warmup_epochs weight_decay "
        "lbl_smooth bias gcn_in_dim "
        "gcn_out_dim gcn_drop hidden_drop feat_drop k_w k_h num_filter "
        "kernel_size clip_grad do_train do_test model decoder num_layers "
        "num_bases num_blocks num_heads composition train_mode num_negatives "
        "neg_loss neg_margin neg_adversarial_temp "
        "edge_sample_size remat "
        "compute_dtype use_pallas spmm_mode loss_impl moment_dtype prng_impl "
        "rel_compose bwd_perm eval_batch_size data_axis graph_axis "
        "entity_sharded partition data_dir experiments_dir compile_cache_dir"
    ).split():
        val = getattr(args, field)
        # explicit CLI values override the preset; untouched defaults do not
        if val != getattr(defaults, field):
            overrides[field] = val
    overrides["scan_epoch"] = not args.no_scan_epoch

    # restoring a checkpoint: adopt the MODEL-SHAPE fields recorded in the
    # run's params.json unless the user passed them explicitly
    if args.restore_dir:
        run_record = os.path.join(args.restore_dir, "params.json")
        if os.path.exists(run_record):
            saved = Config.from_json(run_record)
            shape_fields = (
                "model decoder num_layers num_bases num_blocks num_heads "
                "composition partition "
                "bias gcn_in_dim gcn_out_dim k_w k_h num_filter kernel_size"
            ).split()
            for field in shape_fields:
                if field not in overrides:   # explicit flags still win
                    overrides[field] = getattr(saved, field)
    cfg = cfg.replace(**overrides)

    # a PRESET-sourced use_pallas yields to the flags that the JAX package's
    # kernels cannot serve, as in its CLI (cli.py:244-258: the ring and
    # boundary schedules, a non-halves spmm_mode under a graph axis; the
    # others there are refused here anyway); an explicit --use_pallas still
    # conflicts (models/mgcn.py:check_config raises)
    if cfg.use_pallas and "use_pallas" not in overrides and (
            cfg.entity_sharded in ("ring", "boundary")
            or cfg.composition != "mult" or cfg.edge_sample_size > 0
            or (cfg.spmm_mode != "halves" and cfg.graph_axis > 1)):
        logging.info("preset use_pallas yields to a kernel-incompatible "
                     "flag")
        cfg = cfg.replace(use_pallas=False)
    return cfg


def write_per_relation(cfg: Config, model, graph, banks, relation2id,
                       num_relation: int, model_dir: str,
                       mesh=None) -> None:
    """``--do_test --per_relation`` (``kgc_gcn_tpu/cli.py:424-452``): ONE
    ranking pass gives the per-relation table, written to
    ``<model_dir>/per_relation.json`` (by rank 0 under a ``mesh``), and the
    corpus metrics, logged as the test metrics (their count-weighted mean
    is exact); the five worst and best relations by MRR are logged."""
    per = evaluate_per_relation(cfg, model, graph, banks, "test", mesh=mesh)
    log_metrics("Test", corpus_from_per_rel(per))
    id2rel = {i: r for r, i in relation2id.items() if i < num_relation}
    rows = [{"relation": id2rel[i], "count": int(per["count"][i]),
             **{k: (None if np.isnan(v[i]) else round(float(v[i]), 5))
                for k, v in per.items() if k != "count"}}
            for i in range(num_relation)]
    if mesh is None or mesh.rank == 0:
        with open(os.path.join(model_dir, "per_relation.json"), "w") as f:
            json.dump(rows, f, indent=2)
    ranked = sorted((r for r in rows if r["count"]), key=lambda r: r["mrr"])
    worst = ranked[:5]
    best = [r for r in ranked[-5:] if r not in worst]
    for tag, sel in (("worst", worst), ("best", best)):
        for r in sel:
            logging.info("- per-relation (%s): %s  mrr=%.3f hits@10=%.3f n=%d",
                         tag, r["relation"], r["mrr"], r["hits@10"],
                         r["count"])


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.do_train and cfg.do_test:
        raise ValueError("Can not perform training and testing at one time")
    if ((cfg.do_test or args.do_predict) and cfg.restore_dir is None
            and cfg.restore_torch is None):
        raise ValueError("Must specify restore dir for testing or prediction")
    if args.do_predict and not args.predict_file:
        raise ValueError("--do_predict needs --predict_file")
    if cfg.entity_sharded != "none" and cfg.graph_axis < 2:
        raise ValueError("--entity_sharded needs --graph_axis > 1")
    if args.do_predict and launcher_env():
        raise ValueError("--do_predict serves on one process: run it "
                         "without a launcher (a checkpoint written under "
                         "--data_axis/--graph_axis has the one-device layout)")
    # one process per rank: rank 0 writes the run record and the log file
    lead = os.environ.get("RANK", "0") == "0"
    model_dir = os.path.join(cfg.experiments_dir, cfg.dataset)
    os.makedirs(model_dir, exist_ok=True)
    if lead:
        set_logger(os.path.join(model_dir, "train.log"))
    try:
        return _run(args, cfg, model_dir, lead)
    finally:
        shutdown()


def _run(args: argparse.Namespace, cfg: Config, model_dir: str,
         lead: bool) -> int:
    # join the launcher's process group before any device work
    # (kgc_gcn_tpu/cli.py:295-357,401-408); a no-op without a launcher
    dist_info = maybe_initialize(args.device)
    device = resolve_device(str(dist_info.device) if dist_info is not None
                            else args.device)
    mesh = None
    if dist_info is not None or cfg.data_axis * cfg.graph_axis > 1:
        mesh = make_mesh(cfg.data_axis, cfg.graph_axis, device)
    logging.info("device: %s (%s)", device, torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "host CPU")
    ref_sd = None
    if cfg.restore_torch is not None:
        if (cfg.model, cfg.decoder, cfg.num_layers) != ("mgcn", "conve", 1):
            raise ValueError("--restore_torch imports the reference "
                             "architecture only (model=mgcn decoder=conve "
                             "num_layers=1)")
        ref_sd, ref_measure = read_reference_checkpoint(cfg.restore_torch)
        # the imported tree brings ConvE's conv bias or not, whatever the
        # flag says (kgc_gcn_tpu/utils/torch_import.py:88-90)
        cfg = cfg.replace(bias="conv2.conv_e.bias" in ref_sd)
    if lead:
        cfg.to_json(os.path.join(model_dir, "params.json"))

    logging.info("Loading the dataset...")
    ds = load_dataset(cfg.dataset, cfg.data_dir)
    if cfg.partition != "contiguous":
        # an isomorphic renumbering; a restore adopts it from params.json
        ds = partition_dataset(ds, cfg.partition)
        logging.info("Applied %s entity partition", cfg.partition)
        if args.init_embeddings:
            logging.warning(
                "--init_embeddings rows are keyed by entity id and "
                "--partition %s RENUMBERS entities: the table must already "
                "be in the partitioned numbering", cfg.partition)
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation)
    banks = make_banks(ds, device)
    if mesh is not None:
        check_mesh_shape(mesh.data, mesh.graph, cfg.batch_size,
                         cfg.eval_batch_size, graph.e_pad)
    else:
        graph = graph.to(device)
    model = build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                        e_pad=graph.e_pad, mesh=mesh)
    if args.init_embeddings:
        # after init and before any restore, as in the JAX CLI
        init_embeddings_from_npz(model, args.init_embeddings)
        logging.info("Initialized embedding tables from %s",
                     args.init_embeddings)
    best, opt_state = 0.0, None
    if ref_sd is not None:
        # after any warm start; a fresh optimizer state; its measure is the
        # best so far; --restore_dir still wins (kgc_gcn_tpu/cli.py:381-399)
        apply_reference_state_dict(
            model, params_from_reference_state_dict(ref_sd, graph))
        best = ref_measure
        logging.info("Imported reference checkpoint %s (measure: %s)",
                     cfg.restore_torch, best)
    if cfg.restore_dir is not None:
        # every rank reads the whole file; the mesh takes its slices
        state_dict, best, *opt = load_checkpoint(
            cfg.restore_dir, cfg, with_opt_state=cfg.do_train)
        if cfg.model == "mgcn":
            # the file's conv bias or none, whatever the model held
            model.conv.set_bias(state_dict.get("conv.bias"))
        model.load_state_dict(state_dict)
        opt_state = opt[0] if opt else None
        logging.info("Restored model from %s with best measure: %s",
                     cfg.restore_dir, best)
    model = model.to(device)

    trainer = None
    if cfg.do_train or mesh is not None:
        trainer_cls = (NegativeSamplingTrainer
                       if cfg.train_mode == "negative_sampling" else Trainer)
        # under a mesh the trainer shards the graph and the per-edge tables
        trainer = trainer_cls(cfg, model, graph, banks, mesh=mesh)
        graph = trainer.graph
        if opt_state is not None:   # resume: the optimizer continues too
            trainer.opt_state.count = opt_state.count
            for dst, src in zip(trainer.opt_state.mu + trainer.opt_state.nu,
                                opt_state.mu + opt_state.nu):
                dst.copy_(src if mesh is None else shard_like(src, dst, mesh))
    if cfg.do_train:
        logging.info("Training %s+%s, %s, loss_impl=%s, on %s", cfg.model,
                     cfg.decoder, cfg.train_mode, trainer.loss_impl, device)
        best = train_and_evaluate(trainer, model_dir, best,
                                  seed=cfg.seed % 2**32,
                                  profile_dir=args.profile_dir)
    if cfg.do_test and args.per_relation:
        write_per_relation(cfg, model, graph, banks, ds.relation2id,
                           ds.num_relation, model_dir, mesh)
    elif cfg.do_test:
        evaluate(cfg, model, graph, banks, "test", mark="Test",
                 mesh=mesh)
    if args.do_predict:
        predictor = Predictor(cfg, model, graph, ds.entity2id, ds.relation2id)
        if args.predict_file == "-":
            for line in serve_stream(predictor, sys.stdin, k=args.top_k):
                print(line, flush=True)   # one JSON line per query, streamed
        else:
            for line in serve_file(predictor, args.predict_file, k=args.top_k):
                print(line)
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
