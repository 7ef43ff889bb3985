"""Command line of the PyTorch/CUDA port — counterpart of
``acmgnn_tpu/cli.py``, with the same subcommands, flags (both spelling
families: ``--dataset``/``--dataset_name``, ``--model``/``--method``,
``--hidden``/``--hidden_channels``) and output, plus ``--device``:

    python -m acmgnn_tpu_torch.cli train --dataset texas --fixed_splits 1
    python -m acmgnn_tpu_torch.cli train --device cpu ...

Subcommands:
  train            multi-split training run
  sweep            lr x wd x dropout grid search
  gen-graphs       synthetic graphs over an edge-homophily sweep
  gen-feats        synthetic feature realizations from a base dataset
  synthetic-train  training over the generated graphs of one level
  predict          restore a checkpoint and write per-node predictions
  homophily        homophily metrics of a dataset

Everything runs on the card unless ``--device cpu`` is given; without a
card the run raises.  Datasets are read from local files
(``ACMGNN_DATA_PATH``, ``ACMGNN_DATA_HOME``: ``data/paths.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os

from acmgnn_tpu_torch.train.config import TrainConfig


def _add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset", "--dataset_name", dest="dataset",
                   default="texas")
    p.add_argument("--sub_dataset", default="")
    p.add_argument("--model", "--method", "--model_type", dest="model",
                   default="acmgcn")
    p.add_argument("--hidden", "--hidden_channels", dest="hidden", type=int,
                   default=64)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--early_stopping", type=int, default=200)
    p.add_argument("--num_splits", "--runs", dest="num_splits", type=int,
                   default=10)
    p.add_argument("--fixed_splits", type=int, default=0)
    p.add_argument("--variant", type=int, default=0)
    p.add_argument("--structure_info", type=int, default=0)
    p.add_argument("--layers", "--nlayers", dest="layers", type=int,
                   default=1)
    p.add_argument("--hops", type=int, default=1)
    p.add_argument("--link_init_layers_X", type=int, default=1)
    p.add_argument("--alpha", type=float, default=0.1,
                   help="gcnII initial-residual strength")
    p.add_argument("--lamda", type=float, default=0.5,
                   help="gcnII identity-map decay")
    p.add_argument("--optimizer", choices=["adam", "adamw"], default="adam")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--rocauc", action="store_true")
    p.add_argument("--directed", action="store_true")
    p.add_argument("--selection", choices=["val_loss", "val_metric"],
                   default=None)
    p.add_argument("--operator_format",
                   choices=["auto", "dense", "coo", "ell"], default="auto")
    p.add_argument("--reorder", choices=["none", "rcm", "degree"],
                   default="none")
    p.add_argument("--spmm_dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--gemm_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="channel-projection GEMM operand dtype (bf16 "
                        "operands, f32 accumulation)")
    p.add_argument("--ell_hub_threshold", type=int, default=0,
                   help="a TPU layout knob of the JAX package; no effect "
                        "here")
    p.add_argument("--ell_block", type=int, default=0,
                   help="a TPU layout knob of the JAX package: 0 or 1 "
                        "only here")
    p.add_argument("--joint", type=int, default=0,
                   help="paired train+eval loop (one fused gather)")
    p.add_argument("--hoist_first", type=int, default=0,
                   help="first-layer input-side aggregation hoist "
                        "(A(XW)=(AX)W): eval rides a precomputed A_hat X, "
                        "the train input gather needs no backward")
    p.add_argument("--feature_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="on-device feature-matrix storage (weights and "
                        "accumulations stay f32)")
    p.add_argument("--remat", type=int, default=0,
                   help="recompute the train forward in the backward "
                        "(activation checkpointing; the same math)")
    p.add_argument("--hoist_agg_dtype",
                   choices=["auto", "float32", "bfloat16"], default="auto",
                   help="storage dtype of the precomputed hoist aggregate")
    p.add_argument("--normalization", choices=["row", "sym"], default="row")
    p.add_argument("--stepwise", action="store_true",
                   help="per-epoch observable loop (OGB-style stats, "
                        "display, checkpointing) instead of the captured "
                        "split runner")
    p.add_argument("--checkpoint_dir", default="",
                   help="save best-val weights per split; with "
                        "--checkpoint_every also full resumable state "
                        "(implies --stepwise)")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="snapshot full training state every N epochs")
    p.add_argument("--resume", action="store_true",
                   help="resume each split from its last snapshot in "
                        "--checkpoint_dir")
    p.add_argument("--sharded", type=int, default=0, metavar="N",
                   help="train row-partitioned over the N ranks of the "
                        "process group a launcher (torchrun) made; -1: "
                        "its world size, 0: one device")
    p.add_argument("--exchange", choices=["allgather", "halo", "auto"],
                   default="auto",
                   help="sharded SpMM communication: full feature "
                        "all-gather, boundary halo exchange, or auto by "
                        "volume")
    p.add_argument("--per_host_loading", type=int, default=0,
                   help="accepted for the JAX CLI's flags: on the sharded "
                        "path every rank always places only its own rows "
                        "of the node arrays, through a loader of its row "
                        "range")
    p.add_argument("--partition", choices=["contiguous", "fennel",
                                           "balanced"],
                   default="contiguous",
                   help="sharded row partition: nnz-balanced contiguous "
                        "blocks, streaming Fennel min-cut, or "
                        "serpentine-by-degree")
    p.add_argument("--log_dir", default="./logs")
    p.add_argument("--results_csv", default="")
    p.add_argument("--profile_dir", default="",
                   help="capture a torch.profiler trace of the whole run "
                        "into this directory (trace.json, a Chrome trace), "
                        "with the program's spans (split, runner.*, "
                        "body.*, prepare.*) as ranges over the kernels")
    p.add_argument("--device", default="cuda",
                   help="device to run on: cuda (default; raises without a "
                        "card) or cpu")


# datasets the reference trains with BCE + ROC-AUC
ROCAUC_DATASETS = ("yelp-chi", "twitch-e", "ogbn-proteins", "genius")
# datasets selected on best-val-metric instead of best-val-loss
VAL_METRIC_DATASETS = ("deezer-europe",) + ROCAUC_DATASETS


def config_from_args(args) -> TrainConfig:
    use_rocauc = args.rocauc or args.dataset in ROCAUC_DATASETS
    selection = args.selection
    if selection is None:
        selection = ("val_metric" if args.dataset in VAL_METRIC_DATASETS
                     else "val_loss")
    cfg = _build_config(args, use_rocauc, selection)
    # the dataset's forced protocol (deezer-europe: AdamW, 500 epochs,
    # attached splits)
    return cfg.resolve_for_dataset(args.dataset)


def _build_config(args, use_rocauc, selection) -> TrainConfig:
    return TrainConfig(
        model_type=args.model,
        hidden=args.hidden,
        nlayers=args.layers,
        variant=bool(args.variant),
        structure_info=bool(args.structure_info),
        init_layers_X=args.link_init_layers_X,
        hops=args.hops,
        alpha=args.alpha,
        lamda=args.lamda,
        lr=args.lr,
        weight_decay=args.weight_decay,
        dropout=args.dropout,
        epochs=args.epochs,
        early_stopping=args.early_stopping,
        optimizer=args.optimizer,
        selection=selection,
        metric="rocauc" if use_rocauc else "acc",
        loss="bce" if use_rocauc else "nll",
        num_splits=args.num_splits,
        fixed_splits=bool(args.fixed_splits),
        directed=bool(args.directed),
        sub_dataset=args.sub_dataset,
        seed=args.seed,
        normalization=args.normalization,
        operator_format=args.operator_format,
        reorder=args.reorder,
        partition=args.partition,
        spmm_dtype=args.spmm_dtype,
        gemm_dtype=args.gemm_dtype,
        joint=bool(args.joint),
        hoist_first=bool(args.hoist_first),
        hoist_agg_dtype=args.hoist_agg_dtype,
        remat=bool(args.remat),
        feature_dtype=args.feature_dtype,
        ell_hub_threshold=args.ell_hub_threshold,
        ell_block=args.ell_block,
    )


def cmd_train(args):
    from acmgnn_tpu_torch.utils import profiling
    from acmgnn_tpu_torch.utils.logging import ExperimentLogger

    cfg = config_from_args(args)
    name = f"{args.dataset}_{args.model}"
    if args.sharded and "RANK" in os.environ:
        name += f"_rank{os.environ['RANK']}"   # one log file per rank
    logger = ExperimentLogger(name=name, log_dir=args.log_dir)
    logger.info("config: %s", dataclasses.asdict(cfg))
    trace = (profiling.profile_trace(args.profile_dir) if args.profile_dir
             else contextlib.nullcontext())
    with trace:
        out = _run_train(args, cfg, logger)
    if args.profile_dir:
        logger.info("profiler trace written to %s (a Chrome trace); the "
                    "program's spans:\n%s", args.profile_dir,
                    profiling.table())
    if args.results_csv:
        logger.append_csv(args.results_csv, {
            "dataset": out["dataset"],
            "model": out["model"],
            "test_mean": round(out["test_mean"], 4),
            "test_std": round(out["test_std"], 4),
            "epoch_ms": round(out["epoch_ms_avg"], 2),
            "config": json.dumps(dataclasses.asdict(cfg)),
        })
    print(json.dumps({k: v for k, v in out.items() if k != "per_split"}))


def _run_train(args, cfg, logger):
    from acmgnn_tpu_torch.train import trainer

    if args.sharded:
        return _run_sharded(args, cfg, logger)
    if args.stepwise or args.checkpoint_dir:
        return trainer.run_experiment_stepwise(
            args.dataset, cfg, logger=logger,
            checkpoint_dir=args.checkpoint_dir or None,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            device=args.device)
    return trainer.run_experiment(args.dataset, cfg, logger=logger,
                                  device=args.device)


def _run_sharded(args, cfg, logger):
    """``run_experiment_sharded`` in the process group the launcher made
    (``init_distributed`` reads torchrun's environment); ``--sharded N``
    must name its world size (-1: whatever it is)."""
    import torch.distributed as dist

    from acmgnn_tpu_torch.parallel.multihost import init_distributed
    from acmgnn_tpu_torch.train import trainer

    if not dist.is_initialized():
        init_distributed(device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.sharded > 0 and args.sharded != world:
        raise ValueError(f"--sharded {args.sharded} in a process group of "
                         f"{world} ranks: launch {args.sharded} processes "
                         f"(torchrun --nproc_per_node={args.sharded})")
    return trainer.run_experiment_sharded(
        args.dataset, cfg, device=args.device, exchange=args.exchange,
        logger=logger, checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        per_host_loading=bool(args.per_host_loading))


def cmd_sweep(args):
    from acmgnn_tpu_torch.train.sweep import grid_search
    from acmgnn_tpu_torch.utils.logging import ExperimentLogger

    cfg = config_from_args(args)
    logger = ExperimentLogger(name=f"sweep_{args.dataset}_{args.model}",
                              log_dir=args.log_dir)
    best = grid_search(args.dataset, cfg,
                       grid=json.loads(args.grid) if args.grid else None,
                       logger=logger, device=args.device)
    print(json.dumps({k: v for k, v in best.items() if k != "per_split"}))


def cmd_gen_graphs(args):
    from acmgnn_tpu_torch.data.synthetic import generate_graphs

    paths = generate_graphs(
        args.base_dir,
        graph_type=args.graph_type,
        edge_homos=args.edge_homos,
        num_graph=args.num_graph,
        num_class=args.num_class,
        node_per_class=args.num_node_total // args.num_class,
        degree_intra=args.degree_intra,
        seed=args.seed,
    )
    print(f"wrote {len(paths)} graphs under {args.base_dir}")


def cmd_gen_feats(args):
    import numpy as np

    from acmgnn_tpu_torch.data.registry import load_dataset
    from acmgnn_tpu_torch.data.synthetic import generate_features

    if args.base_dataset == "random":
        feats = labels = None
    else:
        data = load_dataset(args.base_dataset)
        feats, labels = data.features, np.asarray(data.labels)
    paths = generate_features(
        args.out_dir, feats, labels,
        num_class=args.num_class,
        node_per_class=args.node_per_class,
        num_realizations=args.num_realizations,
        seed=args.seed,
    )
    print(f"wrote {len(paths)} feature realizations under {args.out_dir}")


def cmd_synthetic_train(args):
    from acmgnn_tpu_torch.train.synthetic_exp import run_synthetic_experiment
    from acmgnn_tpu_torch.utils.logging import ExperimentLogger

    cfg = config_from_args(args)
    logger = ExperimentLogger(name=f"synthetic_{args.model}_{args.edge_homo}",
                              log_dir=args.log_dir)
    out = run_synthetic_experiment(
        args.base_dir, args.edge_homo, graph_type=args.graph_type,
        num_graph=args.num_graph, features_dir=args.features_dir or None,
        cfg=cfg, logger=logger, device=args.device)
    print(json.dumps(out))


def cmd_predict(args):
    """Inference: restore a trained checkpoint (written by ``train
    --checkpoint_dir``), run an eval forward of its weights on the
    prepared graph and write per-node logits, predictions and
    probabilities (``.npz``), in the original node ids under
    ``--reorder``."""
    import numpy as np
    import torch

    from acmgnn_tpu_torch.train.trainer import build_model, prepare_data
    from acmgnn_tpu_torch.utils.checkpoint import restore_checkpoint

    cfg = config_from_args(args)
    data, ops, x, labels, _, nclass = prepare_data(args.dataset, cfg,
                                                   device=args.device)
    model = build_model(cfg, x.shape[1], nclass, device=x.device,
                        nnodes=x.shape[0])
    snap = restore_checkpoint(args.checkpoint, map_location=x.device)
    model.load_state_dict(snap["variables"])
    with torch.no_grad():
        logits_t = model(x, ops, training=False).cpu()
    logits = logits_t.numpy()
    preds = np.argmax(logits, axis=1)
    probs = torch.softmax(logits_t, dim=1).numpy()
    lab = labels.cpu().numpy()
    if data.perm is not None:
        # arrays are in reorder-permuted space; write in original node ids
        inv = np.empty_like(data.perm)
        inv[data.perm] = np.arange(len(data.perm))
        logits, preds, probs = logits[inv], preds[inv], probs[inv]
        lab = lab[inv]
    out_path = args.output or f"{args.dataset}_predictions.npz"
    np.savez(out_path, logits=logits, preds=preds, probs=probs)
    summary = {
        "dataset": args.dataset,
        "model": cfg.model_type,
        "checkpoint": args.checkpoint,
        "step": int(snap.get("step", 0)),
        "nodes": int(preds.shape[0]),
        "classes": int(nclass),
        "output": out_path,
    }
    if lab.ndim == 1:  # single-label: report full-graph agreement
        summary["label_agreement"] = round(float((preds == lab).mean()), 4)
    print(json.dumps(summary))


def cmd_homophily(args):
    from acmgnn_tpu_torch.data import homophily as H
    from acmgnn_tpu_torch.data.registry import load_dataset

    data = load_dataset(args.dataset)
    print(json.dumps({
        "dataset": args.dataset,
        "edge_homophily": H.edge_homophily(data.adj, data.labels),
        "node_homophily": H.node_homophily(data.adj, data.labels),
        "class_homophily": H.class_homophily(data.adj, data.labels),
        "aggregation_homophily": H.aggregation_homophily(
            data.features, data.adj, data.labels),
    }))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="acmgnn_tpu_torch",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train")
    _add_train_args(p_train)
    p_train.set_defaults(fn=cmd_train)

    p_sweep = sub.add_parser("sweep")
    _add_train_args(p_sweep)
    p_sweep.add_argument("--grid", default="",
                         help='JSON of the swept values, e.g. \'{"lr": '
                              '[0.01, 0.05], "dropout": [0.5]}\' (default: '
                              "the reference grid of 270 points)")
    p_sweep.set_defaults(fn=cmd_sweep)

    p_gg = sub.add_parser("gen-graphs")
    p_gg.add_argument("--base_dir", default="./synthetic_graphs")
    p_gg.add_argument("--graph_type", choices=["regular", "random"],
                      default="random")
    p_gg.add_argument("--edge_homos", type=float, nargs="+",
                      default=[0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9])
    p_gg.add_argument("--num_graph", type=int, default=10)
    p_gg.add_argument("--num_class", type=int, default=5)
    p_gg.add_argument("--num_node_total", type=int, default=2000)
    p_gg.add_argument("--degree_intra", type=int, default=2)
    p_gg.add_argument("--seed", type=int, default=0)
    p_gg.set_defaults(fn=cmd_gen_graphs)

    p_gf = sub.add_parser("gen-feats")
    p_gf.add_argument("--base_dataset", default="cora")
    p_gf.add_argument("--out_dir", default="./synthetic_graphs/features")
    p_gf.add_argument("--num_class", type=int, default=5)
    p_gf.add_argument("--node_per_class", type=int, default=400)
    p_gf.add_argument("--num_realizations", type=int, default=10)
    p_gf.add_argument("--seed", type=int, default=0)
    p_gf.set_defaults(fn=cmd_gen_feats)

    p_st = sub.add_parser("synthetic-train")
    _add_train_args(p_st)
    p_st.add_argument("--base_dir", default="./synthetic_graphs")
    p_st.add_argument("--graph_type", choices=["regular", "random"],
                      default="random")
    p_st.add_argument("--edge_homo", type=float, default=0.5)
    p_st.add_argument("--num_graph", type=int, default=10)
    p_st.add_argument("--features_dir", default="")
    p_st.set_defaults(fn=cmd_synthetic_train)

    p_h = sub.add_parser("homophily")
    p_h.add_argument("--dataset", default="texas")
    p_h.set_defaults(fn=cmd_homophily)

    p_pred = sub.add_parser(
        "predict", help="restore a checkpoint and emit per-node predictions")
    _add_train_args(p_pred)
    p_pred.add_argument("--checkpoint", required=True,
                        help="checkpoint path (e.g. <dir>/split0_best)")
    p_pred.add_argument("--output", default="",
                        help="output .npz (logits/preds/probs); default "
                             "<dataset>_predictions.npz")
    p_pred.set_defaults(fn=cmd_predict)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
