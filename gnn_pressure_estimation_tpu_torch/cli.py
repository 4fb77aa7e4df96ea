"""Command-line interface of the port: train | eval | infer | generate | mkconfig | netgen.

The counterpart of ``gnn_pressure_estimation_tpu/cli.py``, with its flag
names, defaults and choices. The one difference is ``--device``, which takes
``cuda`` or ``cpu``: left out, the commands run on the card and raise when
there is none (``device.resolve_device``); ``--device cpu`` runs the
kernels' plain PyTorch versions on the host.

- ``train``    — ``Trainer.fit`` on snapshot zips; ``--model_path`` resumes
  through ``Trainer.restore``; ``--do_test`` evaluates the best checkpoint;
  ``--profile_dir`` writes a ``torch.profiler`` trace of the epochs after
  the first
- ``eval``     — the multi-trial ``Evaluator`` (clean, noisy11, noisyNN) on
  a checkpoint, under the layout it was trained with
- ``infer``    — full fields from sparse observations, exported as npz / csv
- ``generate`` — Monte-Carlo scenario generation (``simgen.runner``)
- ``mkconfig`` — a generation INI from an INP's value ranges
- ``netgen``   — a synthetic network as an INP file

``--model`` takes every name of the JAX registry: GATRes-small and -large
and the baseline zoo (``gin``, ``gat``, ``gcn2``, ``chebnet``,
``graphconvwat``, ``mgcn``), each with its preset's criterion,
normalisation and edge attributes unless a flag overrides them. What the
port does not have yet exits non-zero, naming the ROADMAP Queue 1 item that
brings it: the mesh and multi-host runs (``--mesh``, ``--distributed``, item 7), bf16
activations and matmul precisions other than ``highest`` (item 8), several
epochs per dispatch (item 2) and ``benchmark`` (item 1).

Run as ``python -m gnn_pressure_estimation_tpu_torch.cli <command> [flags]``
or ``gnn-wdn-torch <command> [flags]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from datetime import datetime


def _add_train_flags(p: argparse.ArgumentParser):
    """Training flag surface (reference train.py:541-648)."""
    p.add_argument("--model", default="gatres_small",
                   choices=["gatres_small", "gatres_large", "gin", "graphconvwat",
                            "chebnet", "mgcn", "gcn2", "gat"],
                   help="a preset of the model registry")
    p.add_argument("--lr", default=0.0005, type=float)
    p.add_argument("--weight_decay", default=0.000006, type=float)
    p.add_argument("--epochs", default=500, type=int)
    p.add_argument("--mask_rate", default=0.95, type=float)
    p.add_argument("--dataset_paths", default=["datasets/synthctown.zip"], nargs="*")
    p.add_argument("--input_paths", default=["inputs/synthctown.inp"], nargs="*")
    p.add_argument("--feature", default="pressure", choices=["pressure", "head"])
    p.add_argument("--variant", default=datetime.today().strftime("%Y%m%d_%H%M"))
    p.add_argument("--criterion", default=None, choices=["mse", "mae", "sce", None],
                   help="override the model preset's criterion")
    p.add_argument("--norm_type", default=None, choices=["znorm", "minmax", "unused", None],
                   help="override the model preset's normalization")
    p.add_argument("--num_trains", default=None, type=int)
    p.add_argument("--use_data_edge_attrs", default=None, type=str,
                   help="override the preset's edge attributes: "
                        "'diameter', 'length', 'diameter,length', or 'none' "
                        "(reference train.py:592)")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--train_val_removal", default="keep_junction",
                   choices=["keep_all", "keep_list", "keep_junction", "reservoir", "tank"])
    p.add_argument("--patience", default=100, type=int)
    p.add_argument("--min_delta", default=1e-4, type=float)
    p.add_argument("--use_gradient_clipping", action="store_true")
    p.add_argument("--percentile", default=10.0, type=float)
    p.add_argument("--scheduler", default=None, choices=["ReduceLROnPlateau", None])
    p.add_argument("--scheduler_patience", default=2, type=int)
    p.add_argument("--save_path", default="experiments_logs/run", type=str)
    p.add_argument("--model_path", default="", type=str,
                   help="checkpoint to resume from")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--device", default=None, choices=["cuda", "cpu", None],
                   help="cuda (the default: raises without a card) or cpu (the "
                        "kernels' plain PyTorch versions on the host)")
    p.add_argument("--epochs_per_dispatch", default=1, type=int,
                   help="only 1: several epochs per dispatch is not yet ported "
                        "(ROADMAP Queue 1 item 2)")
    p.add_argument("--profile_dir", default=None, type=str,
                   help="write a torch.profiler trace (Chrome trace JSON) of the "
                        "training epochs after the first into this directory")
    p.add_argument("--profile_epochs", default=2, type=int)
    p.add_argument("--activation_dtype", default=None,
                   choices=["float32", "bfloat16", None],
                   help="float32 only: bfloat16 activations are not yet ported "
                        "(ROADMAP Queue 1 item 8)")
    p.add_argument("--matmul_precision", default=None,
                   choices=["bfloat16", "tensorfloat32", "highest", None],
                   help="highest only: the others are not yet ported (ROADMAP "
                        "Queue 1 item 8)")
    p.add_argument("--gate_dtype", default=None,
                   choices=["float32", "bfloat16", None],
                   help="storage dtype of the factored-attention 0/1 gate "
                        "matrix (GATRes)")
    p.add_argument("--attn_impl", default=None,
                   choices=["softmax", "onepass", "factored", None],
                   help="dense-path attention implementation override for "
                        "models with the knob (GATRes preset: factored)")
    p.add_argument("--agg_mode", default=None,
                   choices=["dense", "banded", "padded", None],
                   help="aggregation layout for the batched template "
                        "(None = auto: dense small, banded large)")
    p.add_argument("--band_block", default=None, type=int,
                   help="banded block-row size (default 256)")
    p.add_argument("--mesh", default=None, type=str, metavar="DP,GP",
                   help="not yet ported (ROADMAP Queue 1 item 7)")
    p.add_argument("--distributed", action="store_true",
                   help="not yet ported (ROADMAP Queue 1 item 7)")
    p.add_argument("--coordinator", default=None, type=str,
                   help="coordinator address host:port for --distributed")
    p.add_argument("--num_processes", default=None, type=int)
    p.add_argument("--process_id", default=None, type=int)
    p.add_argument("--log_method", default=None, choices=["wandb", None],
                   help="wandb if it is installed, else a JSONL file under --save_path")
    p.add_argument("--log_gradient", action="store_true",
                   help="track total/block gradient norms per epoch")
    p.add_argument("--project_name", default="test_project", type=str)
    p.add_argument("--do_test", action="store_true",
                   help="after training, run the clean multi-trial evaluation "
                        "on the test split (reference train.py:524-530)")


def _refuse(args, *checks: str):
    """Exit non-zero, naming the ROADMAP item, where ``args`` asks for what the
    port does not have yet. ``checks`` names the flags this command acts on."""
    reasons = {
        "mesh": (bool(args.mesh),
                 "--mesh is not yet ported (ROADMAP Queue 1 item 7, parallel)"),
        "distributed": (args.distributed,
                        "--distributed is not yet ported (ROADMAP Queue 1 item 7, parallel)"),
        "activation_dtype": (args.activation_dtype == "bfloat16",
                             "--activation_dtype bfloat16 is not yet ported (ROADMAP Queue 1 "
                             "item 8, precision knobs)"),
        "matmul_precision": (args.matmul_precision not in (None, "highest"),
                             f"--matmul_precision {args.matmul_precision} is not yet ported "
                             f"(ROADMAP Queue 1 item 8, precision knobs)"),
        "epochs_per_dispatch": (args.epochs_per_dispatch > 1,
                                "--epochs_per_dispatch above 1 is not yet ported (ROADMAP "
                                "Queue 1 item 2, the CUDA graph of the step)"),
    }
    for name in checks:
        refused, why = reasons[name]
        if refused:
            sys.exit(why)


def _device(args):
    from gnn_pressure_estimation_tpu_torch.device import resolve_device

    return resolve_device(args.device or "cuda")


def _model(args, dev, seed: int = 0):
    """The ``--model`` preset's model; m_GCN embeds as many edge attributes
    as ``--use_data_edge_attrs`` (or the preset) names, none without them."""
    from gnn_pressure_estimation_tpu_torch.models.presets import (
        MODEL_REGISTRY, apply_model_knobs, select_model,
    )

    preset = MODEL_REGISTRY[args.model]
    edge_dim = None if preset.edge_attrs is None else len(_edge_attrs(args, preset) or ())
    model, preset = select_model(args.model, device=dev, seed=seed, edge_dim=edge_dim)
    try:
        model = apply_model_knobs(model, attn_impl=args.attn_impl, gate_dtype=args.gate_dtype)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))
    return model, preset


def _edge_attrs(args, preset):
    """Preset edge attributes, overridable from the CLI
    (reference --use_data_edge_attrs, train.py:592)."""
    raw = getattr(args, "use_data_edge_attrs", None)
    if raw is None:
        return preset.edge_attrs
    raw = raw.strip().lower()
    if raw in ("", "none"):
        return None
    attrs = tuple(a.strip() for a in raw.split(",") if a.strip())
    for a in attrs:
        if a not in ("diameter", "length"):
            sys.exit(f"unsupported edge attribute {a!r} (diameter|length)")
    return attrs


def _load_datasets(args, preset):
    from gnn_pressure_estimation_tpu_torch.data import WDNDataset

    norm_type = args.norm_type or preset.norm_type
    edge_attrs = _edge_attrs(args, preset)
    train_ds = WDNDataset(
        args.dataset_paths, args.input_paths, feature=args.feature,
        from_set="train", num_records=args.num_trains,
        removal=args.train_val_removal, edge_attrs=edge_attrs,
        norm_type=norm_type,
    )
    val_ds = WDNDataset(
        args.dataset_paths, args.input_paths, feature=args.feature,
        from_set="valid", removal=args.train_val_removal,
        edge_attrs=edge_attrs, norm_type=norm_type, stats=train_ds.stats,
    )
    return train_ds, val_ds, norm_type


def _checkpoint(args, model):
    """The checkpoint's parameters loaded into ``model`` through its
    ``state_dict``; returns ``(stats, layout)`` from its meta."""
    from gnn_pressure_estimation_tpu_torch.train import load_checkpoint

    if not args.model_path:
        sys.exit(f"{args.command} requires --model_path (a trained checkpoint)")
    params, _, meta = load_checkpoint(args.model_path, model.state_dict())
    model.load_state_dict(params)
    stats = meta.get("stats")
    assert stats is not None, "checkpoint lacks normalization stats"
    return stats, (meta.get("extra") or {}).get("layout") or {}


class _EpochProfiler:
    """A ``torch.profiler`` trace of epochs 2 .. ``last`` (epoch 1 holds the
    first calls' set-up), written as Chrome trace JSON into ``out_dir``."""

    def __init__(self, out_dir: str, last: int, name: str, device):
        self.out_dir, self.last, self.name, self.device = out_dir, last, name, device
        self.prof = None

    def epoch_end(self, epoch: int):
        if epoch == 1:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        elif self.prof is not None and epoch > self.last:
            self.stop()

    def stop(self):
        if self.prof is None:
            return
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"{self.name}.trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        print(f"profiler trace written to {path}")


def cmd_train(args):
    _refuse(args, "mesh", "distributed", "activation_dtype", "matmul_precision",
            "epochs_per_dispatch")
    from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
    from gnn_pressure_estimation_tpu_torch.utils.logging import make_logger

    dev = _device(args)
    model, preset = _model(args, dev, seed=args.seed)
    train_ds, val_ds, norm_type = _load_datasets(args, preset)

    cfg = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay, epochs=args.epochs,
        mask_rate=args.mask_rate, batch_size=args.batch_size,
        criterion=args.criterion or preset.criterion, norm_type=norm_type,
        patience=args.patience, min_delta=args.min_delta,
        scheduler=args.scheduler, scheduler_patience=args.scheduler_patience,
        use_gradient_clipping=args.use_gradient_clipping,
        clip_percentile=args.percentile, seed=args.seed,
        save_path=args.save_path, model_name=args.model, variant=args.variant,
        log_gradient=args.log_gradient,
        matmul_precision=args.matmul_precision,
        epochs_per_dispatch=args.epochs_per_dispatch,
        agg_mode=args.agg_mode, band_block=args.band_block,
    )
    trainer = Trainer(model, cfg, train_ds.stats, train_ds.members[0].template, device=dev)
    print(f"Model: {args.model}; parameters: {trainer.n_params}")
    if args.model_path:
        # full-state resume: parameters, optimizer, epoch, early stop, scheduler
        meta = trainer.restore(args.model_path)
        print(f"resumed from {args.model_path} (epoch {meta['epoch']}, "
              f"continuing at {meta['epoch'] + 1})")

    run_name = f"{args.model}_{args.variant}"
    logger = make_logger(args.log_method, args.project_name, run_name, vars(args))
    on_epoch_end = logger.log_epoch
    prof = None
    if args.profile_dir:
        prof = _EpochProfiler(args.profile_dir, args.profile_epochs, run_name, dev)

        def on_epoch_end(epoch, mets, _log=logger.log_epoch):
            _log(epoch, mets)
            prof.epoch_end(epoch)

    best = trainer.fit(train_ds, val_ds, on_epoch_end=on_epoch_end)
    if prof is not None:
        prof.stop()
    logger.finish()
    print(f"best epoch {best['epoch']}: val_loss {best['loss']:.6f}")

    if args.do_test:
        # clean, unshared-mask evaluation of the best checkpoint on the test
        # split (reference convert_train_2_test_arguments defaults), under
        # the layout the run trained with
        from gnn_pressure_estimation_tpu_torch.data import WDNDataset
        from gnn_pressure_estimation_tpu_torch.evaluation import EvalConfig, Evaluator
        from gnn_pressure_estimation_tpu_torch.train import load_checkpoint

        params, _, _ = load_checkpoint(trainer._ckpt_path("best"), trainer.model.state_dict())
        trainer.model.load_state_dict(params)
        test_ds = WDNDataset(
            args.dataset_paths, args.input_paths, feature=args.feature,
            from_set="test", removal=args.train_val_removal,
            edge_attrs=_edge_attrs(args, preset), norm_type=norm_type,
            stats=train_ds.stats,
        )
        ecfg = EvalConfig(
            test_type="clean", num_test_trials=10, batch_size=args.batch_size,
            mask_rate=args.mask_rate, criterion=cfg.criterion,
            use_same_mask=False, feature=args.feature,
            removal=args.train_val_removal,
            agg_mode=args.agg_mode, band_block=args.band_block,
        )
        Evaluator(trainer.model, ecfg, train_ds.stats, device=dev).evaluate(test_ds)
    return 0


def cmd_eval(args):
    _refuse(args, "mesh")
    from gnn_pressure_estimation_tpu_torch.data import WDNDataset
    from gnn_pressure_estimation_tpu_torch.evaluation import EvalConfig, Evaluator
    from gnn_pressure_estimation_tpu_torch.evaluation.harness import make_noisy_scenes

    dev = _device(args)
    model, preset = _model(args, dev)
    norm_type = args.norm_type or preset.norm_type
    edge_attrs = _edge_attrs(args, preset)
    stats, layout = _checkpoint(args, model)
    # evaluate under the layout the model was trained with; explicit flags
    # still override
    agg_mode = args.agg_mode or layout.get("agg_mode")
    band_block = args.band_block or layout.get("band_block")

    cfg = EvalConfig(
        test_type=args.test_type, num_test_trials=args.num_test_trials,
        batch_size=args.batch_size, mask_rate=args.mask_rate,
        criterion=args.criterion or preset.criterion,
        use_same_mask=args.use_same_mask,
        gpu_warmup_times=args.gpu_warmup_times,
        test_input_path=args.test_input_path,
        mean_dmd=args.mean_dmd, std_dmd=args.std_dmd,
        feature=args.feature, removal=args.test_removal,
        agg_mode=agg_mode, band_block=band_block,
    )
    if cfg.test_type == "clean":
        if args.from_set == "all":
            from gnn_pressure_estimation_tpu_torch.data.dataset import stacked_dataset

            datasets = stacked_dataset(
                args.test_data_path, args.test_input_path, stats,
                feature=args.feature, removal=args.test_removal,
                edge_attrs=edge_attrs, norm_type=norm_type,
                num_tests=args.num_tests,
            )
        elif args.from_set == "inp":
            # one fresh noise-free simulation of the INP
            # (reference evaluation.py:177-196 single_snapshot path)
            from gnn_pressure_estimation_tpu_torch.data.noisy import NoisyWDNDataset

            datasets = NoisyWDNDataset(
                [args.test_input_path], feature=args.feature,
                removal=args.test_removal, stats=stats,
                edge_attrs=edge_attrs, norm_type=norm_type,
                mean_dmd=0.0, std_dmd=0.0,
            )
        else:
            datasets = WDNDataset(
                [args.test_data_path], [args.test_input_path],
                feature=args.feature, from_set=args.from_set,
                removal=args.test_removal, edge_attrs=edge_attrs,
                norm_type=norm_type, stats=stats,
            )
    else:
        datasets = make_noisy_scenes(
            [args.test_input_path], cfg, stats, edge_attrs, norm_type
        )
    Evaluator(model, cfg, stats, device=dev).evaluate(datasets)
    return 0


def cmd_infer(args):
    """Serving surface: reconstruct full pressure fields from sparse
    observations and export them."""
    from gnn_pressure_estimation_tpu_torch.data import WDNDataset
    from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer

    dev = _device(args)
    model, preset = _model(args, dev)
    stats, layout = _checkpoint(args, model)
    agg_mode = args.agg_mode or layout.get("agg_mode")
    band_block = args.band_block or layout.get("band_block")
    norm_type = args.norm_type or preset.norm_type
    edge_attrs = _edge_attrs(args, preset)

    if args.from_set == "inp":
        # fresh noise-free simulation of the INP as the snapshot source
        from gnn_pressure_estimation_tpu_torch.data.noisy import NoisyWDNDataset

        ds = NoisyWDNDataset(
            [args.test_input_path], feature=args.feature,
            removal=args.test_removal, stats=stats, edge_attrs=edge_attrs,
            norm_type=norm_type, mean_dmd=0.0, std_dmd=0.0,
        )
    else:
        ds = WDNDataset(
            [args.test_data_path], [args.test_input_path],
            feature=args.feature, from_set=args.from_set,
            removal=args.test_removal, edge_attrs=edge_attrs,
            norm_type=norm_type, stats=stats,
        )
    template = ds.members[0].template
    rows = ds.members[0].array  # scaled snapshots [S, n]
    if args.num_snapshots:
        rows = rows[: args.num_snapshots]

    inf = Inferencer(model, stats, agg_mode=agg_mode, band_block=band_block, device=dev)
    spec = args.observed
    if spec not in ("random", "sensors"):
        spec = [s.strip() for s in spec.split(",") if s.strip()]
    try:
        obs_idx = inf.observed_indices(
            template, spec, test_input_path=args.test_input_path,
            mask_rate=args.mask_rate, seed=args.seed,
        )
    except ValueError as e:
        raise SystemExit(str(e))
    res = inf.infer(template, rows, obs_idx, scaled=True,
                    batch_size=args.batch_size, with_truth=True)
    print(f"inferred {res.pred.shape[0]} snapshots × {res.pred.shape[1]} nodes "
          f"({len(obs_idx)} observed)")
    for mk, mv in res.metrics.items():
        print(f"  {mk}: {mv:.6g}" if isinstance(mv, float) else f"  {mk}: {mv}")
    if args.out_npz:
        res.save_npz(args.out_npz)
        print(f"wrote {args.out_npz}")
    if args.out_csv:
        res.save_csv(args.out_csv)
        print(f"wrote {args.out_csv}")
    if not (args.out_npz or args.out_csv):
        print("(pass --out_npz / --out_csv to export the fields)")
    return 0


def cmd_generate(args):
    from gnn_pressure_estimation_tpu_torch.simgen.config import GenOptions
    from gnn_pressure_estimation_tpu_torch.simgen.runner import generate

    opt_fields = {f.name for f in dataclasses.fields(GenOptions)}
    opts = GenOptions(**{k: v for k, v in vars(args).items() if k in opt_fields})
    generate(args.config, opts)
    return 0


def cmd_mkconfig(args):
    from gnn_pressure_estimation_tpu_torch.simgen.config import create_dummy_config

    create_dummy_config(
        args.wn_inp_path, out_path=args.out,
        num_scenarios=args.num_scenarios, strategy=args.strategy,
    )
    print(f"wrote {args.out}")
    return 0


def cmd_netgen(args):
    from gnn_pressure_estimation_tpu_torch.data.inp import write_inp
    from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_wdn

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    wn = make_wdn(
        args.junctions, args.reservoirs, args.tanks, args.pumps, args.valves,
        seed=args.seed,
    )
    write_inp(wn, args.out)
    print(f"wrote {args.out}: {wn.n_nodes} nodes, {wn.n_links} links")
    return 0


def cmd_benchmark(args):
    sys.exit("benchmark is not yet ported (ROADMAP Queue 1 item 1, the GPU bench)")


def build_parser() -> argparse.ArgumentParser:
    from gnn_pressure_estimation_tpu_torch.simgen.config import GenOptions

    parser = argparse.ArgumentParser(prog="gnn_pressure_estimation_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train a model on snapshot datasets")
    _add_train_flags(p_train)

    p_eval = sub.add_parser("eval", help="multi-trial statistical evaluation")
    _add_train_flags(p_eval)
    p_eval.add_argument("--test_type", default="clean",
                        choices=["clean", "noisy11", "noisyNN"])
    p_eval.add_argument("--from_set", default="test",
                        choices=["train", "valid", "test", "all", "inp"],
                        help="'all' stacks test+train+valid; 'inp' simulates "
                             "one fresh snapshot from the INP (no zip needed)")
    p_eval.add_argument("--test_data_path", default="datasets/synthctown.zip")
    p_eval.add_argument("--test_input_path", default="inputs/synthctown.inp")
    p_eval.add_argument("--test_removal", default="keep_junction",
                        choices=["keep_all", "keep_list", "keep_junction",
                                 "reservoir", "tank"])
    p_eval.add_argument("--num_test_trials", default=10, type=int)
    p_eval.add_argument("--num_tests", default=None, type=int,
                        help="cap the stacked 'all' evaluation set at this "
                             "many records (reference evaluation.py:923)")
    p_eval.add_argument("--use_same_mask", action="store_true")
    p_eval.add_argument("--gpu_warmup_times", default=10, type=int)
    p_eval.add_argument("--mean_dmd", default=0.1, type=float)
    p_eval.add_argument("--std_dmd", default=1.0, type=float)

    p_inf = sub.add_parser(
        "infer", help="reconstruct full pressure fields from sparse "
                      "observations and export them (serving)")
    _add_train_flags(p_inf)
    p_inf.add_argument("--from_set", default="test",
                       choices=["train", "valid", "test", "inp"],
                       help="'inp' simulates one fresh snapshot from the INP")
    p_inf.add_argument("--test_data_path", default="datasets/synthctown.zip")
    p_inf.add_argument("--test_input_path", default="inputs/synthctown.inp")
    p_inf.add_argument("--test_removal", default="keep_junction",
                       choices=["keep_all", "keep_list", "keep_junction",
                                "reservoir", "tank"])
    p_inf.add_argument("--observed", default="random",
                       help="'random' (seeded draw at 1-mask_rate density), "
                            "'sensors' (mysecrets plug-in), or comma-"
                            "separated node names")
    p_inf.add_argument("--num_snapshots", default=None, type=int)
    p_inf.add_argument("--out_npz", default=None, type=str)
    p_inf.add_argument("--out_csv", default=None, type=str)

    p_gen = sub.add_parser("generate", help="Monte-Carlo scenario generation")
    p_gen.add_argument("--config", required=True)
    for f in dataclasses.fields(GenOptions):
        if f.name == "config":
            continue
        arg = f"--{f.name}"
        ftype = str(f.type)
        if ftype == "bool" or isinstance(f.default, bool):
            p_gen.add_argument(arg, default=f.default,
                               action=argparse.BooleanOptionalAction)
        elif f.default is None:
            # Optional fields: the scalar type from the annotation, so
            # "--pressure_lowerbound -5" parses as float, not str
            typ = float if "float" in ftype else (int if "int" in ftype else str)
            p_gen.add_argument(arg, default=None, type=typ)
        else:
            p_gen.add_argument(arg, default=f.default, type=type(f.default))

    p_cfg = sub.add_parser("mkconfig", help="derive a generation INI from an INP")
    p_cfg.add_argument("--wn_inp_path", required=True)
    p_cfg.add_argument("--out", required=True)
    p_cfg.add_argument("--num_scenarios", default=100, type=int)
    p_cfg.add_argument("--strategy", default="minmax", choices=["minmax", "quantile"])

    p_net = sub.add_parser("netgen", help="generate a synthetic WDN INP")
    p_net.add_argument("--out", required=True)
    p_net.add_argument("--junctions", default=388, type=int)
    p_net.add_argument("--reservoirs", default=1, type=int)
    p_net.add_argument("--tanks", default=7, type=int)
    p_net.add_argument("--pumps", default=11, type=int)
    p_net.add_argument("--valves", default=4, type=int)
    p_net.add_argument("--seed", default=0, type=int)

    sub.add_parser("benchmark", help="not yet ported (ROADMAP Queue 1 item 1)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return {
        "train": cmd_train,
        "eval": cmd_eval,
        "infer": cmd_infer,
        "generate": cmd_generate,
        "mkconfig": cmd_mkconfig,
        "netgen": cmd_netgen,
        "benchmark": cmd_benchmark,
    }[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
