"""Command-line entry point of the port.

    python -m sea_tpu_torch.cli <flow_type> encoder train
        [--epochs N] [--batch_size N] [--synthetic] [--save_dir DIR]
        [--model_path PATH] [--compute_dtype f32|bf16|bf16_mixed|bf16_shadow]
        [--adam_mu_dtype f32|bf16] [--optimizer adamw|adafactor] [--seed N]
        [--profile DIR] [--device cuda|cpu|cuda:N] [--mesh auto|none|DxM]
    python -m sea_tpu_torch.cli <flow_type> encoder test
        [--model_path PATH] [--synthetic] [--save_dir DIR] [--seed N]
        [--device cuda|cpu|cuda:N]
    python -m sea_tpu_torch.cli <flow_type> temporal train
        [--model_path PATH]
        [--epochs N] [--batch_size N] [--synthetic] [--save_dir DIR]
        [--compute_dtype f32|bf16|bf16_mixed|bf16_shadow]
        [--adam_mu_dtype f32|bf16] [--optimizer adamw|adafactor] [--seed N]
        [--profile DIR] [--device cuda|cpu|cuda:N] [--mesh auto|none|DxM]
    python -m sea_tpu_torch.cli <flow_type> temporal test
        [--model_path PATH] [--synthetic] [--save_dir DIR] [--seed N]
        [--precision f32|bf16|int8|int4] [--no_calibrate]
        [--kv_cache auto|f32|bf16|int8] [--drift_budget REL_L2]
        [--no_drift_check] [--device cuda|cpu|cuda:N] [--mesh DxM]
    python -m sea_tpu_torch.cli <flow_type> temporal generate
        [--horizon H] [--trajectory IDX] [--output PATH]
        [the serving flags of `temporal test`]

Same grammar as ``python -m sea_tpu.cli``, every flag and mode of it on
one device: ``encoder train`` and ``encoder test``, stage 1 (the
autoencoder's training loop under the same numerics policies and
optimizers as stage 2, writing the JAX loop's ``encoder_decoder``
checkpoint; the test's three reconstruction metrics and its field plots);
``temporal train`` (AdamW with f32 or bf16 first moments or Adafactor
(``--optimizer``), under the f32 or a bf16 numerics policy, the bf16
shadow included; it writes the JAX training loop's npz checkpoints and,
at its full-evaluation epochs, its rollout artifacts; evaluation runs f32
on the master weights); ``temporal test``, the serving rollout with
decoded evaluation, on the engine ``rollout.engine.select_engine`` picks
(an explicit ``--kv_cache`` forces the scan engine), at f32 or reduced
precision (bf16 weights; int8 or int4 weights, int4 calibrated on a few
train windows by default; the teacher-forced drift gate; f32, bf16 or
int8 KV caches), writing the rollout CSV and plots; and ``temporal
generate``, the surrogate simulation: a test window's initial state
rolled ``--horizon`` steps, past the dataset window, decoded to fields
[H, N, F] and saved as ``.npy``.

``--model_path`` takes an ``.npz`` checkpoint of either package or a
reference PyTorch state dict (``.pt``, ``module.`` prefixes stripped,
``utils/torch_compat.py``) in every mode. A train mode resumes from it:
an npz's params and, where its optimizer state has the configured
recipe's structure, that state (else a fresh optimizer, with the JAX
CLI's warning); a ``.pt``'s params with a fresh optimizer.
``--profile DIR`` (train modes) writes a trace of one steady-state epoch
into DIR. Plots need matplotlib; without it the run prints which plots
it skipped and writes everything else.

``--mesh`` runs over the ranks of a process group, one process per rank:
``torchrun --nproc_per_node N -m sea_tpu_torch <case> temporal train
--mesh DxM`` (D x M = N) trains data-parallel over D ranks and
Megatron-tensor-parallel over M (``sea_tpu_torch/parallel``); ``encoder
train`` likewise; ``temporal test --mesh DxM`` serves the rollout
sharded (trajectories over D, params over M). As in the JAX CLI, "auto"
(the default) trains data-parallel over every rank when there are two or
more and serves on one device; "none" keeps one device. Rank 0 prints
and writes the files; each rank computes on cuda:LOCAL_RANK, or on
cuda:0 where the host has fewer cards than ranks (over gloo). Like the
JAX CLI, ``--mesh`` is refused with ``generate`` and an explicit DxM
with ``--seq_parallel`` or ``--pp``. ``temporal train --seq_parallel N``
over N ranks trains with the time axis on a ring (ring attention,
``parallel/ring_attention.py``); ``temporal train --pp S
[--pp_microbatches M]`` over a multiple of S ranks pipelines the blocks
over S stages (GPipe, ``parallel/pipeline.py``), the other ranks joining
a data axis. As in the JAX CLI, ``--seed`` overrides
the random seed of the data splits and seeds every host RNG
(``utils.seeding.set_seed``); the training keys start from seed 0 in
both.

``--device`` takes the place of the JAX CLI's ``--platform``. It defaults
to ``cuda`` and raises when CUDA is absent: the port never moves to the
CPU on its own. ``--device cpu`` runs the plain PyTorch version of every
kernel (the CPU tests use it).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import os
import sys

import numpy as np
import torch

from sea_tpu_torch.parallel.multihost import is_primary

PORTED = (("encoder", "train"), ("encoder", "test"), ("temporal", "train"),
          ("temporal", "test"), ("temporal", "generate"))


def get_case(flow_type: str):
    """The CaseConfig of ``sea_tpu_torch.configs.<flow_type>``."""
    spec = (importlib.util.find_spec(f"sea_tpu_torch.configs.{flow_type}")
            if flow_type.isidentifier() else None)
    if spec is None:
        print(f"Error: no config module named '{flow_type}' in "
              f"sea_tpu_torch.configs (expected e.g. cylinder_flow, "
              f"multiphase_flow).")
        sys.exit(1)
    module = importlib.import_module(f"sea_tpu_torch.configs.{flow_type}")
    if not hasattr(module, "get_case"):
        print(f"Error: config module '{flow_type}' defines no get_case() "
              f"entry point.")
        sys.exit(1)
    return module.get_case()


def _load_data(case, synthetic: bool):
    """The JAX CLI's synthetic data: tr=8, T=41, 800 nodes."""
    if not synthetic:
        return None
    from sea_tpu_torch.data.synthetic import cylinder_like, multiphase_like
    gen = (multiphase_like if "multiphase" in case.run.case_name
           else cylinder_like)
    return gen(tr=8, T=41, n_nodes=800, seed=case.spatial_split.random_seed)


def fit_to_data(case, data):
    """The case fitted to synthetic data, which is smaller than the
    configured datasets: the window clamped to T-1 and the batch to the
    training trajectories, as the JAX CLI does."""
    tr, T = data[0].shape[:2]
    tt = case.temporal_train
    n_train = max(1, int(round(tr * case.temporal_split.train_fraction)))
    return case.replace(temporal_train=dataclasses.replace(
        tt, dataset_src_len=min(tt.dataset_src_len, T - 1),
        batch_size=min(tt.batch_size, n_train)))


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available here. The port runs "
            "on the GPU; pass --device cpu to run the plain PyTorch "
            "versions of its kernels instead.")
    return device


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train and serve SEA models with the PyTorch/CUDA port")
    parser.add_argument("flow_type",
                        help="e.g. cylinder_flow, multiphase_flow")
    parser.add_argument("model_type", choices=["encoder", "temporal"])
    parser.add_argument("mode", choices=["train", "test", "generate"])
    parser.add_argument("--model_path", default=None,
                        help=".npz checkpoint, or reference PyTorch .pt "
                             "state dict, to test, serve or resume "
                             "training from (default for test and serve: "
                             "the case's checkpoint under --save_dir)")
    parser.add_argument("--synthetic", action="store_true",
                        help="use generated synthetic data")
    parser.add_argument("--save_dir", default=None)
    parser.add_argument("--seed", type=int, default=None,
                        help="override the random_seed of the spatial and "
                             "temporal splits, and seed every host-side RNG "
                             "(python random, numpy, torch)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override the config's epoch count (train)")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="override the training batch size (train)")
    parser.add_argument("--compute_dtype",
                        choices=["f32", "bf16", "bf16_mixed", "bf16_shadow"],
                        default=None,
                        help="train modes: override the config's numerics "
                             "policy (TrainConfig.compute_dtype). "
                             "bf16_shadow = mixed precision with a "
                             "persistent bf16 weight copy in the optimizer "
                             "state, with --adam_mu_dtype bf16 the JAX "
                             "CLI's big-model recipe")
    parser.add_argument("--adam_mu_dtype", choices=["f32", "bf16"],
                        default=None,
                        help="train modes: AdamW first-moment storage dtype "
                             "(TrainConfig.adam_mu_dtype)")
    parser.add_argument("--optimizer", choices=["adamw", "adafactor"],
                        default=None,
                        help="train modes: optimizer family "
                             "(TrainConfig.optimizer). adafactor factors "
                             "the second moment and keeps no first moment")
    parser.add_argument("--precision",
                        choices=["f32", "bf16", "int8", "int4"],
                        default="f32",
                        help="serving precision for `temporal test` and "
                             "`temporal generate`: bf16 "
                             "casts the big matmul weights, int8/int4 "
                             "quantize them per output channel")
    parser.add_argument("--no_calibrate", action="store_true",
                        help="disable the default activation-aware int4 "
                             "calibration (weighted scales + bias "
                             "correction from a few train windows)")
    parser.add_argument("--kv_cache", choices=["auto", "f32", "bf16", "int8"],
                        default="auto",
                        help="serving KV-cache storage: 'auto' = bf16 iff "
                             "--precision int4, else f32 (the JAX CLI's "
                             "policy); 'int8' stores per-token-scaled int8 "
                             "planes")
    parser.add_argument("--drift_budget", type=float, default=0.05,
                        metavar="REL_L2",
                        help="int8/int4 serving: abort when the loaded "
                             "checkpoint's teacher-forced rel-L2 drift vs "
                             "f32 on two test windows exceeds this "
                             "(default 0.05)")
    parser.add_argument("--no_drift_check", action="store_true",
                        help="skip the per-checkpoint quantization drift "
                             "gate")
    parser.add_argument("--horizon", type=int, default=None, metavar="H",
                        help="`temporal generate`: rollout steps to "
                             "simulate, not tied to a dataset window (the "
                             "ib conditioning past the data holds the "
                             "trajectory's last value). Default: the "
                             "dataset window length")
    parser.add_argument("--trajectory", type=int, default=0, metavar="IDX",
                        help="`temporal generate`: the test-split window "
                             "that gives the initial latent state and the "
                             "ib conditioning (default 0)")
    parser.add_argument("--output", default=None, metavar="PATH",
                        help="`temporal generate`: .npy path of the decoded "
                             "fields [H, nodes, fields] (default "
                             "{save_dir}/generated_{case}_{run}.npy)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="train modes: write a torch.profiler trace "
                             "(Chrome/Perfetto, TensorBoard) of one "
                             "steady-state training epoch into DIR")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default: cuda:LOCAL_RANK "
                             "under torchrun), cuda:N or cpu")
    parser.add_argument("--mesh", default="auto",
                        help="rank grid for train modes: 'auto' (every rank "
                             "data-parallel when the process group has more "
                             "than one), 'none' (one device), or 'DxM' "
                             "(data x model/tensor-parallel, e.g. 4x2; D*M "
                             "ranks, launched by torchrun). `temporal test` "
                             "takes an explicit DxM: sharded serving")
    parser.add_argument("--seq_parallel", type=int, default=0, metavar="N",
                        help="temporal train only: sequence parallelism, "
                             "the time axis over a ring of N ranks (ring "
                             "attention on the flash kernels)")
    parser.add_argument("--pp", type=int, default=0, metavar="S",
                        help="temporal train only: pipeline parallelism, "
                             "the blocks over S stages (GPipe); the ranks "
                             "beyond S join a data axis")
    parser.add_argument("--pp_microbatches", type=int, default=0,
                        metavar="M",
                        help="GPipe microbatches per step with --pp "
                             "(default S)")
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error(f"{' '.join(unknown)}: not ported to sea_tpu_torch "
                     "yet (see ROADMAP.md)")
    if args.seq_parallel and (args.model_type, args.mode) != \
            ("temporal", "train"):
        parser.error("--seq_parallel only applies to `temporal train`")
    if args.pp:
        if (args.model_type, args.mode) != ("temporal", "train"):
            parser.error("--pp only applies to `temporal train`")
        if args.seq_parallel:
            parser.error("--pp and --seq_parallel are mutually exclusive")
        if args.pp < 2:
            parser.error(f"--pp needs at least 2 stages; got {args.pp}")
    if args.pp_microbatches and not args.pp:
        parser.error("--pp_microbatches requires --pp")
    if args.profile and args.mode != "train":
        parser.error("--profile only applies to train modes")
    if args.mode == "generate" and args.model_type != "temporal":
        parser.error("generate is a temporal (stage-2) serving mode")
    if (args.model_type, args.mode) not in PORTED:
        parser.error(f"`{args.model_type} {args.mode}` is not ported to "
                     "sea_tpu_torch yet (see ROADMAP.md)")
    if (args.compute_dtype or args.batch_size is not None
            or args.adam_mu_dtype or args.optimizer) and args.mode != "train":
        parser.error("--compute_dtype/--batch_size/--adam_mu_dtype/"
                     "--optimizer only apply to train modes (serving "
                     "precision is --precision)")
    if args.mode != "generate" and (args.horizon is not None
                                    or args.trajectory != 0
                                    or args.output is not None):
        parser.error("--horizon/--trajectory/--output only apply to "
                     "`temporal generate`")
    if args.horizon is not None and args.horizon < 1:
        parser.error(f"--horizon must be >= 1; got {args.horizon}")
    if (args.model_type, args.mode) not in (("temporal", "test"),
                                            ("temporal", "generate")) and (
            args.precision != "f32" or args.kv_cache != "auto"):
        parser.error("--precision/--kv_cache only apply to `temporal test` "
                     "and `temporal generate` (rollout serving); training "
                     "takes --compute_dtype")
    if args.batch_size is not None and args.batch_size < 1:
        parser.error(f"--batch_size must be >= 1; got {args.batch_size}")
    if args.model_path and not args.model_path.endswith((".npz", ".pt")):
        parser.error(f"--model_path {args.model_path}: expected an .npz "
                     "checkpoint or a reference PyTorch .pt state dict")
    device = resolve_device(args.device)
    # A process group (torchrun) must be joined before the mesh; nothing
    # happens on one process.
    from sea_tpu_torch.parallel.multihost import (initialize_multihost,
                                                  local_device)
    device = local_device(device)
    initialize_multihost(device=device)
    meshes = _resolve_meshes(parser, args)
    # Every rank but 0 computes without printing.
    with (contextlib.nullcontext() if is_primary()
          else contextlib.redirect_stdout(io.StringIO())):
        return _run(parser, args, device, meshes)


def _run(parser, args, device, meshes):
    mesh = meshes[0]
    case = get_case(args.flow_type)
    if args.seed is not None:
        from sea_tpu_torch.utils.seeding import set_seed
        set_seed(args.seed)
        case = case.replace(
            spatial_split=dataclasses.replace(case.spatial_split,
                                              random_seed=args.seed),
            temporal_split=dataclasses.replace(case.temporal_split,
                                               random_seed=args.seed))
    if args.save_dir:
        case = case.replace(run=dataclasses.replace(case.run,
                                                    save_dir=args.save_dir))
    if args.compute_dtype or args.batch_size is not None \
            or args.adam_mu_dtype or args.optimizer:
        # The recipe of the stage being trained, set before any resume
        # template is built: bf16_shadow carries state of its own.
        from sea_tpu_torch.utils.precision import POLICY_BY_FLAG
        stage = ("spatial_train" if args.model_type == "encoder"
                 else "temporal_train")
        updates = {}
        if args.compute_dtype:
            updates["compute_dtype"] = POLICY_BY_FLAG[args.compute_dtype]
        if args.batch_size is not None:
            updates["batch_size"] = args.batch_size
        if args.adam_mu_dtype:
            updates["adam_mu_dtype"] = ("bfloat16" if args.adam_mu_dtype
                                        == "bf16" else "float32")
        if args.optimizer:
            updates["optimizer"] = args.optimizer
        case = case.replace(**{stage: dataclasses.replace(
            getattr(case, stage), **updates)})
    data = _load_data(case, args.synthetic)
    if data is not None:
        case = fit_to_data(case, data)
    if args.model_type == "encoder":
        if args.mode == "train":
            return _train_encoder(case, args, data, device, mesh)
        return _test_encoder(case, args, data, device)
    if args.mode == "train":
        return _train(case, args, data, device, *meshes)
    return _serve(case, args, data, device, parser, mesh)


def _resolve_meshes(parser, args):
    """(mesh, seq_mesh, pipe_mesh), each a grid of ranks or None: the JAX
    CLI's ``_resolve_meshes``. Train modes: 'auto' spans every rank
    data-parallel when the process group has two or more, else the plain
    one-device path; --seq_parallel N puts the time axis on a ring of the
    N ranks; --pp S builds the (data, pipe) grid with data = ranks / S.
    `temporal test`: an explicit DxM shards the serving rollout; 'auto'
    serves on one device. Where the JAX CLI idles devices the port
    raises: N and S x data must cover every rank (ROADMAP.md Queue 3)."""
    from sea_tpu_torch.parallel.mesh import (make_mesh, make_seq_mesh,
                                             parse_mesh)
    from sea_tpu_torch.parallel.multihost import world_size
    from sea_tpu_torch.parallel.pipeline import make_pipe_mesh

    def parse_dxm(spec):
        try:
            n_data, n_model = parse_mesh(spec)
        except ValueError:
            parser.error(f"--mesh must be 'auto', 'none', or DxM "
                         f"(e.g. 4x2); got {args.mesh!r}")
        try:
            return make_mesh(n_data, n_model)
        except ValueError as exc:
            parser.error(str(exc))

    spec = args.mesh.strip().lower()
    if args.mode != "train":
        if (args.model_type, args.mode) == ("temporal", "test") \
                and spec not in ("auto", "none"):
            return parse_dxm(spec), None, None
        if args.mode == "generate" and spec not in ("auto", "none"):
            parser.error("--mesh sharding applies to train modes and "
                         "`temporal test`; generate runs the single-device "
                         "fused program")
        return None, None, None
    if args.seq_parallel:
        if spec not in ("auto", "none"):
            parser.error(
                f"--seq_parallel and --mesh {args.mesh} are mutually "
                "exclusive: sequence parallelism shards the time axis "
                "over ALL requested devices (ring attention)")
        try:
            return None, make_seq_mesh(args.seq_parallel), None
        except ValueError as exc:
            parser.error(str(exc))
    if args.pp:
        if spec not in ("auto", "none"):
            parser.error(
                f"--pp and --mesh {args.mesh} are mutually exclusive: "
                "pipeline parallelism builds its own ('data', 'pipe') "
                "mesh — devices beyond the S stages join the data axis")
        n = world_size()
        if n < args.pp:
            parser.error(f"--pp {args.pp} needs {args.pp} devices; "
                         f"{n} visible")
        if n % args.pp:
            parser.error(f"--pp {args.pp} needs the {n} ranks to split "
                         "into whole pipelines (a multiple of the stages)")
        print(f"pipeline mesh: data={n // args.pp} x pipe={args.pp}")
        return None, None, make_pipe_mesh(args.pp, n // args.pp)
    if spec == "none":
        return None, None, None
    if spec == "auto":
        n = world_size()
        if n == 1:
            return None, None, None
        print(f"auto mesh: data={n} x model=1 over {n} ranks")
        return make_mesh(n, 1), None, None
    return parse_dxm(spec), None, None


def _tracker(case, args):
    from sea_tpu_torch.train.tracking import create_error_tracker
    return create_error_tracker(
        use_wandb=case.run.use_wandb, project_name=case.run.project_name,
        run_name=f"{args.flow_type}_{args.model_type}_{args.mode}",
        save_dir=case.run.save_dir)


def load_any_checkpoint(path: str, template, cfg, *, kind: str):
    """The params of an npz checkpoint, or of a reference PyTorch state
    dict (``.pt``, mapped by utils/torch_compat.py for ``kind`` "spatial"
    or "temporal" under ``cfg``), as a numpy tree of ``template``'s
    structure and shapes (a mapped tree of another is refused)."""
    if not path.endswith(".pt"):
        from sea_tpu_torch.utils.checkpoint import load_params
        return load_params(path, template)
    from sea_tpu_torch.utils import torch_compat as TC
    from sea_tpu_torch.utils.checkpoint import _flatten
    mapper = (TC.spatial_params_from_torch if kind == "spatial"
              else TC.temporal_params_from_torch)
    params = mapper(TC.load_torch_state_dict(path), cfg)
    got, want = _flatten(params), _flatten(template)
    bad = sorted(k for k in got.keys() | want.keys()
                 if k not in got or k not in want
                 or got[k].shape != want[k].shape)
    if bad:
        raise ValueError(f"{path}: the mapped {kind} tree differs from the "
                         f"configured model at {bad[:5]}")
    return params


def load_train_checkpoint(path: str, template, train_cfg, cfg=None,
                          kind: str = "temporal"):
    """(params, opt_state | None), numpy trees, for --model_path resume:
    the checkpoint's params and, when it carries an optimizer state of the
    structure ``train_cfg``'s optimizer has (AdamW with f32 or bf16 mu, or
    Adafactor; with the schedule's count or without; alone or under the
    bf16 shadow), that state, so resume continues it. A state of another
    structure (written under another --compute_dtype or --optimizer
    recipe: a leaf missing, or one of another shape) resumes the params
    with a fresh optimizer and a warning. A reference ``.pt`` state dict
    (the ``kind`` model of ``cfg``) carries no optimizer state: its params
    resume with a fresh optimizer. ``template``: the model's params,
    numpy."""
    if path.endswith(".pt"):
        params = load_any_checkpoint(path, template, cfg, kind=kind)
        print(f"{path} is a reference state dict with no optimizer state: "
              "resuming its params with a FRESH optimizer")
        return params, None
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.utils.checkpoint import load_full_checkpoint
    from sea_tpu_torch.utils.params import opt_state_template
    opt_template = opt_state_template(make_optimizer(train_cfg), template)
    params, _, _ = load_full_checkpoint(path, template, None)
    try:
        _, opt_state, _ = load_full_checkpoint(path, template, opt_template)
    except (KeyError, ValueError) as exc:
        print(f"Warning: optimizer state in {path} does not match the "
              f"configured optimizer structure ({exc}) — likely saved "
              "under a different --compute_dtype or --optimizer recipe. "
              "Resuming params with a FRESH optimizer; pass the original "
              "recipe flags to continue its state.")
        return params, None
    if opt_state is not None:
        print("Restored optimizer state (resume continues its moments)")
    return params, opt_state


def _train_encoder(case, args, data, device, mesh=None):
    """`encoder train`: returns the best-validation params (numpy)."""
    from sea_tpu_torch.models.spatial import init_spatial
    from sea_tpu_torch.train.train_spatial import process_data, train
    from sea_tpu_torch.utils.checkpoint import save_checkpoint
    from sea_tpu_torch.utils.params import to_numpy
    init_params = init_opt = precomputed = None
    if args.model_path:
        # The template needs n_inp, derived from the data: process it once
        # and hand it to the training loop.
        precomputed = process_data(case, data=data)
        template = to_numpy(init_spatial(precomputed.spatial_cfg,
                                         torch.Generator().manual_seed(0),
                                         device="cpu"))
        init_params, init_opt = load_train_checkpoint(
            args.model_path, template, case.spatial_train,
            precomputed.spatial_cfg, kind="spatial")
        print(f"Continuing training from model: {args.model_path}")
    params, _ = train(case, _tracker(case, args), device=device, data=data,
                      epochs=args.epochs, init_params=init_params,
                      init_opt_state=init_opt, precomputed=precomputed,
                      profile_dir=args.profile, mesh=mesh)
    if case.spatial_train.final_save and is_primary():
        save_checkpoint(case.run.save_dir, "final_model_encoder",
                        case.run.case_name, case.run.run_name, params)
    return params


def _test_encoder(case, args, data, device):
    """`encoder test`: returns the three reconstruction metrics."""
    from sea_tpu_torch.models.spatial import init_spatial
    from sea_tpu_torch.train.evaluate import test_encoder_decoder
    from sea_tpu_torch.train.train_spatial import process_data
    from sea_tpu_torch.utils.checkpoint import checkpoint_path
    from sea_tpu_torch.utils.params import from_numpy, to_numpy
    sd = process_data(case, data=data)
    template = to_numpy(init_spatial(sd.spatial_cfg,
                                     torch.Generator().manual_seed(0),
                                     device="cpu"))
    path = args.model_path or checkpoint_path(
        case.run.save_dir, "encoder_decoder", case.run.case_name,
        case.run.run_name)
    params = from_numpy(load_any_checkpoint(path, template, sd.spatial_cfg,
                                            kind="spatial"), device)
    print(f"Using pretrained encoder model: {path}")
    return test_encoder_decoder(params, case, sd.test, sd.mesh_processor,
                                device=device, spatial_cfg=sd.spatial_cfg)


def _train(case, args, data, device, mesh=None, seq_mesh=None,
           pipe_mesh=None):
    """`temporal train`: returns the best-validation params (numpy)."""
    from sea_tpu_torch.models.temporal import init_temporal
    from sea_tpu_torch.train.train_temporal import train
    from sea_tpu_torch.utils.checkpoint import save_checkpoint
    from sea_tpu_torch.utils.params import to_numpy
    init_params = init_opt = None
    if args.model_path:
        template = to_numpy(init_temporal(case.temporal,
                                          torch.Generator().manual_seed(0),
                                          device="cpu"))
        init_params, init_opt = load_train_checkpoint(
            args.model_path, template, case.temporal_train, case.temporal,
            kind="temporal")
        print(f"Continuing training from model: {args.model_path}")
    params, _ = train(case, _tracker(case, args), device=device, data=data,
                      epochs=args.epochs, init_params=init_params,
                      init_opt_state=init_opt, profile_dir=args.profile,
                      mesh=mesh, seq_mesh=seq_mesh, pipe_mesh=pipe_mesh,
                      pipe_microbatches=args.pp_microbatches)
    if case.temporal_train.final_save and is_primary():
        save_checkpoint(case.run.save_dir, "final_model_temporal",
                        case.run.case_name, case.run.run_name, params)
    return params


def _serve(case, args, data, device, parser, mesh=None):
    """`temporal test` (returns the evaluation metrics) and `temporal
    generate` (returns the generated fields [H, N, F]): one load and one
    set of serving transforms."""
    from sea_tpu_torch.utils.checkpoint import checkpoint_path
    from sea_tpu_torch.models.temporal import (init_temporal,
                                               is_scan_incremental)
    from sea_tpu_torch.train.evaluate import fused_autoregressive_evaluation
    from sea_tpu_torch.train.train_temporal import process_data
    from sea_tpu_torch.utils import precision as prec
    from sea_tpu_torch.utils.params import from_numpy, to_numpy

    td = process_data(case, data=data, device=device)
    template = to_numpy(init_temporal(case.temporal,
                                      torch.Generator().manual_seed(0),
                                      device="cpu"))
    path = args.model_path or checkpoint_path(
        case.run.save_dir, "temporal", case.run.case_name, case.run.run_name)
    print(f"Using pretrained model: {path}")
    params = from_numpy(load_any_checkpoint(path, template, case.temporal,
                                            kind="temporal"), device)
    # --precision applies end to end: the rollout and the stage-1 decoder
    # run the reduced-precision weights (encoding stays f32), and on one
    # device the temporal attention projections are fused (qkv/kv) before
    # any cast; a mesh keeps them apart (its ranks split q, k and v by
    # heads) and skips the int4 calibration, as the JAX CLI does.
    spatial_params = None
    params_f32 = params  # for the per-checkpoint drift gate
    fuse = (prec.fuse_attention_projections if mesh is None
            else (lambda p: p))
    if args.precision == "bf16":
        params = prec.cast_weights_bf16(fuse(params))
        spatial_params = prec.cast_weights_bf16(td.latent_service.params)
        print("Serving precision: bf16 weights (rollout + decode)")
    elif args.precision in ("int8", "int4"):
        quantize = (prec.quantize_weights_int8 if args.precision == "int8"
                    else prec.quantize_weights_int4)
        params = fuse(params)
        if args.precision == "int4" and not args.no_calibrate \
                and mesh is None:
            from sea_tpu_torch.utils.calibration import calibrate_temporal
            n_cal = min(4, td.train.src.shape[0])
            stats = calibrate_temporal(
                params, case.temporal,
                [(td.train.src[:n_cal], td.train.ib[:n_cal])])
            params = prec.quantize_weights_int4(params, act_stats=stats)
            print(f"int4 calibration: activation-aware scales + bias "
                  f"correction ({n_cal} train windows)")
        else:
            params = quantize(params)
        spatial_params = quantize(td.latent_service.params)
        print(f"Serving precision: {args.precision} weights "
              "(per-output-channel, rollout + decode)")
    if args.precision in ("int8", "int4") and not args.no_drift_check:
        drift = prec.teacher_forced_drift(params_f32, params, case.temporal,
                                          td.test.src, td.test.ib)
        print(f"Per-checkpoint teacher-forced drift ({args.precision} vs "
              f"f32): {drift:.4f} (budget {args.drift_budget})")
        if drift > args.drift_budget:
            parser.error(
                f"--precision {args.precision}: teacher-forced drift "
                f"{drift:.4f} on the loaded checkpoint exceeds the budget "
                f"{args.drift_budget}. Serve this checkpoint at higher "
                "precision, raise --drift_budget explicitly, or pass "
                "--no_drift_check to override.")
    if args.kv_cache == "auto":
        cache_dtype = (torch.bfloat16 if args.precision == "int4"
                       else torch.float32)
    else:
        cache_dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                       "int8": torch.int8}[args.kv_cache]
    if args.mode == "generate":
        from sea_tpu_torch.train.evaluate import generate_trajectory
        out = args.output or os.path.join(
            case.run.save_dir,
            f"generated_{case.run.case_name}_{case.run.run_name}.npy")
        fields = generate_trajectory(
            params, case, td.test, td.latent_service, td.mesh_processor,
            trajectory=args.trajectory, horizon=args.horizon,
            spatial_params=spatial_params, cache_dtype=cache_dtype)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        np.save(out, fields)
        print(f"Generated {fields.shape[0]} steps x {fields.shape[1]} nodes "
              f"x {fields.shape[2]} fields -> {out}")
        return fields
    engine = "auto"
    if args.kv_cache != "auto":
        # The scan engine is the only one with a KV cache.
        if not is_scan_incremental(case.temporal):
            parser.error(
                f"--kv_cache {args.kv_cache} requires a scan-incremental "
                "temporal config (causal, src_len == 0, non-attention ib "
                "mode): this config serves on the prefix engine, which has "
                "no KV cache")
        engine = "scan"
        print(f"kv_cache={args.kv_cache}: scan engine forced (the prefix "
              "engine has no KV cache)")
    if mesh is not None and is_scan_incremental(case.temporal):
        # Explicit --mesh DxM: trajectories over the data ranks, the
        # params tensor-parallel over the model ranks; every rank decodes
        # and scores, rank 0 writes the files.
        from sea_tpu_torch.train.evaluate import \
            full_autoregressive_evaluation
        print(f"sharded serving: mesh {mesh.shape}")
        results = full_autoregressive_evaluation(
            params, case, td.test, td.latent_service, td.mesh_processor,
            spatial_params=spatial_params, epoch=0, plot_traj=True,
            cache_dtype=cache_dtype, mesh=mesh)
    else:
        results = fused_autoregressive_evaluation(
            params, case, td.test, td.latent_service, td.mesh_processor,
            spatial_params=spatial_params, cache_dtype=cache_dtype,
            engine=engine)
    print("Test Results:")
    for key in ("encoded_rel_mse", "decoded_rel_mse"):
        print(f"{key}: {results[key]}")
    return results


if __name__ == "__main__":
    main()
