"""Command-line entry point of the port.

    python -m sea_tpu_torch.cli <flow_type> temporal train
        [--epochs N] [--batch_size N] [--synthetic] [--save_dir DIR]
        [--seed N] [--device cuda|cpu|cuda:N]
    python -m sea_tpu_torch.cli <flow_type> temporal test
        [--model_path PATH] [--synthetic] [--save_dir DIR] [--seed N]
        [--device cuda|cpu|cuda:N]

Same grammar as ``python -m sea_tpu.cli``. Ported so far: ``temporal
train`` (single device, f32 AdamW; it writes the JAX driver's npz
checkpoints) and ``temporal test``, the f32 serving rollout with decoded
evaluation. Every other mode and flag exits with a parser error that
points to ROADMAP.md. As in the JAX CLI, ``--seed`` overrides the random
seed of the data splits; the training keys start from seed 0 in both.

``--device`` takes the place of the JAX CLI's ``--platform``. It defaults
to ``cuda`` and raises when CUDA is absent: the port never moves to the
CPU on its own. ``--device cpu`` runs the plain PyTorch version of every
kernel (the CPU tests use it).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import sys

import torch

PORTED = (("temporal", "train"), ("temporal", "test"))


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
                        help="temporal .npz checkpoint (default: the case's "
                             "temporal checkpoint under --save_dir)")
    parser.add_argument("--synthetic", action="store_true",
                        help="use generated synthetic data")
    parser.add_argument("--save_dir", default=None)
    parser.add_argument("--seed", type=int, default=None,
                        help="override the random_seed of the spatial and "
                             "temporal splits")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override the config's epoch count (train)")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="override the training batch size (train)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error(f"{' '.join(unknown)}: not ported to sea_tpu_torch "
                     "yet (see ROADMAP.md)")
    if (args.model_type, args.mode) not in PORTED:
        parser.error(f"`{args.model_type} {args.mode}` is not ported to "
                     "sea_tpu_torch yet; only `temporal train` and "
                     "`temporal test` are (see ROADMAP.md)")
    if args.batch_size is not None and args.mode != "train":
        parser.error("--batch_size only applies to train modes")
    if args.batch_size is not None and args.batch_size < 1:
        parser.error(f"--batch_size must be >= 1; got {args.batch_size}")
    if args.model_path and not args.model_path.endswith(".npz"):
        parser.error("--model_path: only .npz checkpoints are ported yet "
                     "(see ROADMAP.md)")
    device = resolve_device(args.device)

    case = get_case(args.flow_type)
    if args.seed is not None:
        case = case.replace(
            spatial_split=dataclasses.replace(case.spatial_split,
                                              random_seed=args.seed),
            temporal_split=dataclasses.replace(case.temporal_split,
                                               random_seed=args.seed))
    if args.save_dir:
        case = case.replace(run=dataclasses.replace(case.run,
                                                    save_dir=args.save_dir))
    if args.batch_size is not None:
        case = case.replace(temporal_train=dataclasses.replace(
            case.temporal_train, batch_size=args.batch_size))
    data = _load_data(case, args.synthetic)
    if data is not None:
        # Synthetic data is smaller than the configured datasets: clamp
        # the window to T-1 and the batch to the training trajectories, as
        # the JAX CLI does.
        tr, T = data[0].shape[:2]
        tt = case.temporal_train
        n_train = max(1, int(round(tr * case.temporal_split.train_fraction)))
        case = case.replace(temporal_train=dataclasses.replace(
            tt, dataset_src_len=min(tt.dataset_src_len, T - 1),
            batch_size=min(tt.batch_size, n_train)))
    if args.mode == "train":
        return _train(case, args, data, device)
    return _test(case, args, data, device)


def _train(case, args, data, device):
    """`temporal train`: returns the best-validation params (numpy)."""
    if args.model_path:
        raise SystemExit("--model_path with `temporal train` (resume) is "
                         "not ported to sea_tpu_torch yet (see ROADMAP.md)")
    from sea_tpu_torch.train.tracking import create_error_tracker
    from sea_tpu_torch.train.train_temporal import train
    from sea_tpu_torch.utils.checkpoint import save_checkpoint
    tracker = create_error_tracker(
        use_wandb=case.run.use_wandb, project_name=case.run.project_name,
        run_name=f"{args.flow_type}_{args.model_type}_{args.mode}",
        save_dir=case.run.save_dir)
    params, _ = train(case, tracker, device=device, data=data,
                      epochs=args.epochs)
    if case.temporal_train.final_save:
        save_checkpoint(case.run.save_dir, "final_model_temporal",
                        case.run.case_name, case.run.run_name, params)
    return params


def _test(case, args, data, device):
    """`temporal test`: returns the evaluation metrics."""
    from sea_tpu_torch.utils.checkpoint import checkpoint_path, load_params
    from sea_tpu_torch.models.temporal import init_temporal
    from sea_tpu_torch.train.evaluate import fused_autoregressive_evaluation
    from sea_tpu_torch.train.train_temporal import process_data
    from sea_tpu_torch.utils.params import from_numpy, to_numpy

    td = process_data(case, data=data, device=device)
    template = to_numpy(init_temporal(case.temporal,
                                      torch.Generator().manual_seed(0),
                                      device="cpu"))
    path = args.model_path or checkpoint_path(
        case.run.save_dir, "temporal", case.run.case_name, case.run.run_name)
    print(f"Using pretrained model: {path}")
    params = from_numpy(load_params(path, template), device)
    results = fused_autoregressive_evaluation(
        params, case, td.test, td.latent_service, td.mesh_processor)
    print("Test Results:")
    for key in ("encoded_rel_mse", "decoded_rel_mse"):
        print(f"{key}: {results[key]}")
    return results


if __name__ == "__main__":
    main()
