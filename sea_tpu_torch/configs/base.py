"""Typed configuration system for SEA-TPU.

The PyTorch reference (configs/cylinder_flow.py:2-71,73-162) uses plain dicts
that are *mutated at runtime* (``config['n_inp']`` set during preprocessing,
train/train_encoder.py:136; ``train_size`` at train_encoder.py:101). Here every
key of the reference config surface becomes an explicit dataclass field, and
runtime-derived quantities (``n_inp``, ``num_patches``, ``temporal_embed_dim``)
are computed properties or explicit ``derive_*`` steps instead of dict mutation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MeshConfig:
    """Spatial partitioning of the mesh into patches.

    Mirrors the mesh-processing keys of the reference config
    (configs/cylinder_flow.py:15-24) and the partitioner contract
    (utils/data_processors.py:9-111): an (m-1) x (n-1) [x (k-1)] grid of
    patches over the bounding box of the node coordinates.
    """

    dimension: str = "2D"  # "2D" | "3D"
    m: int = 9
    n: int = 9
    k: Optional[int] = None
    pad_id: int = -1
    pad_field_value: float = 0.0
    # Optional global min-max scaling to this range before patchify
    # (reference: scale_feature_range, None disables scaling).
    scale_feature_range: Optional[Tuple[float, float]] = None
    scaler_name: str = "scaler"

    @property
    def num_patches(self) -> int:
        if self.dimension == "3D":
            assert self.k is not None, "3D mesh requires k"
            return (self.m - 1) * (self.n - 1) * (self.k - 1)
        return (self.m - 1) * (self.n - 1)


@dataclass(frozen=True)
class SpatialModelConfig:
    """Stage-1 ViT-style mesh autoencoder hyperparameters.

    Mirrors models/encoder_decoder.py:149-176 construction arguments and the
    spatial section of configs/cylinder_flow.py:25-33.
    """

    field_groups: Tuple[Tuple[int, ...], ...] = ((0, 1), (2,))
    mlp_hidden: int = 480
    num_layers: int = 12
    embed_dim: int = 16  # latent dim per field group (D)
    n_heads: int = 8
    block_size: int = 2024  # max_len for attention buffers
    src_len: int = 0  # causal-mask diagonal offset (0 in both reference cases)
    dropout: float = 0.0
    variational: bool = False
    # n_inp = padded cells-per-patch; known only after partitioning
    # (reference mutates config['n_inp'] at train_encoder.py:136).
    n_inp: Optional[int] = None

    @property
    def num_groups(self) -> int:
        return len(self.field_groups)

    @property
    def num_fields(self) -> int:
        return sum(len(g) for g in self.field_groups)

    @property
    def token_dim(self) -> int:
        """Width of the per-patch token the encoder transformer runs on."""
        return self.num_groups * self.embed_dim

    def with_n_inp(self, n_inp: int) -> "SpatialModelConfig":
        return dataclasses.replace(self, n_inp=n_inp)


@dataclass(frozen=True)
class TemporalModelConfig:
    """Stage-2 State-Exchange temporal transformer hyperparameters.

    Mirrors models/temporal.py:326-365 construction arguments and the temporal
    section of configs/cylinder_flow.py:111-128. ``embed_dim`` must equal
    ``num_patches * spatial_embed_dim`` (the flattened latent mesh state per
    field group).
    """

    num_layers: int = 1
    embed_dim: int = 1024  # E = P * D_spatial
    n_heads: int = 8
    block_size: int = 2024  # max_len
    scale_ratio: int = 8  # MLP expansion
    src_len: int = 0
    num_fields: int = 2  # G = number of field groups / latent streams
    down_proj: int = 2  # cross-attention down-projection ratio
    dropout: float = 0.1
    exchange_mode: str = "sea"  # sea | addition | simple | pool
    pos_encoding_mode: str = "learnable"  # accepted but unused (RoPE instead),
    # kept for config parity with temporal.py:383-387
    ib_scale_mode: str = "mlp"  # fourier | linear | mlp
    ib_addition_mode: str = "add"  # add | concat | attention | none
    ib_mlp_layers: int = 1
    ib_num: int = 1  # number of input/boundary scalars
    add_info_after_cross: bool = True
    ln_type: str = "adaln"  # adaln | ln
    pool_update_method: str = "mlp"  # linear | mlp | pooling (pool mode only)
    # Rematerialize each temporal block in the backward pass
    # (jax.checkpoint). True/'full': save only block boundaries — maximal
    # memory saving, recomputes the matmuls (long-sequence training).
    # 'dots': checkpoint_policies.dots_saveable — matmul outputs are
    # SAVED, only the cheap elementwise interiors (GELU, LN, residual
    # adds) recompute in the backward pass; trades a little VPU recompute
    # for the hidden-activation HBM round-trips, aimed at the
    # activation-traffic-bound large-batch regime (BASELINE.md MFU rows).
    # Off by default (SEA-scale fits comfortably).
    remat: object = False  # False | True | "full" | "dots"
    # Trace-time stacking of the per-field MLP/proj/norm applications
    # into ONE batched einsum over a leading G axis (SURVEY §7 "vmap
    # with stacked params"): G GEMM dispatches become one [G, ...]
    # batched GEMM. The param LAYOUT is unchanged (checkpoints, torch
    # parity, TP specs untouched); jnp.stack materializes the stacked
    # weights per step — measured-negligible next to step traffic
    # (~0.2 ms of a 25 ms cylinder step). Semantically identical to the
    # per-field loop (equality-tested incl. dropout); OFF by default
    # pending an on-TPU win (A/B via tools/bench_training.py --stack).
    stack_fields: bool = False
    # The conditioning stream is CONSTANT over time (e.g. a per-trajectory
    # Reynolds number — true for both shipped datasets): every ib-only
    # activation (AdaLN cond nets, ib-injection embedding) is computed on
    # [B, 1] rows and broadcast over T instead of [B, T] rows — exactly
    # the same numbers, ~T x fewer cond-GEMM rows. AUTO-DETECTED by the
    # temporal train driver from the actual host data (never guessed);
    # ignored under sequence-parallel meshes (ib is T-sharded there).
    ib_time_constant: bool = False
    # Fixed concat width for ib_addition_mode == 'concat' (temporal.py:40).
    ib_dim_concat: int = 64

    def __post_init__(self):
        if self.exchange_mode not in ("sea", "addition", "simple", "pool"):
            raise ValueError(f"Invalid exchange_mode: {self.exchange_mode!r}")
        if self.pos_encoding_mode not in ("learnable", "fixed"):
            raise ValueError(
                f"Invalid pos_encoding_mode: {self.pos_encoding_mode!r}")
        if self.ib_scale_mode not in ("fourier", "linear", "mlp"):
            raise ValueError(f"Invalid ib_scale_mode: {self.ib_scale_mode!r}")
        if self.ib_addition_mode not in ("add", "concat", "attention", "none"):
            raise ValueError(
                f"Invalid ib_addition_mode: {self.ib_addition_mode!r}")
        if self.ln_type.lower() not in ("adaln", "ln"):
            raise ValueError(f"Invalid ln_type: {self.ln_type!r}")
        if self.remat not in (False, True, "full", "dots"):
            raise ValueError(
                f"Invalid remat: {self.remat!r} (False | True | 'full' | "
                "'dots') — a truthy typo would silently select FULL "
                "rematerialization")
        if self.ib_addition_mode == "concat" and self.add_info_after_cross:
            raise ValueError(
                "ib_addition_mode='concat' requires "
                "add_info_after_cross=False: concat widens the stream to "
                "internal_embed_dim, and the attention/norm stack is sized "
                "for the WIDENED dim — injecting after the exchange feeds "
                "them the narrow stream (the reference crashes on the "
                "same mismatch, temporal.py:47,131-142)")

    @property
    def internal_embed_dim(self) -> int:
        # temporal.py:47 — concat mode widens the stream by ib_dim_concat.
        if self.ib_addition_mode == "concat":
            return self.embed_dim + self.ib_dim_concat
        return self.embed_dim

    @property
    def down_dim(self) -> int:
        # temporal.py:59-60
        return self.internal_embed_dim // self.down_proj

    @property
    def ib_dim(self) -> int:
        # temporal.py:100-101
        if self.ib_addition_mode == "concat":
            return self.ib_dim_concat
        return self.embed_dim


@dataclass(frozen=True)
class SplitConfig:
    """Train/val/test split. Reference: configs/cylinder_flow.py:11-14,82-85."""

    train_fraction: float = 0.8
    val_fraction: float = 0.1
    random_seed: int = 42


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + loop cadence. Reference: configs/cylinder_flow.py:40-46,
    139-150 and utils/train_utils.py:33-39."""

    batch_size: int = 128
    eval_batch_size: int = 8  # temporal val/test loaders (train_temporal.py:85-86)
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    scheduler: Optional[str] = None  # None | "linear"
    epoch_num: int = 5000
    validation_interval: int = 10
    full_eval_interval: int = 100  # temporal only
    kl_weight_min: float = 0.0
    kl_weight_max: float = 0.0
    final_save: bool = False
    # Temporal dataset windowing (configs/cylinder_flow.py:140-143)
    dataset_src_len: int = 399
    dataset_overlap: int = 0
    dataset_time_shifting: bool = False
    # Numerics policy for the train-step hot path
    # (utils.precision.train_cast). Default float32 matches the reference
    # exactly; "bfloat16" casts the big matmul weights to bf16 inside the
    # loss (f32 AdamW master params, f32 loss/softmax) for ~1.7x
    # memory-bandwidth headroom; "bfloat16_mixed" additionally runs bf16
    # activations (every matmul bf16xbf16 on the MXU; softmax / LN stats /
    # RoPE / loss stay f32) — opt in per case. "bfloat16_shadow" is mixed
    # plus a persistent bf16 weight copy carried in the optimizer state
    # (train/optim.with_bf16_shadow): removes the per-step f32 master
    # cast-read and halves gradient HBM traffic (grads emerge bf16) in
    # the TEMPORAL train steps; spatial steps accept it and run it as
    # plain mixed (their params are too small for the saving to matter).
    compute_dtype: str = "float32"
    # ^ "float32"|"bfloat16"|"bfloat16_mixed"|"bfloat16_shadow"
    # Per-step grad/param global-norm observability (the wandb.watch
    # equivalent). XLA fuses these reductions into the AdamW update
    # passes on the measured configs (profile: the update fusions carry
    # two scalar outputs), so the cost is usually nil — the flag exists
    # for configs where fusion does not happen.
    log_norms: bool = True
    # Per-TENSOR grad/param L2 norms in the train-step stats — the
    # wandb.watch histogram equivalent (reference utils/train_utils.py:
    # 75-76). Logged under phase "tensors" once per epoch (last batch).
    # Requires log_norms. Off by default: ~2 scalars per tensor of extra
    # readback on logging epochs.
    log_per_tensor: bool = False
    # AdamW first-moment storage dtype: "bfloat16" halves mu's HBM
    # traffic (train/optim.py) — the update passes are the largest
    # single cost of the big-model train step. "float32" (default)
    # matches the reference numerics exactly.
    adam_mu_dtype: str = "float32"  # "float32" | "bfloat16"
    # Optimizer family. "adamw" (default) is the reference's optimizer
    # (utils/train_utils.py:33-39). "adafactor" (optax, factored second
    # moment, no first moment, update-RMS clipping 1.0, lr-scaled like
    # Adam via multiply_by_parameter_scale=False) shrinks optimizer
    # state from 2x params (f32 mu+nu) to ~(rows+cols) per matrix —
    # on the 201M-param multiphase model that removes ~2.4 GB/step of
    # update-pass HBM traffic, the largest single cost of the train
    # step (BASELINE.md "Where the time goes"). Different training
    # dynamics than AdamW: opt in per case, convergence-pinned in
    # tests/test_features.py.
    optimizer: str = "adamw"  # "adamw" | "adafactor"
    # Keep the TRAIN split resident in device HBM and gather minibatches
    # on-device (jnp.take with host-chosen indices) instead of slicing
    # host arrays and re-uploading every step. Identical batch order and
    # numerics (data/datasets.batch_index_iterator is the single source
    # of the shuffle); saves one host->device transfer per step — on a
    # remote/tunneled TPU that is a round-trip per batch. Applies to the
    # single-device temporal path; auto-falls back to host batching when
    # the split exceeds the resident budget — device_resident_max_bytes
    # further bounded by half the device's free HBM at setup time
    # (data/datasets.device_resident_budget), so pinning the split can
    # never OOM a run that fit under host batching — under time_shifting
    # (windows regenerate on host every epoch), or on sharded paths.
    device_resident_data: bool = True
    device_resident_max_bytes: int = 4 << 30


@dataclass(frozen=True)
class RunConfig:
    """Paths, naming, tracking. Reference: configs/cylinder_flow.py:4-10,47-54."""

    save_dir: str = "./checkpoints"
    field_data_path: str = "./data/CF/all_data/field_data.npy"
    input_path: Optional[str] = "./data/CF/all_data/input_data.npy"
    coordinates_path: str = "./data/CF/all_data/coordinates.npy"
    case_name: str = "cylinder_flow"
    run_name: str = "run1"
    project_name: str = "SEA_Encoder_Decoder"
    use_wandb: bool = False
    test_mesh_structure: bool = False
    perform_initial_test: bool = True
    # Data layout switch (configs/cylinder_flow.py:57-58):
    # isolate -> [B,P,F,C] (permute), mixed -> [B,P,F,C] (reshape).
    sea_layout: str = "isolate"  # "isolate" | "mixed"
    spatial_batch_size: int = 1000  # frozen-encoder batching


@dataclass(frozen=True)
class CaseConfig:
    """A full experiment: data + both model stages + training recipes."""

    mesh: MeshConfig = field(default_factory=MeshConfig)
    spatial: SpatialModelConfig = field(default_factory=SpatialModelConfig)
    temporal: TemporalModelConfig = field(default_factory=TemporalModelConfig)
    spatial_split: SplitConfig = field(default_factory=SplitConfig)
    temporal_split: SplitConfig = field(
        default_factory=lambda: SplitConfig(train_fraction=0.6, val_fraction=0.2))
    spatial_train: TrainConfig = field(default_factory=TrainConfig)
    temporal_train: TrainConfig = field(
        default_factory=lambda: TrainConfig(batch_size=2, epoch_num=3000))
    run: RunConfig = field(default_factory=RunConfig)

    def __post_init__(self):
        # Consistency invariant (SURVEY §2.2): E = P * D_spatial.
        expected = self.mesh.num_patches * self.spatial.embed_dim
        if self.temporal.embed_dim != expected:
            raise ValueError(
                f"temporal.embed_dim={self.temporal.embed_dim} must equal "
                f"num_patches*spatial.embed_dim={expected}")
        if self.temporal.num_fields != len(self.spatial.field_groups):
            raise ValueError(
                "temporal.num_fields must equal len(spatial.field_groups)")

    def replace(self, **kw) -> "CaseConfig":
        return dataclasses.replace(self, **kw)
