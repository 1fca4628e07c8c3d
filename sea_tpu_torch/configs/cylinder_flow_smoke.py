"""Tiny cylinder-flow smoke-test preset.

Same topology as cylinder_flow (2D mesh, grouped u,v + p fields, SEA
temporal block with AdaLN + mlp-ib) at a fraction of the size: 2x2
patches, E=32, 2 layers.  Exists so CI / the multi-chip dryrun can drive
the REAL CLI surface (mesh flags, both train stages, checkpointing) in
seconds on a CPU backend.  Demonstrates the config-module dispatch the
reference uses for new cases (reference main.py:23-38).
"""

from sea_tpu_torch.configs.base import (
    CaseConfig,
    MeshConfig,
    RunConfig,
    SpatialModelConfig,
    SplitConfig,
    TemporalModelConfig,
    TrainConfig,
)


def get_case() -> CaseConfig:
    mesh = MeshConfig(dimension="2D", m=3, n=3, k=None,
                      pad_id=-1, pad_field_value=0.0,
                      scale_feature_range=None)
    spatial = SpatialModelConfig(
        field_groups=((0, 1), (2,)),
        mlp_hidden=32,
        num_layers=2,
        embed_dim=8,
        n_heads=2,
        block_size=512,
        src_len=0,
        dropout=0.0,
        variational=False,
    )
    temporal = TemporalModelConfig(
        num_layers=1,
        embed_dim=32,  # 4 patches * 8
        n_heads=2,
        block_size=64,
        scale_ratio=2,
        src_len=0,
        num_fields=2,
        down_proj=2,
        dropout=0.1,
        exchange_mode="sea",
        pos_encoding_mode="learnable",
        ib_scale_mode="mlp",
        ib_addition_mode="add",
        ib_mlp_layers=1,
        ib_num=1,
        add_info_after_cross=True,
        ln_type="adaln",
    )
    return CaseConfig(
        mesh=mesh,
        spatial=spatial,
        temporal=temporal,
        spatial_split=SplitConfig(train_fraction=0.8, val_fraction=0.1,
                                  random_seed=42),
        temporal_split=SplitConfig(train_fraction=0.6, val_fraction=0.2,
                                   random_seed=42),
        spatial_train=TrainConfig(batch_size=32, learning_rate=1e-4,
                                  epoch_num=1, validation_interval=1),
        temporal_train=TrainConfig(batch_size=2, learning_rate=1e-4,
                                   epoch_num=1, validation_interval=1,
                                   full_eval_interval=100,
                                   dataset_src_len=40, dataset_overlap=0),
        run=RunConfig(case_name="cylinder_flow",
                      field_data_path="./data/CF/all_data/field_data.npy",
                      input_path="./data/CF/all_data/input_data.npy",
                      coordinates_path="./data/CF/all_data/coordinates.npy"),
    )


def get_config_spatial() -> CaseConfig:
    return get_case()


def get_config_temporal() -> CaseConfig:
    return get_case()
