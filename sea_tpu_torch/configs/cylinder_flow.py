"""Cylinder-flow case preset.

Value-for-value mirror of the reference configs/cylinder_flow.py:2-162:
fields u,v grouped together and p alone (field_groups=[[0,1],[2]], :17);
9x9 partition grid -> 64 patches (:20-22); spatial model 12 layers, embed 16,
8 heads, MLP hidden 480 (:26-33); temporal model 1 layer, E=1024=64*16,
scale_ratio 8, down_proj 2, AdaLN + mlp-ib (:111-128); spatial batch 128 /
temporal batch 2, 399-step windows (:41,140-143).

The reference's hard-coded wandb API key (multiphase_flow.py:52) is
deliberately NOT reproduced.
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
    mesh = MeshConfig(dimension="2D", m=9, n=9, k=None,
                      pad_id=-1, pad_field_value=0.0,
                      scale_feature_range=None)
    spatial = SpatialModelConfig(
        field_groups=((0, 1), (2,)),
        mlp_hidden=480,
        num_layers=12,
        embed_dim=16,
        n_heads=8,
        block_size=2024,
        src_len=0,
        dropout=0.0,
        variational=False,
    )
    temporal = TemporalModelConfig(
        num_layers=1,
        embed_dim=1024,  # 64 patches * 16
        n_heads=8,
        block_size=2024,
        scale_ratio=8,
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
        # Batch the per-field LN/projection/MLP applications into vmapped
        # einsums over G — measured -16% step time on this recipe at
        # identical numerics (20.36 vs 24.20 ms with ib_time_constant;
        # BASELINE.md round-4 stack A/B). Per-case: multiphase (E=2048)
        # measured it HARMFUL and ships False. Single-device paths only
        # (sharded steps keep per-field params for the TP specs).
        stack_fields=True,
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
        spatial_train=TrainConfig(batch_size=128, learning_rate=1e-4,
                                  epoch_num=5000, validation_interval=10),
        temporal_train=TrainConfig(batch_size=2, learning_rate=1e-4,
                                   epoch_num=3000, validation_interval=10,
                                   full_eval_interval=100,
                                   dataset_src_len=399, dataset_overlap=0),
        run=RunConfig(case_name="cylinder_flow",
                      field_data_path="./data/CF/all_data/field_data.npy",
                      input_path="./data/CF/all_data/input_data.npy",
                      coordinates_path="./data/CF/all_data/coordinates.npy"),
    )


# Reference API parity: get_config_spatial / get_config_temporal entry points
# (configs/cylinder_flow.py:2,73) map onto the single CaseConfig here.
def get_config_spatial() -> CaseConfig:
    return get_case()


def get_config_temporal() -> CaseConfig:
    return get_case()
