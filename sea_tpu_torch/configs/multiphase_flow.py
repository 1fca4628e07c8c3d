"""Multiphase-flow case preset.

Mirror of reference configs/multiphase_flow.py: spatial embed 32 / MLP hidden
624 (:26-28), temporal E=2048=64*32 (:113), dropout 0.0 (:120), plain LN
instead of AdaLN (:128), batch 4, 199-step windows (:140-141), lr 8e-5 (:147).
Fields are (u, v) grouped and alpha (phase fraction) alone.

The reference's stale data paths still pointing at ./data/CF (:7-9) and the
temporal case_name left as 'cylinder_flow' (:155) are quirks we fix: paths and
names here refer to the multiphase case.
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
        mlp_hidden=624,
        num_layers=12,
        embed_dim=32,
        n_heads=8,
        block_size=2024,
        src_len=0,
        dropout=0.0,
        variational=False,
    )
    temporal = TemporalModelConfig(
        num_layers=1,
        embed_dim=2048,  # 64 patches * 32
        n_heads=8,
        block_size=2024,
        scale_ratio=8,
        src_len=0,
        num_fields=2,
        down_proj=2,
        dropout=0.0,
        exchange_mode="sea",
        pos_encoding_mode="learnable",
        ib_scale_mode="mlp",
        ib_addition_mode="add",
        ib_mlp_layers=1,
        ib_num=1,
        add_info_after_cross=True,
        # Stacked per-field execution measured HARMFUL here (21.8 ->
        # 28.4 ms/step, +30%): at E=2048 the per-field GEMMs already
        # saturate the MXU and the trace-time weight stacking only adds
        # copy traffic. Cylinder (E=1024) keeps it ON at a measured -16%
        # (BASELINE.md round-4 stack A/B rows).
        stack_fields=False,
        ln_type="ln",
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
        temporal_train=TrainConfig(batch_size=4, learning_rate=8e-5,
                                   epoch_num=3000, validation_interval=10,
                                   full_eval_interval=100,
                                   dataset_src_len=199, dataset_overlap=0),
        run=RunConfig(case_name="multiphase_flow",
                      field_data_path="./data/MP/all_data/field_data.npy",
                      input_path="./data/MP/all_data/input_data.npy",
                      coordinates_path="./data/MP/all_data/coordinates.npy"),
    )


def get_config_spatial() -> CaseConfig:
    return get_case()


def get_config_temporal() -> CaseConfig:
    return get_case()
