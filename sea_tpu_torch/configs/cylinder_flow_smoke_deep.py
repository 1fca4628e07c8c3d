"""Deep-stack variant of the cylinder-flow smoke preset (4 temporal layers).

Exists so the pipeline-parallel path (--pp S, parallel/pipeline.py) can be
driven through the real CLI surface in CI: PP shards the LAYER stack over
the 'pipe' mesh axis, so it needs num_layers >= stages — the shipped
presets are 1-layer (reference configs/cylinder_flow.py:112) and train
DP/TP instead. Everything else matches cylinder_flow_smoke.
"""

import dataclasses

from sea_tpu_torch.configs import cylinder_flow_smoke as _smoke


def get_case():
    case = _smoke.get_case()
    return case.replace(
        temporal=dataclasses.replace(case.temporal, num_layers=4))


def get_config_spatial():
    return get_case()


def get_config_temporal():
    return get_case()
