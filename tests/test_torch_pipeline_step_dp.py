"""The port's pipeline-parallel temporal train step against the JAX
package's at (data, pipe) 2x2: 4 gloo ranks, two data replicas of a
two-stage pipeline, each replica a slice of every microbatch. Setup,
JAX side and bounds: tests/test_torch_pipeline_step.py.
"""

import jax
import pytest

from test_torch_pipeline_step import check_against_jax, port_and_jax

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@requires_8
def test_data_parallel_pipeline_step_matches_jax():
    check_against_jax(*port_and_jax((2, 2))[0])
