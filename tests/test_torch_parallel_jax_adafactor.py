"""The port's sharded Adafactor step against the JAX package's, on 1x2
at E=128, where the MLP's leaves are factored and split over the model
ranks: loss within 1e-5, norms rtol 1e-4, the statistics v_row, v_col
and v rtol 1e-3 plus 1e-7 of the squared gradient norm, a parameter
within 1e-5, or 1e-5 + 2 lr where an unfactored leaf's gradient is
within 1e-6 of the gradient norm of 0 (its first update is g / |g|).
Its own file, so that it runs beside the other recipes
(tests/test_torch_parallel_jax_recipes.py) rather than after them.
"""

import numpy as np
import pytest

from test_torch_parallel_jax_recipes import (FWD_ATOL, NORM_RTOL,
                                             PARAM_ATOL, _paths, _temporal,
                                             requires_8, run_cells)


@pytest.fixture(scope="module")
def runs():
    return run_cells(("adafactor",))


@requires_8
def test_adafactor_step_matches_jax(runs):
    (pstats, pp, po), (jstats, jp, jo) = runs["adafactor"]
    lr = _temporal(128)[0].temporal_train.learning_rate
    np.testing.assert_allclose(pstats[0]["loss"], jstats["loss"], rtol=0,
                               atol=FWD_ATOL)
    for k in ("grad_norm", "param_norm"):
        np.testing.assert_allclose(pstats[0][k], jstats[k], rtol=NORM_RTOL,
                                   err_msg=k)
    g2 = jstats["grad_norm"] ** 2
    got, want = _paths(pp, po), _paths(jp, jo)
    assert sorted(got) == sorted(want)
    for key in (k for k in want if k.startswith("o/0/")):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                   atol=1e-7 * g2, err_msg=key)
    gscale = jstats["grad_norm"]
    for key in (k[2:] for k in want if k.startswith("p/")):
        v = want[f"o/0/3/{key}"]
        tol = np.full(want["p/" + key].shape, PARAM_ATOL)
        if v.shape == want["p/" + key].shape:  # unfactored: u = g / |g|
            near0 = np.sqrt(np.maximum(v - 1e-30, 0)) < 1e-6 * gscale
            tol = np.where(near0, PARAM_ATOL + 2 * lr, PARAM_ATOL)
        diff = np.abs(got["p/" + key] - want["p/" + key])
        assert (diff <= tol).all(), (key, diff.max())
