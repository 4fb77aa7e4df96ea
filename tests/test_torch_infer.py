"""PyTorch port: the serving surface (``Inferencer``) against the JAX
``Inferencer`` on the CPU, on a dense and a banded template, with the same
weights and the same observed set."""

import jax
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.evaluation.infer import Inferencer as JaxInferencer
from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu.utils.scaling import descale_with as jax_descale
from gnn_pressure_estimation_tpu.utils.scaling import scale_with as jax_scale
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats, descale_with, scale_with
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax
from helpers import random_graph

torch.set_num_threads(1)
STATS = dict(norm_type="znorm", mean=50.0, std=10.0)


@pytest.fixture
def pair(rng):
    jt = random_graph(rng, n=40, extra_edges=20)
    jt.node_names = [f"J{i}" for i in range(jt.n_node)]
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers, node_names=jt.node_names)
    jm = JaxGATRes(num_blocks=1, channels=64)
    g = jt.batch(1)
    params = jm.init(jax.random.PRNGKey(0), np.zeros((g.n_node, 1), np.float32), g)
    model = GATRes(1, 64)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params), model))
    return jt, pt, jm, params, model


@pytest.mark.parametrize("agg_mode", ["dense", "banded"])
@pytest.mark.parametrize("scaled", [False, True])
def test_infer_matches_jax(rng, pair, agg_mode, scaled):
    jt, pt, jm, params, model = pair
    if agg_mode == "banded":
        jt.band_layout(block=16)
        pt.band_layout(block=16)
    jinf = JaxInferencer(jm, JaxNormStats(**STATS), agg_mode=agg_mode)
    inf = Inferencer(model, NormStats(**STATS), agg_mode=agg_mode, device="cpu")
    obs = inf.observed_indices(pt, "random", mask_rate=0.75, seed=3)
    np.testing.assert_array_equal(obs, jinf.observed_indices(jt, "random", mask_rate=0.75, seed=3))

    truth = (50 + 10 * rng.standard_normal((5, pt.n_node))).astype(np.float32)
    values = np.asarray(scale_with(truth, NormStats(**STATS)), np.float32) if scaled else truth
    # batch 2 over 5 snapshots: a ragged last batch and two cached graphs
    ref = jinf.infer(params, jt, values, obs, scaled=scaled, batch_size=2, with_truth=True)
    got = inf.infer(pt, values, obs, scaled=scaled, batch_size=2, with_truth=True)

    assert got.pred.shape == (5, pt.n_node) and np.isfinite(got.pred).all()
    np.testing.assert_array_equal(got.observed, ref.observed)
    # observed nodes are served at their readings
    np.testing.assert_allclose(got.pred[:, obs], ref.pred[:, obs], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got.pred, ref.pred, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.true, ref.true, rtol=1e-6, atol=1e-5)
    assert got.metrics.keys() == ref.metrics.keys()
    for k in ("n_hidden", "n_observed"):
        assert got.metrics[k] == ref.metrics[k]
    for k in ("hidden_mae", "hidden_rmse", "hidden_max_abs"):
        np.testing.assert_allclose(got.metrics[k], ref.metrics[k], rtol=1e-5, atol=1e-4)


def test_observed_names_and_k_width(rng, pair):
    """Explicit node names resolve as in JAX, and the k observed readings
    alone give the same field as the full snapshots."""
    jt, pt, jm, params, model = pair
    inf = Inferencer(model, NormStats(**STATS), device="cpu")
    names = ["J3", "J17", "J30"]
    obs = inf.observed_indices(pt, names)
    np.testing.assert_array_equal(obs, JaxInferencer(jm, None).observed_indices(jt, names))
    with pytest.raises(ValueError, match="unknown node names"):
        inf.observed_indices(pt, ["J3", "NOPE"])
    truth = (50 + 10 * rng.standard_normal((3, pt.n_node))).astype(np.float32)
    full = inf.infer(pt, truth, obs)
    k_only = inf.infer(pt, truth[:, obs], obs)
    np.testing.assert_array_equal(full.pred, k_only.pred)
    assert k_only.metrics == {}


@pytest.mark.parametrize("stats", [dict(norm_type="znorm", mean=50.0, std=10.0),
                                   dict(norm_type="minmax", min=20.0, max=80.0),
                                   dict(norm_type="minmax", min=5.0, max=5.0),
                                   dict(norm_type="unused")])
def test_scaling_matches_jax(rng, stats):
    x = (50 + 10 * rng.standard_normal((4, 7))).astype(np.float32)
    s = scale_with(x, NormStats(**stats))
    np.testing.assert_allclose(s, np.asarray(jax_scale(x, JaxNormStats(**stats))), rtol=1e-6)
    np.testing.assert_allclose(descale_with(s, NormStats(**stats)),
                               np.asarray(jax_descale(s, JaxNormStats(**stats))), rtol=1e-6)
    # on tensors too, as the Inferencer descales the model's output
    t = descale_with(torch.from_numpy(np.asarray(s, np.float32)), NormStats(**stats))
    np.testing.assert_allclose(t.numpy(), descale_with(s, NormStats(**stats)), rtol=1e-6)
