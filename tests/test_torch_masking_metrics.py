"""PyTorch port: the node masks' rules and the metrics against the JAX
package on the same arrays (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.utils import metrics as jax_metrics
from gnn_pressure_estimation_tpu.utils.masking import batch_node_mask as jax_batch_node_mask
from gnn_pressure_estimation_tpu_torch.utils import metrics
from gnn_pressure_estimation_tpu_torch.utils.masking import (
    batch_node_mask, mask_from_uniform, masked_count,
)

torch.set_num_threads(1)
RTOL, ATOL = 2e-5, 1e-6


@pytest.mark.parametrize("n,rate,required,shared", [
    (23, 0.5, None, False), (23, 0.95, (3, 7, 22), False), (388, 0.95, (0, 1), True),
    (16, 0.1, (5,), False), (5800, 0.95, None, False),
])
def test_mask_has_exactly_k_per_graph(n, rate, required, shared):
    B, k = 4, masked_count(n, rate)
    assert k == int(n * rate)
    m = batch_node_mask(torch.Generator().manual_seed(0), B, n, rate, required, shared)
    assert m.shape == (B * n,) and m.dtype == torch.bool and m.device.type == "cpu"
    m = m.reshape(B, n)
    assert (m.sum(1) == k).all()
    if required:
        assert m[:, list(required)].all()              # always masked, counted in k
    if shared:
        assert (m == m[0]).all()
    elif k > len(required or ()):      # something is left to the draw
        assert not (m == m[0]).all()
    # the JAX mask obeys the same rules (its draws differ: another PRNG)
    jm = np.asarray(jax_batch_node_mask(jax.random.PRNGKey(0), B, n, rate, required, shared))
    assert (jm.reshape(B, n).sum(1) == k).all()
    # one seed, one mask; another seed, another mask
    again = batch_node_mask(torch.Generator().manual_seed(0), B, n, rate, required, shared)
    other = batch_node_mask(torch.Generator().manual_seed(1), B, n, rate, required, shared)
    assert torch.equal(again.reshape(B, n), m)
    assert k == len(required or ()) or not torch.equal(other.reshape(B, n), m)


def test_mask_rate_that_masks_nothing_raises():
    with pytest.raises(ValueError, match="masks 0 of 12 nodes"):
        batch_node_mask(torch.Generator().manual_seed(0), 2, 12, 0.05)
    with pytest.raises(ValueError, match="masks 0"):
        masked_count(3, 0.3)


@pytest.mark.parametrize("required", [None, (1, 9)])
def test_duplicate_draws_still_give_exactly_k(required):
    """Ties are broken by the column index packed into the low bits, so equal
    draws cannot push the count past k; among equals the lower index wins."""
    u = torch.full((3, 12), 0.25)
    u[1, 6:] = 0.75
    u[2] = torch.tensor([0.5, 0.5, 0.1, 0.1, 0.9, 0.9, 0.5, 0.5, 0.1, 0.1, 0.9, 0.9])
    for k in (1, 5, 6, 11):
        m = mask_from_uniform(u.clone(), k, required)
        assert (m.sum(1) == k).all(), k
        if required:
            assert m[:, list(required)[: min(k, 2)]].all()
    m = mask_from_uniform(u.clone(), 5, None)
    assert m[0].tolist() == [True] * 5 + [False] * 7
    assert m[2].nonzero().flatten().tolist() == [0, 2, 3, 8, 9]      # the four 0.1s, then index 0
    # the JAX tie-break picks the same nodes on the same draws
    bits = jax.lax.bitcast_convert_type(jnp.asarray(u.numpy()), jnp.int32)
    keys = ((bits >> 4) << 4) | jnp.arange(12, dtype=jnp.int32)[None, :]
    kth = -jax.lax.top_k(-keys, 5)[0][:, 4:5]
    np.testing.assert_array_equal(m.numpy(), np.asarray(keys <= kth))


def _fields(rng, n=500):
    t = (rng.standard_normal(n) * 10 + 5).astype(np.float32)       # negative truths included
    t[:7] = 0.0                                                    # |y| <= 0.01: out of rel_error
    p = (t + rng.standard_normal(n) * 2).astype(np.float32)
    assert (t < 0).sum() > 50
    return p, t


def test_metrics_match_jax(rng):
    p, t = _fields(rng)
    got = metrics.compute_all(torch.from_numpy(p), torch.from_numpy(t), "val")
    ref = jax_metrics.compute_all(jnp.asarray(p), jnp.asarray(t), "val")
    assert list(got) == list(ref) and len(got) == 7
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    # the acc quirk: the bound is the signed y*0.1, so a negative truth is a miss
    exact = torch.from_numpy(t)
    assert float(metrics.accuracy(exact, exact)) == pytest.approx(float((t >= 0).mean()))
    assert float(metrics.accuracy(exact, exact)) == pytest.approx(
        float(jax_metrics.accuracy(jnp.asarray(t), jnp.asarray(t))))
    # column shape as in the trainer: [k, 1]
    got2 = metrics.compute_all(torch.from_numpy(p)[:, None], torch.from_numpy(t)[:, None], "val")
    for k in ref:
        np.testing.assert_allclose(float(got2[k]), float(ref[k]), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("mask_dtype", ["float", "bool"])
def test_moment_metrics_match_jax(rng, mask_dtype):
    p, t = _fields(rng)
    mask = rng.random(len(p)) < 0.6
    mask[:4] = True                                                # some |y| <= 0.01 entries masked
    m_np = mask.astype(np.float32) if mask_dtype == "float" else mask
    mo = metrics.masked_moments(torch.from_numpy(p)[:, None], torch.from_numpy(t)[:, None],
                                torch.from_numpy(m_np)[:, None])
    jmo = jax_metrics.masked_moments(jnp.asarray(p)[:, None], jnp.asarray(t)[:, None],
                                     jnp.asarray(m_np)[:, None])
    assert mo.keys() == jmo.keys() and len(mo) == 11
    for k in jmo:
        np.testing.assert_allclose(float(mo[k]), float(jmo[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    got = metrics.metrics_from_moments(mo, "train")
    ref = jax_metrics.metrics_from_moments(jmo, "train")
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    # and they are the gathered formulas on the masked entries
    direct = metrics.compute_all(torch.from_numpy(p[mask]), torch.from_numpy(t[mask]), "train")
    for k in direct:
        np.testing.assert_allclose(float(got[k]), float(direct[k]), rtol=2e-4, atol=1e-5, err_msg=k)
