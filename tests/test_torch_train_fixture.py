"""PyTorch port: one train step of GATRes-large on bigtown (banded, plain
band ops on the CPU) against ``artifacts/parity_train_bigtown.npz``, which
``tools/parity_train_export.py`` wrote from the JAX ``Trainer`` (Pallas band
kernels in interpret mode, forward and backward)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def test_fixture_is_self_consistent():
    fx = np.load(ROOT / "artifacts" / "parity_train_bigtown.npz")
    n = 5800
    assert fx["mask"].shape == (n,) and int(fx["mask"].sum()) == int(fx["n_masked"]) == int(n * 0.95)
    assert bytes(fx["path"]) in (b"pallas", b"xla")
    model = GATRes(25, 128)
    grads = {k[5:] for k in fx.files if k.startswith("grad_")}
    assert grads == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert fx[f"grad_{k}"].shape == tuple(v.shape) and fx[f"grad_{k}"].dtype == np.float32
    kept = {k[3:] for k in fx.files if k.startswith("p3_")}
    assert kept == {k for k in model.state_dict()
                    if k.startswith(("lin0.", "lin1.", "blocks.0.", "blocks.24."))}
    assert len([k for k in fx.files if k.startswith("metric_train_")]) == 7
    assert fx["step_losses"].shape == (3,) and fx["step_losses"][0] == fx["loss"]
    assert np.isfinite(fx["loss_after"])


@pytest.mark.slow
def test_train_step_matches_bigtown_fixture():
    """Loss rtol 1e-4; each gradient max|Δ| ≤ 1e-3·max|g_ref| + 1e-6; the
    parameters after 3 Adam steps atol 3e-4: a step moves a parameter by up to
    lr = 5e-4 whatever its gradient's size, so a component with a small
    gradient carries its relative error into the step (seen: 1.5e-4 on one of
    256 biases). About two minutes on one core."""
    fx = np.load(ROOT / "artifacts" / "parity_train_bigtown.npz")
    wn = parse_inp(str(ROOT / "inputs" / "bigtown.inp"))
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
    weights = ROOT / "artifacts" / "parity_r5_trained.npz"
    model = GATRes(25, 128)
    model.load_state_dict(params_from_parity_npz(weights))
    stats = NormStats("znorm", float(fx["stats_mean"]), float(fx["stats_std"]))
    tr = Trainer(model, TrainConfig(batch_size=1), stats, tpl, device="cpu")
    xb = np.load(weights)["x"][:, 0][None, :]
    graph, x, mask, k = tr._prepare(tpl, xb, fx["mask"], None, None)
    loss, mets, _ = tr._masked_loss_and_metrics(graph, x, x, mask, k, "train")
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(fx["loss"]), rtol=1e-4)
    for name, v in mets.items():
        np.testing.assert_allclose(float(v), float(fx[f"metric_{name}"]), rtol=1e-3, atol=1e-4,
                                   err_msg=name)
    for (name, _), g in zip(model.named_parameters(), grads):
        ref = fx[f"grad_{name}"]
        assert float(np.abs(g.numpy() - ref).max()) <= 1e-3 * float(np.abs(ref).max()) + 1e-6, name
    losses = [float(tr.train_step(tpl, xb, mask=fx["mask"])[0]) for _ in range(3)]
    np.testing.assert_allclose(losses, fx["step_losses"], rtol=1e-3)
    for name, p in model.named_parameters():
        if f"p3_{name}" in fx.files:
            np.testing.assert_allclose(p.detach().numpy(), fx[f"p3_{name}"], rtol=0, atol=3e-4,
                                       err_msg=name)
