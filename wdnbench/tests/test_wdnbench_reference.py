"""The plain reference against the program on the CPU: a GATRes forward and a
training step at a small size, the same weights and inputs handed to both.
(The test imports both; the reference imports nothing of the program.)"""

import numpy as np
import pytest
import torch

from wdnbench import check, inputs, network, reference

BLOCKS, C = 2, 16


@pytest.fixture(scope="module")
def net():
    from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
    from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp, write_inp
    from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_wdn

    text = write_inp(make_wdn(1100, seed=5, name="ref"))
    wn = parse_inp(text)
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
    names, s, r = network.junction_graph(text)
    return tpl, reference.Graph(len(names), s, r, "cpu"), names


def program_model(seed):
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes

    model = GATRes(BLOCKS, C, attn_impl="factored")
    w = inputs.make_weights(inputs.param_shapes(BLOCKS, C, 2, 1), seed, "cpu")
    model.load_state_dict(w, strict=True)
    return model, w


def test_the_reference_reads_the_programs_graph(net):
    tpl, g, names = net
    assert names == list(tpl.node_names)
    ours = set(zip(g.src.tolist(), g.dst.tolist()))
    assert ours == set(zip(tpl.senders.tolist(), tpl.receivers.tolist()))
    assert len(ours) == tpl.n_edge == g.src.numel()


@pytest.mark.parametrize("mode", ["banded", "dense"])
def test_forward_matches_the_program(net, mode):
    tpl, g, _ = net
    model, w = program_model(11)
    B, n = 3, tpl.n_node
    x = torch.as_tensor(inputs.snapshot_pool(11, B, n))
    graph = tpl.batch(B, mode=mode, device="cpu")
    xin = x.reshape(-1, 1)
    if graph.banded:
        xin = graph.pack_nodes(xin, n)
    with torch.no_grad():
        out = model(xin, graph)
    if graph.banded:
        out = graph.unpack_nodes(out, n)
        assert graph.band_attn == "dma"
    got = out.reshape(B, n)
    with torch.no_grad():
        ref = reference.forward(w, x, g, BLOCKS, 2, 1)
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


def test_a_training_step_matches_the_program(net):
    from gnn_pressure_estimation_tpu_torch.train.loop import Trainer, TrainConfig
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

    tpl, g, _ = net
    model, w = program_model(12)
    B, n = 2, tpl.n_node
    hidden = int(n * 0.95)
    pool = inputs.snapshot_pool(12, 2 * B, n)
    masks = inputs.mask_pool(12, 2, B, n, hidden)
    tr = Trainer(model, TrainConfig(batch_size=B), NormStats(), tpl, device="cpu")
    losses = [float(tr.train_step(tpl, pool[j * B:(j + 1) * B], mask=masks[j])[0])
              for j in range(2)]
    opt = {"lr": 5e-4, "weight_decay": 6e-6, "betas": (0.9, 0.999), "eps": 1e-8}
    batches = [(torch.as_tensor(pool[j * B:(j + 1) * B]),
                torch.as_tensor(masks[j].reshape(B, n))) for j in range(2)]
    ref = reference.train(w, batches, hidden, g, {"blocks": BLOCKS, "heads1": 2, "heads2": 1},
                          opt, rows=1)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    moved = {k: p.detach() - w[k] for k, p in model.named_parameters()}
    gaps = check.leaf_gaps(moved, {k: ref["params"][k] - w[k] for k in w},
                           check.moving_leaves(ref["grad1"]))
    assert max(gaps.values()) < 1e-4
    assert inputs.mask_pool(12, 2, B, n, hidden).reshape(-1, n).sum(1).tolist() == [hidden] * 4
