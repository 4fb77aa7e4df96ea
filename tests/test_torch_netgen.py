"""PyTorch port: the synthetic network generator and the INP writer against
the JAX package's (numpy on both sides): the same seed gives the same
network, the same INP text and the same graph template."""

import dataclasses

import numpy as np
import pytest

from gnn_pressure_estimation_tpu.data.dataset import build_template as jax_build_template
from gnn_pressure_estimation_tpu.data.dataset import get_keep_list as jax_keep_list
from gnn_pressure_estimation_tpu.data.inp import write_inp as jax_write_inp
from gnn_pressure_estimation_tpu.simgen import netgen as jax_netgen
from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp, write_inp
from gnn_pressure_estimation_tpu_torch.ops.banded import band_attention_route
from gnn_pressure_estimation_tpu_torch.simgen import netgen

MAKERS = ("make_minitown", "make_ctown_like", "make_large", "make_mega")


def _templates(jwn, wn):
    jt, _ = jax_build_template(jwn, jax_keep_list(jwn, "keep_junction", None, "pressure"), None)
    pt, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
    return jt, pt


def _same_network(jwn, wn):
    for part in ("junctions", "reservoirs", "tanks", "pipes", "pumps", "valves"):
        a, b = getattr(jwn, part), getattr(wn, part)
        assert len(a) == len(b), part
        assert [dataclasses.asdict(v) for v in a] == [dataclasses.asdict(v) for v in b], part
    assert jwn.curves == wn.curves and jwn.coordinates == wn.coordinates and jwn.title == wn.title


@pytest.mark.parametrize("maker", ["make_minitown", "make_ctown_like"])
def test_generated_network_matches_jax(maker):
    jwn, wn = getattr(jax_netgen, maker)(), getattr(netgen, maker)()
    _same_network(jwn, wn)
    jt, pt = _templates(jwn, wn)
    assert pt.n_node == jt.n_node == len(wn.junctions)
    np.testing.assert_array_equal(pt.senders, jt.senders)
    np.testing.assert_array_equal(pt.receivers, jt.receivers)
    assert pt.node_names == jt.node_names


@pytest.mark.parametrize("maker", ["make_minitown", "make_ctown_like"])
def test_write_inp_matches_jax_and_round_trips(maker, tmp_path):
    wn = getattr(netgen, maker)()
    text = write_inp(wn, str(tmp_path / "net.inp"))
    assert text == jax_write_inp(getattr(jax_netgen, maker)())
    assert (tmp_path / "net.inp").read_text() == text
    back = parse_inp(str(tmp_path / "net.inp"))
    assert [j.id for j in back.junctions] == [j.id for j in wn.junctions]
    assert [(p.node1, p.node2) for p in back.pipes] == [(p.node1, p.node2) for p in wn.pipes]
    assert len(back.pumps) == len(wn.pumps) and len(back.valves) == len(wn.valves)
    _, a = _templates(getattr(jax_netgen, maker)(), wn)
    _, b = _templates(getattr(jax_netgen, maker)(), back)
    np.testing.assert_array_equal(a.senders, b.senders)
    np.testing.assert_array_equal(a.receivers, b.receivers)
    # the text parses as a path's content would
    assert len(parse_inp(text).junctions) == len(wn.junctions)


def test_seed_and_size_are_honoured():
    a, b, c = netgen.make_wdn(40, seed=3), netgen.make_wdn(40, seed=3), netgen.make_wdn(40, seed=4)
    assert write_inp(a) == write_inp(b) != write_inp(c)
    wn = netgen.make_wdn(61, 2, 3, 4, 2, seed=1)
    assert (len(wn.junctions), len(wn.reservoirs), len(wn.tanks), len(wn.pumps), len(wn.valves)) \
        == (61, 2, 3, 4, 2)
    assert all(hasattr(netgen, m) for m in MAKERS)


def test_meganet_matches_jax_and_routes_to_flash():
    """The 23,000-junction network: the same edges through either package,
    the layout the records name (BLK 256: nB 90, W 1920), and the route the
    JAX package takes there (v2 refuses the layout)."""
    jwn, wn = jax_netgen.make_mega(), netgen.make_mega()
    assert len(wn.junctions) == 23000 and len(wn.pipes) == len(jwn.pipes)
    assert [(p.node1, p.node2) for p in wn.pipes] == [(p.node1, p.node2) for p in jwn.pipes]
    jt, pt = _templates(jwn, wn)
    assert pt.n_node == 23000 and pt.n_edge == jt.n_edge == 82914
    np.testing.assert_array_equal(pt.senders, jt.senders)
    np.testing.assert_array_equal(pt.receivers, jt.receivers)
    bl = pt.band_layout()
    assert bl.adj_mask.shape == (90, 256, 1920) and bl.n_pad == 23040
    assert int(bl.adj_mask.sum()) == 82914 + 23000 and int(bl.adj_cnt.max()) == 1
    assert band_attention_route(bl.BLK, bl.W) == "flash"
    assert pt.batch(1, device="cpu").band_attn == "flash"
