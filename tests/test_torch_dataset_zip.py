"""PyTorch port: ``WDNDataset`` built from zarr-zip stores against the JAX
package's on the same zip: arrays, kept names, templates and statistics,
under every removal mode and normalization, with edge attributes, record
caps, ``stacked_dataset`` and concatenation."""

import dataclasses

import numpy as np
import pytest

from gnn_pressure_estimation_tpu.data.dataset import WDNDataset as JaxWDNDataset
from gnn_pressure_estimation_tpu.data.dataset import stacked_dataset as jax_stacked
from gnn_pressure_estimation_tpu.data.inp import parse_inp as jax_parse_inp
from gnn_pressure_estimation_tpu.data.zarrzip import ZarrZipWriter as JaxWriter
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.data.dataset import REMOVALS, WDNDataset, stacked_dataset
from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

INP = "inputs/minitown.inp"


def make_zip(path, compressor, seed=0, names=None, ordered_list=None):
    """A minitown store: every node's column in canonical order, or the
    columns of ``names`` only (a generator that skipped nodes)."""
    wn = jax_parse_inp(INP)
    cols = names or wn.node_names
    rng = np.random.default_rng(seed)
    snaps = 50 + rng.normal(0, 8, size=(20, len(cols)))
    attrs = {"ordered_names_by_attr": {"pressure": list(cols)}} if names else {}
    if ordered_list is not None:
        attrs["ordered_name_list"] = ordered_list
    with JaxWriter(path, compressor=compressor) as w:
        w.create_group("pressure")
        w.write_array("pressure/train", snaps[:10], chunks=(3, -1))
        w.write_array("pressure/valid", snaps[10:14])
        w.write_array("pressure/test", snaps[14:])
        w.set_attrs("", attrs)
    return path


def assert_same(ds, jds):
    assert len(ds) == len(jds) and ds.from_set == jds.from_set
    for f in ("norm_type", "mean", "std", "min", "max"):
        assert getattr(ds.stats, f) == getattr(jds.stats, f), f
    for f in ("edge_mean", "edge_std", "edge_min", "edge_max"):
        a, b = getattr(ds.stats, f), getattr(jds.stats, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert len(ds.members) == len(jds.members)
    for m, jm in zip(ds.members, jds.members):
        assert m.array.dtype == jm.array.dtype == np.float32
        np.testing.assert_array_equal(m.array, jm.array)
        assert m.kept_names == jm.kept_names
        t, jt = m.template, jm.template
        assert t.n_node == jt.n_node and t.node_names == jt.node_names and t.name == jt.name
        np.testing.assert_array_equal(t.senders, jt.senders)
        np.testing.assert_array_equal(t.receivers, jt.receivers)
        assert (t.edge_attr is None) == (jt.edge_attr is None)
        if t.edge_attr is not None:
            np.testing.assert_array_equal(t.edge_attr, jt.edge_attr)


@pytest.mark.parametrize("compressor", [None, "zlib", "blosc"])
@pytest.mark.parametrize("norm_type", ["znorm", "minmax", "unused"])
def test_dataset_from_zip_matches_jax(tmp_path, compressor, norm_type):
    z = make_zip(str(tmp_path / "m.zip"), compressor)
    train = WDNDataset([z], [INP], from_set="train", norm_type=norm_type)
    jtrain = JaxWDNDataset([z], [INP], from_set="train", norm_type=norm_type)
    assert_same(train, jtrain)
    test = WDNDataset([z], [INP], from_set="test", stats=train.stats, norm_type=norm_type)
    jtest = JaxWDNDataset([z], [INP], from_set="test", stats=jtrain.stats, norm_type=norm_type)
    assert_same(test, jtest)
    assert test.stats.mean == train.stats.mean


@pytest.mark.parametrize("removal", REMOVALS)
@pytest.mark.parametrize("compacted", [False, True])
def test_removal_modes_match_jax(tmp_path, removal, compacted):
    """Every removal mode, on a canonical store and on one whose columns are
    a reordered subset (named in ``ordered_names_by_attr``)."""
    wn = jax_parse_inp(INP)
    names = None
    if compacted:
        names = list(reversed(wn.node_names))
        del names[4]                                   # a junction with no column
    z = make_zip(str(tmp_path / "c.zip"), "zlib", seed=1, names=names,
                 ordered_list=wn.junction_names[:9] if removal == "keep_list" else None)
    if compacted and removal == "keep_all":
        # every node is kept, and one has no column: both packages refuse
        for cls in (WDNDataset, JaxWDNDataset):
            with pytest.raises(KeyError):
                cls([z], [INP], removal=removal)
        return
    ds = WDNDataset([z], [INP], removal=removal, num_records=7)
    jds = JaxWDNDataset([z], [INP], removal=removal, num_records=7)
    assert len(ds) == 7
    assert_same(ds, jds)


@pytest.mark.parametrize("edge_attrs", [("diameter", "length"), ("valve_mask",)])
@pytest.mark.parametrize("norm_type", ["znorm", "minmax"])
def test_edge_attrs_and_edge_stats_match_jax(tmp_path, edge_attrs, norm_type):
    z = make_zip(str(tmp_path / "e.zip"), "blosc", seed=2)
    train = WDNDataset([z, z], [INP, INP], edge_attrs=edge_attrs, norm_type=norm_type)
    jtrain = JaxWDNDataset([z, z], [INP, INP], edge_attrs=edge_attrs, norm_type=norm_type)
    assert train.stats.edge_mean.shape == (len(edge_attrs),)
    assert_same(train, jtrain)
    valid = WDNDataset([z], [INP], from_set="valid", edge_attrs=edge_attrs, stats=train.stats,
                       norm_type=norm_type)
    jvalid = JaxWDNDataset([z], [INP], from_set="valid", edge_attrs=edge_attrs,
                           stats=jtrain.stats, norm_type=norm_type)
    assert_same(valid, jvalid)
    # the stats dict round-trips, the JAX package's too, edge statistics included
    d = train.stats.to_dict()
    assert d == jtrain.stats.to_dict()
    back = NormStats.from_dict(jtrain.stats.to_dict())
    for f in dataclasses.fields(NormStats):
        np.testing.assert_array_equal(getattr(back, f.name), getattr(train.stats, f.name))
    jback = JaxNormStats.from_dict(d)
    np.testing.assert_array_equal(jback.edge_std, train.stats.edge_std)


@pytest.mark.parametrize("num_tests", [None, 3, 6, 12, 100])
def test_stacked_dataset_matches_jax(tmp_path, num_tests):
    z = make_zip(str(tmp_path / "s.zip"), "blosc", seed=3)
    stats = WDNDataset([z], [INP]).stats
    jstats = JaxWDNDataset([z], [INP]).stats
    ds = stacked_dataset(z, INP, stats, num_tests=num_tests)
    jds = jax_stacked(z, INP, jstats, num_tests=num_tests)
    assert_same(ds, jds)
    assert len(ds) == min(num_tests or 20, 20)


def test_concatenation_matches_jax(tmp_path):
    z = make_zip(str(tmp_path / "a.zip"), None, seed=4)
    train = WDNDataset([z], [INP], edge_attrs=("length",))
    jtrain = JaxWDNDataset([z], [INP], edge_attrs=("length",))
    test = WDNDataset([z], [INP], from_set="test", stats=train.stats, edge_attrs=("length",))
    jtest = JaxWDNDataset([z], [INP], from_set="test", stats=jtrain.stats, edge_attrs=("length",))
    both, jboth = test + train, jtest + jtrain
    assert_same(both, jboth)
    assert both.from_set == "test+train" and both.edge_attrs == jboth.edge_attrs == ("length",)


def test_dataset_refusals(tmp_path):
    z = make_zip(str(tmp_path / "r.zip"), "zlib")
    with pytest.raises(KeyError, match="feature 'head'"):
        WDNDataset([z], [INP], feature="head")
    with pytest.raises(AssertionError, match="removal"):
        WDNDataset([z], [INP], removal="drop_all")
    with pytest.raises(AssertionError):
        WDNDataset([z, z], [INP])
    with pytest.raises(FileNotFoundError):
        WDNDataset([str(tmp_path / "missing.zip")], [INP])
