"""PyTorch port: the parallel strategies (``parallel/``) against the JAX package.

The port runs one rank per process: gloo ranks on the CPU, started through
``parallel.launch`` (at most 4, one torch thread each) and driven by
``tests/torch_rank_jobs.py``, so no rank imports this module (or JAX). The
JAX side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py``.
Both sides start from the same weights (the JAX initialisation carried over
by ``weights.params_from_flax``) and see the same masks: the JAX step draws
its mask from a PRNG key, the same draw is made here and handed to the port
(the two packages' PRNGs differ). All jobs of one world size run in one
launch, started in the background while the JAX side compiles.

Held against JAX, at the JAX package's own tolerances (loss rtol 1e-5,
parameters after the step atol 2e-5, the train metric rtol 1e-4):
``partition_graph``'s arrays (equal); ``halo_exchange`` forward and gradient
(against ``jax.vjp`` of the ``shard_map``) on 2 and 4 ranks, with and
without right context; ``MeshTrainer``'s graphs strategy at 2×1, 1×2 and
2×2 and its halo strategy at 1×2, 2×2 and 1×4 on ``tests/test_parallel.py``'s
chain template (``DENSE_THRESHOLD`` 32), each against the JAX
``MeshTrainer`` of that mesh, and the halo eval step's output; a tail batch
the data group does not divide; each band-attention route at H·C 128
against the single-device JAX XLA band step (as
``test_meshtrainer_halo_band_kernel_matches_xla``); GIN and ChebNet on a 1×2
halo mesh; ``DistributedTrainer`` (the edge partition, ``ops.segment`` with
the all-gather) at 2×1, 1×2 and 2×2. Port-only: every rank ends every job
with bit-identical parameters (and Adam state), and ``fit`` with a resume
ends bit-identical to an uninterrupted ``fit`` on every rank.
"""

import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu.core.graph import GraphTemplate as JaxGraphTemplate
from gnn_pressure_estimation_tpu.models.gatres import GATRes as JaxGATRes
from gnn_pressure_estimation_tpu.models.zoo import GIN as JaxGIN
from gnn_pressure_estimation_tpu.models.zoo import ChebNet as JaxChebNet
from gnn_pressure_estimation_tpu.parallel import MeshTrainer as JaxMeshTrainer
from gnn_pressure_estimation_tpu.parallel import make_mesh as jax_make_mesh
from gnn_pressure_estimation_tpu.parallel import partition_graph as jax_partition_graph
from gnn_pressure_estimation_tpu.parallel.distributed import DistributedTrainer as JaxDT
from gnn_pressure_estimation_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_pressure_estimation_tpu.train.loop import Trainer as JaxTrainer
from gnn_pressure_estimation_tpu.utils.masking import batch_node_mask as jax_mask
from gnn_pressure_estimation_tpu.utils.scaling import NormStats as JaxNormStats
from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.zoo import GIN, ChebNet
from gnn_pressure_estimation_tpu_torch.parallel import partition_graph
from gnn_pressure_estimation_tpu_torch.weights import params_from_flax
from helpers import random_graph
from torch_rank_jobs import spawn_jobs

torch.set_num_threads(1)
LOSS_RTOL, PARAM_ATOL, MET_RTOL = 1e-5, 2e-5, 1e-4
PORT_MODELS = {"gatres": GATRes, "gin": GIN, "chebnet": ChebNet}
JAX_MODELS = {"gatres": JaxGATRes, "gin": JaxGIN, "chebnet": JaxChebNet}
GRAPHS_MESHES = [(2, 1), (1, 2), (2, 2)]
HALO_MESHES = [(1, 2), (2, 2), (1, 4)]
ROUTES = ["dma", "flash", "acc", "window"]
DIST_MESHES = [(2, 1), (1, 2), (2, 2)]
HALO_SHAPES = [(2, 2, 3), (2, 3, 0), (4, 2, 3), (4, 3, 0)]      # gp, U, R


def chain_template(rng, n=64):
    """``tests/test_parallel.py``'s banded chain (i~i±1, some i~i±2), band
    layout BLK 8, lane 8."""
    s, r = [], []
    for i in range(n - 1):
        s += [i, i + 1]
        r += [i + 1, i]
    for i in range(n - 2):
        if rng.random() < 0.5:
            s += [i, i + 2]
            r += [i + 2, i]
    tpl = JaxGraphTemplate(n, np.array(s), np.array(r))
    tpl.band_layout(block=8, lane=8)
    return tpl


def tdict(jt, band=None) -> dict:
    return dict(n=jt.n_node, senders=np.asarray(jt.senders), receivers=np.asarray(jt.receivers),
                band=band)


def port_state(name, kwargs, jparams) -> dict:
    m = PORT_MODELS[name](**kwargs)
    return {k: v.numpy() for k, v in
            params_from_flax(jax.tree.map(np.asarray, jparams), m).items()}


class Threshold:
    """``DENSE_THRESHOLD`` 32 on the JAX template (pushes the 64-node chain
    onto the halo strategy); the port's ranks get the same in their jobs."""

    def __enter__(self):
        self.old, JaxGraphTemplate.DENSE_THRESHOLD = JaxGraphTemplate.DENSE_THRESHOLD, 32

    def __exit__(self, *exc):
        JaxGraphTemplate.DENSE_THRESHOLD = self.old


class Launch:
    """``jobs`` on ``n`` gloo CPU ranks, started in a background thread."""

    def __init__(self, n, jobs, out_dir):
        self.n, self.out = n, str(out_dir)
        spec = os.path.join(self.out, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump({"jobs": jobs, "out": self.out}, f)
        self.code = None
        self.thread = threading.Thread(target=self._run, args=(spec,), daemon=True)
        self.thread.start()

    def _run(self, spec):
        self.code = spawn_jobs(self.n, spec, device="cpu", threads=1, timeout_s=400)

    def results(self):
        self.thread.join()
        assert self.code == 0, f"a rank failed (exit {self.code})"
        return [pickle.load(open(os.path.join(self.out, f"rank{r}.pkl"), "rb"))["results"]
                for r in range(self.n)]


# ---- the inputs, the port's jobs, and the JAX side's trainers ------------------------------
# The weights depend only on the model, its arguments and the seed (one input
# channel): the JAX initialisation is made once for each and carried to both
# sides, so the launches start before any JAX trainer is built.

_INITS: dict = {}


def jax_init(name, mkw, seed):
    key = (name, tuple(sorted(mkw.items())), seed)
    if key not in _INITS:
        g = random_graph(np.random.default_rng(0), n=6, extra_edges=2).batch(1, mode="dense")
        _INITS[key] = JAX_MODELS[name](**mkw).init(jax.random.PRNGKey(seed),
                                                   jnp.zeros((6, 1), jnp.float32), g)
    return _INITS[key]


def _graphs_case(dp, gp):
    rng = np.random.default_rng(100 + 10 * dp + gp)
    jt = random_graph(rng, n=20, extra_edges=10)
    kw = dict(batch_size=8, mask_rate=0.5, criterion="mse", seed=3)
    mkw = dict(num_blocks=2, channels=8)
    x = rng.standard_normal((8, 20)).astype(np.float32)
    key = jax.random.PRNGKey(5 + dp + 3 * gp)
    params = jax_init("gatres", mkw, 3)
    job = dict(kind="mesh_step", dp=dp, gp=gp, template=tdict(jt),
               model=("gatres", mkw, port_state("gatres", mkw, params)), cfg=kw, stats={}, x=x,
               masks=[np.asarray(jax_mask(key, 8, 20, 0.5))])
    return dict(jt=jt, x=x, key=key, kw=kw, mkw=mkw, params=params), job


def _halo_case(dp, gp, model="gatres", mkw=None, bs=4, seed=0):
    mkw = mkw or dict(num_blocks=2, channels=8)
    rng = np.random.default_rng(200 + 10 * dp + gp + seed)
    jt = chain_template(rng)
    kw = dict(batch_size=4, mask_rate=0.5, criterion="mse", seed=3)
    x = rng.standard_normal((bs, 64)).astype(np.float32)
    key = jax.random.PRNGKey(9 + seed)
    mask = np.asarray(jax_mask(key, bs, 64, 0.5))
    params = jax_init(model, mkw, 3)
    job = dict(kind="mesh_step", dp=dp, gp=gp, dense_threshold=32, template=tdict(jt, (8, 8)),
               model=(model, mkw, port_state(model, mkw, params)), cfg=kw, stats={}, x=x,
               masks=[mask], eval_mask=mask)
    return dict(jt=jt, x=x, key=key, kw=kw, mkw=mkw, params=params, model=model), job


def _route_case(route):
    """GATRes(1, 128) on the chain at batch 2; the JAX reference is the
    single-device XLA band step (its band kernels switched off)."""
    kw = dict(batch_size=2, mask_rate=0.5, criterion="mse", seed=3)
    mkw = dict(num_blocks=1, channels=128)
    x = np.random.default_rng(7).standard_normal((2, 64)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    params = jax_init("gatres", mkw, 3)
    job = dict(kind="mesh_step", dp=2, gp=2, dense_threshold=32,
               template=tdict(chain_template(np.random.default_rng(42)), (8, 8)),
               model=("gatres", mkw, port_state("gatres", mkw, params)),
               cfg=dict(kw, band_attn=route), stats={}, x=x,
               masks=[np.asarray(jax_mask(key, 2, 64, 0.5))])
    return dict(x=x, key=key, kw=kw, mkw=mkw, params=params), job


def _dist_case(dp, gp):
    rng = np.random.default_rng(300 + 10 * dp + gp)
    jt = random_graph(rng, n=24, extra_edges=12)
    kw = dict(batch_size=8, mask_rate=0.5, criterion="mse", lr=1e-3, weight_decay=0.0, seed=0)
    stats = dict(norm_type="znorm", mean=2.0, std=1.5)
    mkw = dict(num_blocks=2, channels=8)
    x = rng.standard_normal((8, 24)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    params = jax_init("gatres", mkw, 0)
    job = dict(kind="dist_step", dp=dp, gp=gp, template=tdict(jt),
               model=("gatres", mkw, port_state("gatres", mkw, params)), cfg=kw, stats=stats,
               x=x, masks=[np.asarray(jax_mask(key, 8, 24, 0.5))])
    return dict(jt=jt, x=x, key=key, kw=kw, mkw=mkw, params=params, stats=stats), job


def jax_mesh_trainer(ref, dp, gp):
    """The JAX ``MeshTrainer`` of a case (its weights are the case's)."""
    model = JAX_MODELS[ref.get("model", "gatres")](**ref["mkw"])
    mt = JaxMeshTrainer(model, JaxTrainConfig(donate_state=False, **ref["kw"]), JaxNormStats(),
                        ref["jt"], jax_make_mesh(dp=dp, gp=gp))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(mt.params),
                                                     jax.tree.leaves(ref["params"])))
    return mt


def _fit_job(tmp):
    rng = np.random.default_rng(11)
    jt = chain_template(rng)
    m = GATRes(1, 8)
    return dict(kind="fit_resume", dp=1, gp=2, dense_threshold=32, template=tdict(jt, (8, 8)),
                model=("gatres", dict(num_blocks=1, channels=8),
                       {k: v.numpy() for k, v in m.state_dict().items()}),
                cfg=dict(epochs=3, batch_size=4, mask_rate=0.5, criterion="mse", seed=0,
                         use_gradient_clipping=True, scheduler="ReduceLROnPlateau",
                         patience=100),
                stats={}, train=rng.standard_normal((10, 64)), val=rng.standard_normal((6, 64)),
                dir=str(tmp))


def _halo_exchange_jobs():
    jobs = []
    for gp, U, R in HALO_SHAPES:
        rng = np.random.default_rng(gp * 10 + U + R)
        x = rng.standard_normal((4 // gp, gp, 2, 6, 5)).astype(np.float32)
        cot = rng.standard_normal((4 // gp, gp, 2, U + 6 + R, 5)).astype(np.float32)
        jobs.append(dict(kind="halo_exchange", dp=4 // gp, gp=gp, U=U, R=R, x=x, cot=cot))
    return jobs


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Every case's inputs and port job; both launches started."""
    graphs = {m: _graphs_case(*m) for m in GRAPHS_MESHES}
    halo = {m: _halo_case(*m) for m in HALO_MESHES}
    tail = _halo_case(2, 2, bs=5, seed=1)
    zoo = {"gin": _halo_case(1, 2, "gin", dict(num_blocks=2, channels=8), seed=2),
           "chebnet": _halo_case(1, 2, "chebnet", dict(channels=8, ks=(4, 3, 2, 1)), seed=3)}
    routes = {r: _route_case(r) for r in ROUTES}
    dist = {m: _dist_case(*m) for m in DIST_MESHES}
    halo_ex = _halo_exchange_jobs()
    # one launch a world size: its jobs in a fixed order, each rank runs them all
    order2 = ([("graphs", m) for m in GRAPHS_MESHES if m[0] * m[1] == 2]
              + [("halo", m) for m in HALO_MESHES if m[0] * m[1] == 2]
              + [("zoo", k) for k in zoo] + [("dist", m) for m in DIST_MESHES if m[0] * m[1] == 2]
              + [("fit", None)])
    order4 = ([("graphs", (2, 2)), ("halo", (2, 2)), ("halo", (1, 4)), ("tail", None)]
              + [("route", r) for r in ROUTES] + [("dist", (2, 2))]
              + [("halo_ex", i) for i in range(len(halo_ex))])
    table = {"graphs": graphs, "halo": halo, "zoo": zoo, "dist": dist, "route": routes,
             "tail": {None: tail}}

    def job_of(kind, key):
        if kind == "fit":
            return _fit_job(tmp_path_factory.mktemp("fit"))
        if kind == "halo_ex":
            return halo_ex[key]
        return table[kind][key][1]
    launches = {2: Launch(2, [job_of(k, m) for k, m in order2], tmp_path_factory.mktemp("w2")),
                4: Launch(4, [job_of(k, m) for k, m in order4], tmp_path_factory.mktemp("w4"))}

    def port(kind, key=None):
        """Every rank's result of the job, from the launch that ran it."""
        for world, order in ((2, order2), (4, order4)):
            if (kind, key) in order:
                res = launches[world].results()
                i = order.index((kind, key))
                return [r[i] for r in res]
        raise KeyError((kind, key))
    return dict(table=table, halo_ex=halo_ex, port=port)


# ---- helpers ---------------------------------------------------------------------------

def assert_ranks_identical(ranks, what=("state", "opt")):
    for part in what:
        for r in ranks[1:]:
            assert r[part].keys() == ranks[0][part].keys()
            for k in ranks[0][part]:
                np.testing.assert_array_equal(r[part][k], ranks[0][part][k], err_msg=f"{part} {k}")


def assert_params_close(name, mkw, jparams, state):
    ref = port_state(name, mkw, jparams)
    assert ref.keys() == state.keys()
    for k in ref:
        np.testing.assert_allclose(state[k], ref[k], rtol=0, atol=PARAM_ATOL, err_msg=k)


# ---- partition and exchange ----------------------------------------------------------------

@pytest.mark.parametrize("B,gp,n,extra,edge_dim", [(3, 4, 20, 10, None), (2, 2, 17, 9, 2),
                                                  (4, 3, 12, 5, 1)])
def test_partition_graph_matches_jax(B, gp, n, extra, edge_dim):
    jt = random_graph(np.random.default_rng(n), n=n, extra_edges=extra, edge_dim=edge_dim)
    pt = GraphTemplate(jt.n_node, jt.senders, jt.receivers, edge_attr=jt.edge_attr)
    a, b = jax_partition_graph(jt, B, gp), partition_graph(pt, B, gp)
    for f in ("n_parts", "n_node_global", "block", "n_graph", "nodes_per_graph"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("senders", "receivers", "edge_mask", "senders_sl", "receivers_sl", "edge_mask_sl",
              "inv_degree", "gcn_norm", "cheb_norm", "edge_attr", "node_graph_id"):
        ja, pa = getattr(a, f), getattr(b, f)
        assert (ja is None) == (pa is None), f
        if ja is not None:
            np.testing.assert_array_equal(pa, np.asarray(ja), err_msg=f)


@pytest.mark.parametrize("i", range(len(HALO_SHAPES)),
                         ids=[f"gp{g}-U{u}-R{r}" for g, u, r in HALO_SHAPES])
def test_halo_exchange_matches_jax_vjp(cases, i):
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from gnn_pressure_estimation_tpu.parallel import halo_exchange as jax_halo

    job = cases["halo_ex"][i]
    gp, U, R = job["gp"], job["U"], job["R"]
    mesh = Mesh(np.array(jax.devices()[:gp]), axis_names=("graph",))
    f = shard_map(lambda v: jax_halo(v[0], U, R, "graph")[None], mesh=mesh,
                  in_specs=P("graph"), out_specs=P("graph"), check_vma=False)
    ranks = cases["port"]("halo_ex", i)
    for d in range(4 // gp):
        out, vjp = jax.vjp(jax.jit(f), jnp.asarray(job["x"][d]))
        (grad,) = vjp(jnp.asarray(job["cot"][d]))
        for g in range(gp):
            r = ranks[d * gp + g]
            np.testing.assert_array_equal(r["ext"], np.asarray(out)[g])
            np.testing.assert_allclose(r["grad"], np.asarray(grad)[g], rtol=0, atol=1e-6)


# ---- MeshTrainer ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,gp", GRAPHS_MESHES)
def test_graphs_strategy_matches_jax_mesh(cases, dp, gp):
    ref, job = cases["table"]["graphs"][(dp, gp)]
    mt = jax_mesh_trainer(ref, dp, gp)
    assert mt.strategy == "graphs"
    x = jnp.asarray(ref["x"].reshape(-1, 1))
    p2, _, loss, mets = mt._get_train_step(ref["jt"], 8)(mt.params, mt.opt_state, x, x, ref["key"])
    ranks = cases["port"]("graphs", (dp, gp))
    assert {r["strategy"] for r in ranks} == {"graphs"}
    assert_ranks_identical(ranks)
    np.testing.assert_allclose(ranks[0]["losses"][0], float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0]["mets"][0]["train_mae"], float(mets["train_mae"]),
                               rtol=MET_RTOL)
    assert_params_close("gatres", job["model"][1], p2, ranks[0]["state"])


@pytest.mark.parametrize("dp,gp", HALO_MESHES)
def test_halo_strategy_matches_jax_mesh(cases, dp, gp):
    ref, job = cases["table"]["halo"][(dp, gp)]
    jt = ref["jt"]
    x = jnp.asarray(ref["x"].reshape(-1, 1))
    with Threshold():
        mt = jax_mesh_trainer(ref, dp, gp)
        assert mt.strategy == "halo"
        p2, _, loss, mets = mt._get_train_step(jt, 4)(mt.params, mt.opt_state, x, x, ref["key"])
        eloss, _, eout, _ = mt._get_eval_step(jt, 4)(p2, x, x, ref["key"])
    ranks = cases["port"]("halo", (dp, gp))
    assert {r["strategy"] for r in ranks} == {"halo"}
    assert_ranks_identical(ranks)
    np.testing.assert_allclose(ranks[0]["losses"][0], float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0]["mets"][0]["train_mae"], float(mets["train_mae"]),
                               rtol=MET_RTOL)
    assert_params_close("gatres", job["model"][1], p2, ranks[0]["state"])
    # the eval step after the update, its output gathered in original node order
    perm = mt._halo_part(jt)[0].perm
    ref_out = np.asarray(eout)[:4, :64][:, np.argsort(perm)].reshape(-1, 1)
    for r in ranks:
        np.testing.assert_allclose(r["eval"]["loss"], float(eloss), rtol=1e-4)
        np.testing.assert_allclose(r["eval"]["out"], ref_out, rtol=1e-4, atol=2e-5)
        np.testing.assert_array_equal(r["eval"]["mask"], job["eval_mask"])


def test_tail_batch_pads_with_empty_masks(cases):
    """A batch of 5 on a data axis of 2: padded to 6 graphs whose masks are
    empty; loss and parameters as the JAX MeshTrainer's on the same tail."""
    ref, job = cases["table"]["tail"][None]
    jt = ref["jt"]
    x = jnp.asarray(ref["x"].reshape(-1, 1))
    with Threshold():
        mt = jax_mesh_trainer(ref, 2, 2)
        p2, _, loss, _ = mt._get_train_step(jt, 5)(mt.params, mt.opt_state, x, x, ref["key"])
    ranks = cases["port"]("tail")
    assert_ranks_identical(ranks)
    np.testing.assert_allclose(ranks[0]["losses"][0], float(loss), rtol=LOSS_RTOL)
    assert_params_close("gatres", job["model"][1], p2, ranks[0]["state"])


@pytest.mark.parametrize("route", ROUTES)
def test_band_routes_on_halo_chunks_match_jax_xla(cases, route, monkeypatch):
    """H·C 128 on a 2×2 mesh through each band-attention route, against the
    single-device JAX step on its XLA band path (as
    ``test_meshtrainer_halo_band_kernel_matches_xla``)."""
    ref, job = cases["table"]["route"][route]
    monkeypatch.setenv("GNN_TPU_BAND_ATTN", "0")
    jt = chain_template(np.random.default_rng(42))
    with Threshold():
        st = JaxTrainer(JaxGATRes(**ref["mkw"]), JaxTrainConfig(donate_state=False, **ref["kw"]),
                        JaxNormStats(), jt)
        assert jt.batch(2, mode="banded").band_attn is None
        x = jnp.asarray(ref["x"].reshape(-1, 1))
        p2, _, loss, _ = st._get_train_step(jt, 2)(ref["params"], st.opt_state, x, x, ref["key"])
    ranks = cases["port"]("route", route)
    assert_ranks_identical(ranks)
    np.testing.assert_allclose(ranks[0]["losses"][0], float(loss), rtol=LOSS_RTOL)
    assert_params_close("gatres", job["model"][1], p2, ranks[0]["state"])


@pytest.mark.parametrize("model", ["gin", "chebnet"])
def test_zoo_on_a_halo_mesh_matches_jax(cases, model):
    ref, job = cases["table"]["zoo"][model]
    jt = ref["jt"]
    x = jnp.asarray(ref["x"].reshape(-1, 1))
    with Threshold():
        mt = jax_mesh_trainer(ref, 1, 2)
        p2, _, loss, _ = mt._get_train_step(jt, 4)(mt.params, mt.opt_state, x, x, ref["key"])
    ranks = cases["port"]("zoo", model)
    assert {r["strategy"] for r in ranks} == {"halo"}
    assert_ranks_identical(ranks)
    np.testing.assert_allclose(ranks[0]["losses"][0], float(loss), rtol=LOSS_RTOL)
    assert_params_close(model, job["model"][1], p2, ranks[0]["state"])


# ---- DistributedTrainer and fit -----------------------------------------------------------------

@pytest.mark.parametrize("dp,gp", DIST_MESHES)
def test_distributed_trainer_matches_jax(cases, dp, gp):
    ref, job = cases["table"]["dist"][(dp, gp)]
    dtr = JaxDT(JaxGATRes(**ref["mkw"]), JaxTrainConfig(donate_state=False, **ref["kw"]),
                JaxNormStats(**ref["stats"]), ref["jt"], jax_make_mesh(dp=dp, gp=gp))
    dtr.params = ref["params"]
    dtr.opt_state = dtr.tx.init(dtr.params)
    p2, _, loss, mets = dtr.step(dtr.params, dtr.opt_state, dtr.pack(ref["x"]), ref["key"])
    ranks = cases["port"]("dist", (dp, gp))
    assert_ranks_identical(ranks, ("state",))
    np.testing.assert_allclose(ranks[0]["losses"][0], float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0]["mets"][0]["train_mae"], float(mets["train_mae"]),
                               rtol=MET_RTOL)
    assert_params_close("gatres", job["model"][1], p2, ranks[0]["state"])


def test_fit_resume_ends_bit_identical_on_every_rank(cases):
    """3 epochs of ``fit`` (AutoClip, ReduceLROnPlateau) on a 1×2 halo mesh,
    and 1 epoch, a restore from its last checkpoint and 2 more: every rank's
    parameters, Adam state and AutoClip history equal, and the resumed run
    equal to the uninterrupted one, bit for bit."""
    ranks = cases["port"]("fit")
    for tag in ("full", "part", "resumed"):
        assert_ranks_identical([r[tag] for r in ranks])
    r0 = ranks[0]
    assert r0["full"]["best"] == r0["resumed"]["best"]
    for part in ("state", "opt"):
        for k, v in r0["full"][part].items():
            np.testing.assert_array_equal(r0["resumed"][part][k], v, err_msg=f"{part} {k}")
    assert any(not np.array_equal(r0["part"]["state"][k], v) for k, v in r0["full"]["state"].items())


# ---- the device and the backend ---------------------------------------------------------------

def test_mesh_entry_points_default_to_the_card(monkeypatch):
    """No card: the rank's device and the join of an outside launch raise,
    before any process group is made; nothing falls back to the CPU."""
    from gnn_pressure_estimation_tpu_torch.parallel.mesh import init_distributed, rank_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rank_device("cuda", 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed("127.0.0.1:1", num_processes=2, process_id=0)
    assert rank_device("cpu", 3) == torch.device("cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,ranks,cards,backend", [
    ("cpu", 2, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 2, 1, "gloo"), ("cuda", 4, 4, "nccl"),
    ("cuda", 4, 2, "gloo")])
def test_backend_follows_the_stated_rule(monkeypatch, device, ranks, cards, backend):
    from gnn_pressure_estimation_tpu_torch.parallel.mesh import choose_backend

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got, why = choose_backend(device, ranks)
    assert got == backend and why


def test_a_lost_rank_ends_the_launch(tmp_path):
    """A rank that leaves (exit 17) while the other waits in a collective: the
    launch ends non-zero well before the group timeout, with the lost rank's
    code or the waiting rank's, whose collective fails when its peer is
    gone (gloo sees the closed connection)."""
    import time

    spec = tmp_path / "spec.pkl"
    with open(spec, "wb") as f:
        pickle.dump({"jobs": [dict(kind="lost_rank", dp=1, gp=2, lost=1)], "out": str(tmp_path)},
                    f)
    t0 = time.monotonic()
    code = spawn_jobs(2, str(spec), device="cpu", threads=1, timeout_s=120, group_timeout_s=60)
    assert code in (17, 1)
    assert time.monotonic() - t0 < 50
    assert not (tmp_path / "rank0.pkl").exists()
