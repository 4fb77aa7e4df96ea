"""The mesh's NCCL branches on four cards: the collectives, then full-width steps.

    python tools/mesh_nccl4.py            # one host with 4 cards (NCCL, one rank a card)
    python tools/mesh_nccl4.py --cpu      # the collectives only, on 4 gloo CPU ranks

On one card a mesh under NCCL is a world of one, where every collective of
``parallel.mesh.Mesh`` returns early; this script runs the branches that
only a world of several NCCL ranks takes (``all_reduce``, ``broadcast_``,
``gather_blocks`` and ``barrier`` on CUDA tensors, ``sum_blocks``'
reduce-scatter, ``swap``'s ``batch_isend_irecv``) and holds them:

1. **Collectives**, at 1×4 and 2×2: each of them on every axis, and the halo
   exchange forward and backward at (U, R) = (3, 2), (2, 0), (0, 3), on
   small integer-valued f32 inputs, where every sum is exact. Each rank
   holds its results equal to numpy's; the parent holds the NCCL ranks'
   results bit-equal to those of the same jobs on 4 gloo CPU ranks.
2. **Steps**, each against the single-device ``Trainer`` step on card 0 with
   ``chip_smoke.py``'s gates (loss rtol 1e-5, each gradient within
   1e-3·max|g| + 1e-6, outputs within 1e-5·max(1, max|ref|), the kernel
   launches of one device, parameters bit-identical on every rank after the
   step): bigtown GATRes-large (25 blocks, nc 128) at B 8 on a 1×4 and a
   2×2 halo mesh; synthctown GATRes-small's ``DistributedTrainer`` (the edge
   partition, whose all-gather's backward is ``sum_blocks``) at 1×4, B 8.

Prints each rank's backend, step ms, exchange ms and bytes, and peak memory
beside the card's ``nvidia-smi`` name and power limit; exits non-zero when
a check fails. The ranks' entry point is :func:`rank` (this directory is put
on their ``PYTHONPATH``); the step jobs are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import copy
import os
import pickle
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

HALO_CASES = ((3, 2), (2, 0), (0, 3))      # (U, R), chunk 6
MESHES = ((1, 4), (2, 2))


def _inp(rank: int, salt: int, shape) -> np.ndarray:
    """Rank ``rank``'s input: small integers as f32, so every sum is exact."""
    return (np.arange(int(np.prod(shape))).reshape(shape) % 97 + 100 * rank + salt).astype(
        np.float32)


def _collectives(job, mesh, counters=None) -> dict:
    """Every collective of ``mesh`` on every axis and the halo exchange; the
    results as numpy arrays and the names of those that differ from numpy."""
    from gnn_pressure_estimation_tpu_torch.parallel.halo import halo_exchange

    r, g, gp, dev = mesh.rank, mesh.g, mesh.gp, mesh.device

    def t(a):
        return torch.as_tensor(a, device=dev)
    got, want = {}, {}
    members = {"world": list(range(mesh.world)),
               "graph": [mesh.graph_rank(k) for k in range(gp)],
               "data": [k * gp + g for k in range(mesh.dp)]}
    for axis, ranks in members.items():
        n, pos = len(ranks), ranks.index(r)
        got[f"all_reduce {axis}"] = mesh.all_reduce(t(_inp(r, 1, (8, 3))), axis)
        want[f"all_reduce {axis}"] = sum(_inp(k, 1, (8, 3)) for k in ranks)
        got[f"gather_blocks {axis}"] = mesh.gather_blocks(t(_inp(r, 2, (4, 3))), axis)
        want[f"gather_blocks {axis}"] = np.concatenate([_inp(k, 2, (4, 3)) for k in ranks])
        got[f"sum_blocks {axis}"] = mesh.sum_blocks(t(_inp(r, 3, (4 * n, 3))), axis)
        want[f"sum_blocks {axis}"] = sum(_inp(k, 3, (4 * n, 3)) for k in ranks)[4 * pos:4 * pos + 4]
    b = t(_inp(r, 4, (8, 3)))
    got["broadcast_"] = mesh.broadcast_(b)
    want["broadcast_"] = _inp(0, 4, (8, 3))
    B, chunk, C = 2, 6, 5
    for U, R in HALO_CASES:
        xs = [_inp(mesh.graph_rank(k), 5, (B, chunk, C)) for k in range(gp)]
        cots = [_inp(mesh.graph_rank(k), 6, (B, U + chunk + R, C)) for k in range(gp)]
        x = t(xs[g]).requires_grad_(True)
        ext = halo_exchange(x, U, R, mesh)
        (ext * t(cots[g])).sum().backward()
        got[f"halo {U},{R}"], got[f"halo grad {U},{R}"] = ext, x.grad
        zeros = np.zeros((B, 0, C), np.float32)
        left = xs[g - 1][:, chunk - U:] if g > 0 else np.zeros((B, U, C), np.float32)
        right = xs[g + 1][:, :R] if g < gp - 1 else np.zeros((B, R, C), np.float32)
        want[f"halo {U},{R}"] = np.concatenate([left if U else zeros, xs[g],
                                                right if R else zeros], axis=1)
        d = cots[g][:, U:U + chunk].copy()
        if g > 0 and R:
            d[:, :R] += cots[g - 1][:, U + chunk:]          # g−1's right context
        if g < gp - 1 and U:
            d[:, chunk - U:] += cots[g + 1][:, :U]          # g+1's left context
        want[f"halo grad {U},{R}"] = d
    mesh.barrier()
    got = {k: v.detach().cpu().numpy() for k, v in got.items()}
    bad = [k for k in want if got[k].shape != want[k].shape or not np.array_equal(got[k], want[k])]
    return {"got": got, "bad": bad}


def rank(payload: str) -> int:
    """The ranks' entry point: on the cards, ``chip_smoke.mesh_rank`` with the
    collectives job added; on the CPU, the collectives jobs alone."""
    import torch.distributed as dist

    from gnn_pressure_estimation_tpu_torch.parallel import make_mesh

    with open(payload, "rb") as f:
        spec = pickle.load(f)
    if spec["device"] == "cuda":
        cs.MESH_JOBS["collectives"] = _collectives
        return cs.mesh_rank(payload)
    results = []
    for job in spec["jobs"]:
        mesh = make_mesh(job["dp"], job["gp"], device="cpu")
        res = _collectives(job, mesh)
        res.update(name=job["name"], backend=mesh.backend, device=str(mesh.device))
        results.append(res)
    with open(os.path.join(spec["out"], f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(results, f)
    return 0


def launch(jobs: list, out_dir: str, device: str, timeout_s: float) -> dict:
    """``jobs`` on 4 ranks; every rank's results by job name, in rank order."""
    from gnn_pressure_estimation_tpu_torch.parallel.launch import spawn

    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"jobs": jobs, "out": out_dir, "device": device}, f)
    path = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    os.environ["PYTHONPATH"] = os.pathsep.join([HERE] + path)
    code = spawn(4, "mesh_nccl4:rank", spec, device=device, timeout_s=timeout_s,
                 threads=1 if device == "cpu" else None)
    if code != 0:
        raise SystemExit(f"FAIL a rank of the 4-rank {device} launch exited with {code}")
    ranks = []
    for r in range(4):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {res["name"]: [ranks[r][i] for r in range(4)] for i, res in enumerate(ranks[0])}


def collectives(tmp: str, device: str) -> dict:
    """Part 1 on 4 ranks of ``device``: every rank's results equal numpy's."""
    from gnn_pressure_estimation_tpu_torch.parallel.mesh import choose_backend

    jobs = [dict(kind="collectives", name=f"{dp}x{gp}", dp=dp, gp=gp) for dp, gp in MESHES]
    by = launch(jobs, os.path.join(tmp, f"coll_{device}"), device, 300)
    rule = choose_backend(device, 4)[0]
    for name, ranks in by.items():
        for r, res in enumerate(ranks):
            if res["backend"] != rule:
                raise SystemExit(f"FAIL {name} rank {r}: backend {res['backend']}, the rule "
                                 f"gives {rule}")
            if res["bad"]:
                raise SystemExit(f"FAIL {name} rank {r} ({res['backend']}): {res['bad']} differ "
                                 "from numpy")
        print(f"  {name} ({rule}, {device}): {len(ranks[0]['got'])} results a rank equal to "
              "numpy's on all 4 ranks", flush=True)
    return by


def steps(tmp: str, card: str) -> None:
    """Part 2: the full-width steps on 4 NCCL ranks against one device."""
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
    from gnn_pressure_estimation_tpu_torch.utils.masking import batch_node_mask
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    dev = torch.device("cuda", 0)

    def save_state(tag, model):
        path = os.path.join(tmp, f"{tag}.pt")
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
        return path

    def mask_of(seed, B, n):
        return batch_node_mask(torch.Generator().manual_seed(seed), B, n, 0.95).numpy()

    def reference(tpl, model, cfg, stats, x, mask):
        """The single-device eval step's output (original order), then a train
        step's loss and gradients, then 3 steps timed."""
        tr = Trainer(copy.deepcopy(model), TrainConfig(**cfg), stats, tpl, device=dev)
        _, _, o, _ = tr.eval_step(tpl, x, mask=mask)
        g = tr._batched_graph(tpl, x.shape[0])
        o = g.unpack_nodes(o, tpl.n_node) if g.banded else o
        loss, _ = tr.train_step(tpl, x, mask=mask)
        ref = {"out": o.detach().cpu(), "loss": float(loss),
               "grads": {k: p.grad.detach().cpu() for k, p in tr.model.named_parameters()}}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            tr.train_step(tpl, x, mask=mask)
        torch.cuda.synchronize()
        ref["step_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        ref["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return ref

    npz = os.path.join(REPO, "artifacts", "parity_r5_trained.npz")
    tfx = np.load(os.path.join(REPO, "artifacts", "parity_train_bigtown.npz"))
    tstats = dict(norm_type="znorm", mean=float(tfx["stats_mean"]), std=float(tfx["stats_std"]))
    big = cs.network("bigtown")
    n = big.n_node
    xb = (np.asarray(np.load(npz)["x"], np.float32)[:, 0][None, :]
          + 0.1 * np.random.default_rng(44).standard_normal((8, n))).astype(np.float32)
    mask8 = mask_of(44, 8, n)
    cfg = dict(batch_size=8, mask_rate=0.95, criterion="mse", model_name="gatres_large")
    large = dict(num_blocks=25, channels=128, attn_impl="factored")
    m_large = GATRes(**large).to(dev)
    m_large.load_state_dict(params_from_parity_npz(npz))
    spec = {"kwargs": large, "state": save_state("large", m_large)}
    ref_big = reference(big, m_large, cfg, NormStats(**tstats), xb, mask8)
    nb = len(m_large.blocks)
    fwd = {"band_attention": 2 * nb, "band_spmm": nb, "gat_logits": 2 * nb}
    step = {**fwd, "band_attention_bwd": 2 * nb, "band_spmm_bwd": nb, "gat_logits_bwd": 2 * nb}
    jobs = [dict(kind="step", name=f"bigtown {dp}x{gp}", net="bigtown", model=spec, cfg=cfg,
                 stats=tstats, x=xb, mask=mask8, dp=dp, gp=gp) for dp, gp in MESHES]
    syn = cs.network("synthctown")
    small = dict(num_blocks=15, channels=32, attn_impl="factored")
    torch.manual_seed(48)
    m_small = GATRes(**small).to(dev)
    sspec = {"kwargs": small, "state": save_state("small", m_small)}
    xs = np.random.default_rng(48).standard_normal((8, syn.n_node)).astype(np.float32)
    masks = mask_of(48, 8, syn.n_node)
    dcfg = dict(batch_size=8, mask_rate=0.95, criterion="mse")
    ref_dist = reference(syn, m_small, dcfg, NormStats(), xs, masks)
    jobs.append(dict(kind="dist", name="distributed 1x4", net="synthctown", model=sspec,
                     cfg=dcfg, stats={}, x=xs, mask=masks, dp=1, gp=4))
    del m_large, m_small
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    by = launch(jobs, os.path.join(tmp, "steps"), "cuda", 900)
    print(f"  the 4-rank launch took {time.perf_counter() - t0:.1f} s", flush=True)

    for dp, gp in MESHES:
        label = f"bigtown {dp}x{gp}"
        ranks = by[label]
        for r, res in enumerate(ranks):
            if res["backend"] != "nccl" or res["strategy"] != "halo":
                raise SystemExit(f"FAIL {label} rank {r}: {res['backend']}, {res['strategy']}")
            rel = abs(res["loss"] - ref_big["loss"]) / abs(ref_big["loss"])
            if rel > 1e-5:
                raise SystemExit(f"FAIL {label} rank {r}: loss {res['loss']!r} against "
                                 f"{ref_big['loss']!r} (rtol 1e-5)")
            worst = cs.grads_gate(f"{label} rank {r}", res["grads"], ref_big["grads"])
            err, equal = cs.outputs_gate(f"{label} rank {r}", res["out"], ref_big["out"])
            cs.launches_as_expected(f"{label} rank {r} forward", res["fwd_launches"], fwd)
            cs.launches_as_expected(f"{label} rank {r} step", res["step_launches"], step)
            print(f"  {label} rank {r} ({res['backend']}, {res['device']}): loss "
                  f"{res['loss']:.7f} (single {ref_big['loss']:.7f}), gradients at {worst:.1%} "
                  f"of the gate, outputs within {err:.3e}{' (bit-equal)' if equal else ''}; "
                  f"step {res['step_ms']:.3f} ms, exchange {res['exchange_ms']:.3f} ms in "
                  f"{res['exchange_calls']} exchanges ({res['exchange_bytes'] / 1e6:.3f} MB "
                  f"sent), peak {res['peak_gb']:.3f} GB [{card}]", flush=True)
        for k in ranks[0]["params"]:
            if any(not torch.equal(res["params"][k], ranks[0]["params"][k]) for res in ranks[1:]):
                raise SystemExit(f"FAIL {label}: the ranks' parameter {k} differ after the step")
        print(f"  {label}: parameters bit-identical on the 4 ranks after the step", flush=True)
    print(f"  bigtown on one device: step {ref_big['step_ms']:.3f} ms, peak "
          f"{ref_big['peak_gb']:.3f} GB [{card}]")
    for r, res in enumerate(by["distributed 1x4"]):
        # the edge list launches no kernel; each rank's f32 layers run the logit halves
        halves = 2 * small["num_blocks"]
        cs.launches_as_expected(f"DistributedTrainer rank {r}", res["launches"],
                                {"gat_logits": halves, "gat_logits_bwd": halves})
        rel = abs(res["loss"] - ref_dist["loss"]) / abs(ref_dist["loss"])
        worst = cs.grads_gate(f"DistributedTrainer rank {r}", res["grads"], ref_dist["grads"])
        if rel > 1e-5 or res["backend"] != "nccl":
            raise SystemExit(f"FAIL DistributedTrainer rank {r} ({res['backend']}): loss off by "
                             f"{rel:.3e} relative")
        print(f"  DistributedTrainer 1x4 rank {r} ({res['backend']}): loss {res['loss']:.7f} "
              f"(single {ref_dist['loss']:.7f}), gradients at {worst:.1%} of the gate; step "
              f"{res['step_ms']:.3f} ms (one device, dense kernels: {ref_dist['step_ms']:.3f}) "
              f"[{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="the collectives on 4 gloo CPU ranks only")
    a = ap.parse_args()
    tmp = tempfile.mkdtemp(prefix="nccl4_")
    t0 = time.perf_counter()
    try:
        print("[1] the collectives on 4 gloo CPU ranks", flush=True)
        gloo = collectives(tmp, "cpu")
        if a.cpu:
            return 0
        if torch.cuda.device_count() < 4:
            raise SystemExit(f"FAIL {torch.cuda.device_count()} card(s): this needs 4")
        from gnn_pressure_estimation_tpu_torch.ops import _build

        card = cs.smi_line()
        print(f"[2] cards: {card} ×{torch.cuda.device_count()}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t1 = time.perf_counter()
        _build.build_all()
        print(f"  kernels built in {time.perf_counter() - t1:.1f} s", flush=True)
        print("[3] the collectives on 4 NCCL ranks, one a card", flush=True)
        nccl = collectives(tmp, "cuda")
        for name, ranks in nccl.items():
            for r, res in enumerate(ranks):
                for k, v in res["got"].items():
                    if not np.array_equal(v, gloo[name][r]["got"][k]):
                        raise SystemExit(f"FAIL {name} rank {r}: {k} under NCCL differs from gloo")
            print(f"  {name}: every NCCL result bit-equal to gloo's on all 4 ranks", flush=True)
        print("[4] full-width steps on 4 NCCL ranks against one device", flush=True)
        steps(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"ok: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
