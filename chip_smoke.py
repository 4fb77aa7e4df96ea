#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. Require CUDA; print the card's name and power limit; turn TF32 off.
2. Build the hand-written kernels (``csrc/*.cu``) for sm_90a.
3. Hold each kernel against its plain PyTorch version on the card, at the
   bigtown band layout (B 1 and B 4) and at small ragged shapes (W not a multiple
   of 32, fully masked rows, H·C 64, C past one 256-channel tile); atol and
   rtol 1e-4, since the kernels sum in another order.
4. Fixture parity: the trained GATRes-large on bigtown (banded, through the
   kernels) against the JAX activations stored in
   ``artifacts/parity_r5_trained.npz`` (atol 1e-3), with exactly 50
   band-attention and 25 band-SpMM launches per forward; and the dense
   15-block fixture ``artifacts/parity.npz`` (atol 1e-4).
5. Serving: ``Inferencer`` answers 64 bigtown snapshots at batch 32, with
   exactly 50 and 25 launches per batch; ``torch.profiler`` then splits one
   batch's device time by kernel.
6. At the serving shapes (B 32), holds each kernel against its plain version
   once more (atol and rtol 1e-4), then times it beside the plain version, a
   PyTorch library call where one computes the same function, and its bound
   on an H100 SXM.

The last line is ``{"ok": true, "device": {...}}``; the ``kernels`` JSON line
and the ``nvidia-smi`` line come before it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4
# H100 SXM data sheet: HBM3 bandwidth and f32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
TPU_SRC = "gnn_pressure_estimation_tpu/ops/pallas/band_attention.py"


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float,
                verbose: bool = True) -> float:
    if got.shape != ref.shape:
        raise SystemExit(f"FAIL {name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise SystemExit(f"FAIL {name}: non-finite values")
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, atol=atol, rtol=rtol):
        raise SystemExit(f"FAIL {name}: max abs err {err:.3e} (atol {atol}, rtol {rtol})")
    if verbose:
        print(f"  {name}: max abs err {err:.3e}")
    return err


def profile_batch(run) -> None:
    """Device time by kernel over one serving batch (``torch.profiler``), and
    the device's busy share of the batch's host-clock time. The profiler's
    own overhead lengthens the host time, so the busy share is a floor."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 reverse=True)
    busy_us = sum(t for t, _, _ in dev)
    if not busy_us:
        print("  profile: the profiler recorded no device time")
        return
    print(f"  profile of one batch: device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"host time ({busy_us / wall_us:.1%}); by kernel:")
    for t, count, key in dev[:8]:
        print(f"    {t / 1e3:9.3f} ms {t / busy_us:6.1%} x{count:<4d} {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
    from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
    from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
    from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.models.presets import select_model
    from gnn_pressure_estimation_tpu_torch.ops import _build
    from gnn_pressure_estimation_tpu_torch.ops.band_attention import (
        band_attention_fwd, band_attention_plain,
    )
    from gnn_pressure_estimation_tpu_torch.ops.band_spmm import band_spmm_fwd, band_spmm_plain
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats, descale_with
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = smi_line()
    print(f"[1] card: {card} ({kind}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    wn = parse_inp(os.path.join(REPO, "inputs", "bigtown.inp"))
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                            name="bigtown")
    n = tpl.n_node
    bl = tpl.band_layout()
    nB, BLK, W = bl.adj_mask.shape
    n_pad, n_ext = bl.n_pad, bl.n_pad + W - BLK
    mask = torch.as_tensor(bl.adj_mask.view(np.int8), device=dev)
    cnt = torch.as_tensor(bl.adj_cnt, device=dev)
    print(f"  bigtown: n {n}, edges {tpl.n_edge}, nB {nB}, BLK {BLK}, W {W}, n_pad {n_pad}, "
          f"n_ext {n_ext}, mask density {bl.adj_mask.mean():.4%}")

    # ---- 3: each kernel against its plain version -------------------------
    print("[3] kernels vs plain versions on the card")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    max_err = {"band_attention": 0.0, "band_spmm": 0.0}

    def check_attention(tag, msk, B, H, C):
        nB_, BLK_, W_ = msk.shape
        np_, ne_ = nB_ * BLK_, nB_ * BLK_ + W_ - BLK_
        args = (randn(B, np_, H), randn(nB_, B, W_, H), randn(B, ne_, H, C), msk)
        got = band_attention_fwd(*args, 0.2)
        ref = band_attention_plain(*args, 0.2)
        err = check_close(f"band_attention {tag} B{B} H{H} C{C}", got, ref, TOL, TOL)
        max_err["band_attention"] = max(max_err["band_attention"], err)

    def check_spmm(tag, band, B, C):
        nB_, BLK_, W_ = band.shape
        x_ext = randn(B, nB_ * BLK_ + W_ - BLK_, C)
        got = band_spmm_fwd(band, x_ext)
        ref = band_spmm_plain(band, x_ext)
        err = check_close(f"band_spmm {tag} {str(band.dtype)[6:]} B{B} C{C}", got, ref, TOL, TOL)
        max_err["band_spmm"] = max(max_err["band_spmm"], err)

    for B in (1, 4):                            # fixture parity runs B 1
        for H in (2, 1):
            check_attention("bigtown", mask, B, H, 128)
        check_spmm("bigtown", cnt, B, 128)
    rng = np.random.default_rng(0)
    rmask = rng.random((3, 16, 70)) < 0.3
    rmask[-1, -5:] = False                       # fully masked (padded) rows
    rmask_t = torch.as_tensor(rmask.view(np.int8), device=dev)
    rcnt = torch.as_tensor((rmask * rng.integers(1, 4, rmask.shape)).astype(np.int8), device=dev)
    rw = torch.as_tensor((rmask * rng.random(rmask.shape)).astype(np.float32), device=dev)
    check_attention("ragged", rmask_t, 3, 2, 32)
    check_attention("ragged", rmask_t, 2, 1, 300)
    for band in (rcnt, rw):
        check_spmm("ragged", band, 3, 64)
        check_spmm("ragged", band, 2, 300)
    torch.cuda.synchronize()

    # ---- 4: fixture parity ------------------------------------------------
    print("[4] fixture parity against the JAX activations")
    npz = os.path.join(REPO, "artifacts", "parity_r5_trained.npz")
    fx = np.load(npz)
    model = GATRes(int(fx["num_blocks"]), int(fx["nc"]))
    model.load_state_dict(params_from_parity_npz(npz))
    model = model.to(dev).eval()
    graph = tpl.batch(1, device=dev)
    acts = {}
    hooks = [blk.register_forward_hook(lambda m, i, o, k=k: acts.__setitem__(k, o))
             for k, blk in enumerate(model.blocks)]
    band_attention_fwd.launches = band_spmm_fwd.launches = 0
    with torch.inference_mode():
        x = graph.pack_nodes(torch.as_tensor(fx["x"], device=dev), n)
        out = graph.unpack_nodes(model(x, graph), n)
        torch.cuda.synchronize()
    launches = (band_attention_fwd.launches, band_spmm_fwd.launches)
    per_forward = {"band_attention": launches[0], "band_spmm": launches[1]}
    for h in hooks:
        h.remove()
    if launches != (2 * model.num_blocks, model.num_blocks):
        raise SystemExit(f"FAIL launches per forward {launches}, expected (50, 25)")
    print(f"  launches per forward: band_attention {launches[0]}, band_spmm {launches[1]}")
    block_err = max(
        check_close(f"bigtown block {k}", graph.unpack_nodes(a, n).cpu(),
                    torch.as_tensor(fx[f"ours_act_block_{k}"]), 1e-3, 0.0, verbose=False)
        for k, a in sorted(acts.items())
    )
    out_err = check_close("bigtown output", out.cpu(), torch.as_tensor(fx["ours_out"]), 1e-3, 0.0)
    print(f"  bigtown GATRes-large vs JAX: worst block {block_err:.3e}, output {out_err:.3e}")

    dz = np.load(os.path.join(REPO, "artifacts", "parity.npz"))
    und = dz["edge_index_und"].T
    dtpl = GraphTemplate(int(dz["n"]), np.concatenate([und[:, 0], und[:, 1]]),
                         np.concatenate([und[:, 1], und[:, 0]]))
    dmodel = GATRes(int(dz["num_blocks"]), int(dz["nc"]), attn_impl="softmax")
    dmodel.load_state_dict(params_from_parity_npz(os.path.join(REPO, "artifacts", "parity.npz")))
    dmodel = dmodel.to(dev).eval()
    dgraph = dtpl.batch(int(dz["batch"]), device=dev)
    dacts = {}
    hooks = [blk.register_forward_hook(lambda m, i, o, k=k: dacts.__setitem__(k, o))
             for k, blk in enumerate(dmodel.blocks)]
    with torch.inference_mode():
        dout = dmodel(torch.as_tensor(dz["x"], device=dev), dgraph)
    for h in hooks:
        h.remove()
    dblock_err = max(
        check_close(f"dense block {k}", a.cpu(), torch.as_tensor(dz[f"ours_act_block_{k}"]),
                    1e-4, 0.0, verbose=False)
        for k, a in sorted(dacts.items())
    )
    dout_err = check_close("dense output", dout.cpu(), torch.as_tensor(dz["ours_out"]), 1e-4, 0.0,
                           verbose=False)
    print(f"  dense GATRes (15 blocks, nc 32) vs JAX: worst block {dblock_err:.3e}, "
          f"output {dout_err:.3e}")

    # ---- 5: serving -------------------------------------------------------
    print("[5] serving through Inferencer")
    smodel, _ = select_model("gatres_large", device=dev)
    smodel.load_state_dict(params_from_parity_npz(npz))
    stats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    inf = Inferencer(smodel, stats, device=dev)
    snaps = (fx["x"][:, 0][None, :] + 0.1 * rng.standard_normal((64, n))).astype(np.float32)
    obs = inf.observed_indices(tpl, "random", mask_rate=0.95, seed=0)
    bs = 32
    n_batches = -(-len(snaps) // bs)
    inf.infer(tpl, snaps, obs, scaled=True, batch_size=bs)          # warm-up
    torch.cuda.synchronize()
    band_attention_fwd.launches = band_spmm_fwd.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = inf.infer(tpl, snaps, obs, scaled=True, batch_size=bs, with_truth=True)
    end.record()
    end.synchronize()
    serve_launches = {"band_attention": band_attention_fwd.launches,
                      "band_spmm": band_spmm_fwd.launches}
    expect = {"band_attention": n_batches * 50, "band_spmm": n_batches * 25}
    if serve_launches != expect:
        raise SystemExit(f"FAIL serving launches {serve_launches}, expected {expect}")
    if res.pred.shape != snaps.shape or not np.isfinite(res.pred).all():
        raise SystemExit("FAIL serving output is not a finite [S, n] field")
    served = np.asarray(descale_with(snaps, stats), np.float32)[:, obs]
    if not np.array_equal(res.pred[:, obs], served):
        raise SystemExit("FAIL observed nodes are not served at their readings")
    print(f"  {len(snaps)} snapshots, batch {bs}, {len(obs)} observed of {n}: "
          f"{start.elapsed_time(end) / n_batches:.3f} ms per batch; launches {serve_launches}; "
          f"hidden MAE {res.metrics['hidden_mae']:.4f}")
    profile_batch(lambda: inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs))

    # ---- 6: kernel times at the serving shapes (B 32) ---------------------
    print(f"[6] kernel times at B {bs} on {card}")
    B = bs
    nnz_mask = int(bl.adj_mask.sum())
    nnz_cnt = int((bl.adj_cnt != 0).sum())
    rows = []
    for H, C in ((2, 128), (1, 128)):
        args = (randn(B, n_pad, H), randn(nB, B, W, H), randn(B, n_ext, H, C), mask)
        err = check_close(f"band_attention serving B{B} H{H} C{C}", band_attention_fwd(*args, 0.2),
                          band_attention_plain(*args, 0.2), TOL, TOL)
        max_err["band_attention"] = max(max_err["band_attention"], err)
        k_ms = cuda_ms(lambda: band_attention_fwd(*args, 0.2), 3, 20)
        p_ms = cuda_ms(lambda: band_attention_plain(*args, 0.2), 1, 3)
        # a_src counted once per row of x_ext, not as its W-row windowed copy
        nbytes = 4 * (B * n_pad * H + B * n_ext * H + B * n_ext * H * C
                      + B * n_pad * H * C) + nB * BLK * W
        ops = B * H * nnz_mask * (2 * C + 4)     # FMA per channel; add, LeakyReLU, exp, sum
        dense_ms = 2 * B * n_pad * W * H * C / PEAK_F32_S * 1e3
        rows.append(dict(name="band_attention", hc=H * C, ms=k_ms, plain_ms=p_ms,
                         library_ms=None, bytes=nbytes, ops=ops, dense_bound_ms=dense_ms))
    C = 128
    x_ext = randn(B, n_ext, C)
    err = check_close(f"band_spmm serving int8 B{B} C{C}", band_spmm_fwd(cnt, x_ext),
                      band_spmm_plain(cnt, x_ext), TOL, TOL)
    max_err["band_spmm"] = max(max_err["band_spmm"], err)
    k_ms = cuda_ms(lambda: band_spmm_fwd(cnt, x_ext), 3, 20)
    p_ms = cuda_ms(lambda: band_spmm_plain(cnt, x_ext), 1, 3)
    # library yardstick: one CSR sparse-dense product over the same band
    blk_i, r_i, j_i = np.nonzero(bl.adj_cnt)
    csr = torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([blk_i * BLK + r_i, blk_i * BLK + j_i]), device=dev),
        torch.as_tensor(bl.adj_cnt[blk_i, r_i, j_i].astype(np.float32), device=dev),
        (n_pad, n_ext),
    ).to_sparse_csr()
    x2d = x_ext.permute(1, 0, 2).reshape(n_ext, B * C).contiguous()
    lib_out = torch.sparse.mm(csr, x2d).reshape(n_pad, B, C).permute(1, 0, 2)
    check_close("band_spmm vs torch.sparse.mm", band_spmm_fwd(cnt, x_ext), lib_out, TOL, TOL)
    l_ms = cuda_ms(lambda: torch.sparse.mm(csr, x2d), 3, 20)
    rows.append(dict(name="band_spmm", hc=C, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                     bytes=nB * BLK * W + 4 * (B * n_ext * C + B * n_pad * C),
                     ops=2 * B * C * nnz_cnt,
                     dense_bound_ms=2 * B * n_pad * W * C / PEAK_F32_S * 1e3))
    summary = []
    for r in rows:
        t_bytes, t_ops = r["bytes"] / PEAK_BYTES_S * 1e3, r["ops"] / PEAK_F32_S * 1e3
        r["bound_ms"], r["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        summary.append(
            f"{r['name']} H·C {r['hc']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; nonzeros), "
            f"dense-window bound {r['dense_bound_ms']:.4f} ms")
    print("  times: " + "; ".join(summary))

    replaces = {"band_attention": f"{TPU_SRC}:208", "band_spmm": f"{TPU_SRC}:1084"}
    kernels = []
    for name in ("band_attention", "band_spmm"):
        r = next(r for r in rows if r["name"] == name)   # band_attention: the H·C 256 shape
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gnn_pressure_estimation_tpu_torch/csrc/{name}.cu",
            # launches: the serving run's count over its n_batches forwards
            "replaces": replaces[name], "launches": serve_launches[name],
            "launches_per_forward": per_forward[name], "serving_batches": n_batches,
            "max_abs_err": max_err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dense_window_bound_ms": r["dense_bound_ms"],
            "shape": f"B {B}, n_pad {n_pad}, W {W}, H·C {r['hc']}",
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
