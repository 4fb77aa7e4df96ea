#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. Require CUDA; print the card's name and power limit; turn TF32 off.
2. Build the hand-written kernels (``csrc/*.cu``) for sm_90a.
3. Hold each kernel, forward and backward, against its plain PyTorch version
   on the card, at the bigtown band layout (B 1 and B 4) and at small ragged
   shapes (W not a multiple of 32, fully masked rows, H·C 64, C past one
   256-channel tile, rows with more than 32 entries); atol and rtol 1e-4,
   since the kernels sum in another order. The backward kernels get a random
   cotangent on all rows.
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
   on an H100 SXM; the backward kernels also at the training batch (B 8).
7. Training at full width: GATRes-large from the trained fixture's weights on
   bigtown. (a) One step at B 1 with the mask of
   ``artifacts/parity_train_bigtown.npz``: loss, every gradient and the
   parameters after 3 Adam steps against the JAX ``Trainer``'s, with exactly
   50 + 25 forward and 50 + 25 backward launches per step. (b) The same step
   through the plain versions on the card. (c) ``Trainer.fit`` for 2 epochs at
   batch 8 on 32 + 16 snapshots in memory: finite losses, no divergence,
   checkpoints written and reloaded, exact launch counts; then the step time
   (CUDA events), peak memory and a ``torch.profiler`` split of one step.

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


def profile_batch(run, what: str = "one batch", top: int = 8) -> None:
    """Device time by kernel over one serving batch or train step
    (``torch.profiler``), and the device's busy share of its host-clock time.
    The profiler's own overhead lengthens the host time, so the busy share is
    a floor."""
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
    print(f"  profile of {what}: device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"host time ({busy_us / wall_us:.1%}); by kernel:")
    for t, count, key in dev[:top]:
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
    from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset, _Member
    from gnn_pressure_estimation_tpu_torch.ops import _build
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops
    from gnn_pressure_estimation_tpu_torch.ops.band_attention import (
        band_attention_bwd, band_attention_bwd_plain, band_attention_fwd, band_attention_plain,
    )
    from gnn_pressure_estimation_tpu_torch.ops.band_spmm import (
        band_spmm_bwd, band_spmm_bwd_plain, band_spmm_fwd, band_spmm_plain,
    )
    from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer, load_checkpoint
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
    mask_ix = tpl.band_index("adj_mask").to(dev)      # the template's cached indices, as
    cnt_ix = tpl.band_index("adj_cnt").to(dev)        # the model's path passes them
    wrappers = {"band_attention": band_attention_fwd, "band_spmm": band_spmm_fwd,
                "band_attention_bwd": band_attention_bwd, "band_spmm_bwd": band_spmm_bwd}

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

    def read_launches():
        return {k: w.launches for k, w in wrappers.items()}
    print(f"  bigtown: n {n}, edges {tpl.n_edge}, nB {nB}, BLK {BLK}, W {W}, n_pad {n_pad}, "
          f"n_ext {n_ext}, mask density {bl.adj_mask.mean():.4%}")

    # ---- 3: each kernel against its plain version -------------------------
    print("[3] kernels vs plain versions on the card")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    max_err = dict.fromkeys(wrappers, 0.0)

    def held(name, label, got, ref, verbose=True):
        max_err[name] = max(max_err[name], check_close(label, got, ref, TOL, TOL, verbose))

    def check_attention(tag, msk, B, H, C, index=None):
        """Forward, and backward with a random cotangent on every row."""
        nB_, BLK_, W_ = msk.shape
        np_, ne_ = nB_ * BLK_, nB_ * BLK_ + W_ - BLK_
        args = (randn(B, np_, H), randn(nB_, B, W_, H), randn(B, ne_, H, C), msk)
        label = f"{tag} B{B} H{H} C{C}"
        held("band_attention", f"band_attention {label}",
             band_attention_fwd(*args, 0.2), band_attention_plain(*args, 0.2))
        d_out = randn(B, np_, H, C)
        got = band_attention_bwd(*args, d_out, 0.2, index)
        ref = band_attention_bwd_plain(*args, d_out, 0.2)
        for part, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, ref):
            held("band_attention_bwd", f"band_attention_bwd {label} {part}", g, r, verbose=False)
        print(f"  band_attention_bwd {label}: max abs err so far "
              f"{max_err['band_attention_bwd']:.3e}")
        return args, d_out

    def check_spmm(tag, band, B, C, index=None):
        nB_, BLK_, W_ = band.shape
        x_ext = randn(B, nB_ * BLK_ + W_ - BLK_, C)
        label = f"{tag} {str(band.dtype)[6:]} B{B} C{C}"
        held("band_spmm", f"band_spmm {label}", band_spmm_fwd(band, x_ext),
             band_spmm_plain(band, x_ext))
        d_out = randn(B, nB_ * BLK_, C)
        held("band_spmm_bwd", f"band_spmm_bwd {label}", band_spmm_bwd(band, d_out, index),
             band_spmm_bwd_plain(band, d_out))
        return x_ext, d_out

    for B in (1, 4):                            # fixture parity runs B 1
        for H in (2, 1):
            check_attention("bigtown", mask, B, H, 128, mask_ix)
        check_spmm("bigtown", cnt, B, 128, cnt_ix)
    rng = np.random.default_rng(0)
    rmask = rng.random((3, 16, 70)) < 0.3
    rmask[-1, -5:] = False                       # fully masked (padded) rows
    rmask_t = torch.as_tensor(rmask.view(np.int8), device=dev)
    rcnt = torch.as_tensor((rmask * rng.integers(1, 4, rmask.shape)).astype(np.int8), device=dev)
    rw = torch.as_tensor((rmask * rng.random(rmask.shape)).astype(np.float32), device=dev)
    check_attention("ragged", rmask_t, 3, 2, 32)
    check_attention("ragged", rmask_t, 2, 1, 300)
    # rows with more than 32 entries: the row pass takes them 32 at a time
    wide = torch.as_tensor((rng.random((2, 16, 200)) < 0.4).view(np.int8), device=dev)
    check_attention("wide rows", wide, 2, 2, 32)
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

    # ---- 6: kernel times at the serving (B 32) and training (B 8) shapes ---
    print(f"[6] kernel times on {card}")
    nnz_mask, nnz_cnt = mask_ix.nnz, cnt_ix.nnz
    index_bytes = lambda ix: 4 * sum(  # noqa: E731
        int(getattr(ix, f).numel()) for f in ("row_ptr", "col", "t_ptr", "t_entry", "t_row"))

    def csr_of(rows_i, cols_i, vals, shape):
        return torch.sparse_coo_tensor(
            torch.as_tensor(np.stack([rows_i, cols_i]), device=dev),
            torch.as_tensor(vals.astype(np.float32), device=dev), shape).to_sparse_csr()

    blk_i, r_i, j_i = np.nonzero(bl.adj_cnt)
    vals = bl.adj_cnt[blk_i, r_i, j_i]
    csr = csr_of(blk_i * BLK + r_i, blk_i * BLK + j_i, vals, (n_pad, n_ext))
    csr_t = csr_of(blk_i * BLK + j_i, blk_i * BLK + r_i, vals, (n_ext, n_pad))
    rows = []
    for B in (bs, 8):
        for H, C in ((2, 128), (1, 128)):
            args = (randn(B, n_pad, H), randn(nB, B, W, H), randn(B, n_ext, H, C), mask)
            d_out = randn(B, n_pad, H, C)
            label = f"B{B} H{H} C{C}"
            held("band_attention", f"band_attention {label}", band_attention_fwd(*args, 0.2),
                 band_attention_plain(*args, 0.2))
            got = band_attention_bwd(*args, d_out, 0.2, mask_ix)
            ref = band_attention_bwd_plain(*args, d_out, 0.2)
            for part, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, ref):
                held("band_attention_bwd", f"band_attention_bwd {label} {part}", g, r)
            del got, ref
            # forward: a_src counted once per row of x_ext, not as its W-row windowed copy
            io = 4 * (B * n_pad * H + B * n_ext * H + B * n_ext * H * C + B * n_pad * H * C)
            rows.append(dict(
                name="band_attention", B=B, hc=H * C,
                ms=cuda_ms(lambda: band_attention_fwd(*args, 0.2), 3, 20),
                plain_ms=cuda_ms(lambda: band_attention_plain(*args, 0.2), 1, 3),
                library_ms=None, bytes=io + nB * BLK * W,
                ops=B * H * nnz_mask * (2 * C + 4),  # FMA per channel; add, LeakyReLU, exp, sum
                dense_bound_ms=2 * B * n_pad * W * H * C / PEAK_F32_S * 1e3))
            # backward: reads the forward's inputs and dO, writes the three
            # cotangents (d a_src_win is an output in window layout) and walks the index
            rows.append(dict(
                name="band_attention_bwd", B=B, hc=H * C,
                ms=cuda_ms(lambda: band_attention_bwd(*args, d_out, 0.2, mask_ix), 3, 20),
                plain_ms=cuda_ms(lambda: band_attention_bwd_plain(*args, d_out, 0.2), 1, 3),
                library_ms=None,
                bytes=io + 4 * (B * n_pad * H + nB * B * W * H + B * n_ext * H * C)
                + index_bytes(mask_ix),
                ops=B * H * nnz_mask * (4 * C + 12),  # dot and weighted sum per channel; softmax, dz
                dense_bound_ms=6 * B * n_pad * W * H * C / PEAK_F32_S * 1e3))
            del args, d_out
        C = 128
        x_ext, d_out = randn(B, n_ext, C), randn(B, n_pad, C)
        held("band_spmm", f"band_spmm int8 B{B} C{C}", band_spmm_fwd(cnt, x_ext),
             band_spmm_plain(cnt, x_ext))
        held("band_spmm_bwd", f"band_spmm_bwd int8 B{B} C{C}", band_spmm_bwd(cnt, d_out, cnt_ix),
             band_spmm_bwd_plain(cnt, d_out))
        # library yardstick: one CSR sparse-dense product over the same band
        # (forward) and over its transpose (backward); timed, never on the path
        x2d = x_ext.permute(1, 0, 2).reshape(n_ext, B * C).contiguous()
        d2d = d_out.permute(1, 0, 2).reshape(n_pad, B * C).contiguous()
        check_close(f"band_spmm B{B} vs torch.sparse.mm", band_spmm_fwd(cnt, x_ext),
                    torch.sparse.mm(csr, x2d).reshape(n_pad, B, C).permute(1, 0, 2), TOL, TOL)
        check_close(f"band_spmm_bwd B{B} vs torch.sparse.mm", band_spmm_bwd(cnt, d_out, cnt_ix),
                    torch.sparse.mm(csr_t, d2d).reshape(n_ext, B, C).permute(1, 0, 2), TOL, TOL)
        io = 4 * (B * n_ext * C + B * n_pad * C)
        rows.append(dict(
            name="band_spmm", B=B, hc=C, ms=cuda_ms(lambda: band_spmm_fwd(cnt, x_ext), 3, 20),
            plain_ms=cuda_ms(lambda: band_spmm_plain(cnt, x_ext), 1, 3),
            library_ms=cuda_ms(lambda: torch.sparse.mm(csr, x2d), 3, 20),
            bytes=io + nB * BLK * W, ops=2 * B * C * nnz_cnt,
            dense_bound_ms=2 * B * n_pad * W * C / PEAK_F32_S * 1e3))
        rows.append(dict(
            name="band_spmm_bwd", B=B, hc=C,
            ms=cuda_ms(lambda: band_spmm_bwd(cnt, d_out, cnt_ix), 3, 20),
            plain_ms=cuda_ms(lambda: band_spmm_bwd_plain(cnt, d_out), 1, 3),
            library_ms=cuda_ms(lambda: torch.sparse.mm(csr_t, d2d), 3, 20),
            bytes=io + 4 * nnz_cnt + 4 * (n_ext + 1 + 2 * nnz_cnt), ops=2 * B * C * nnz_cnt,
            dense_bound_ms=2 * B * n_pad * W * C / PEAK_F32_S * 1e3))
        del x_ext, d_out, x2d, d2d
    for r in rows:
        t_bytes, t_ops = r["bytes"] / PEAK_BYTES_S * 1e3, r["ops"] / PEAK_F32_S * 1e3
        r["bound_ms"], r["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"  {r['name']} B {r['B']} H·C {r['hc']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; nonzeros), dense-window bound {r['dense_bound_ms']:.4f} ms")
    torch.cuda.empty_cache()

    # ---- 7: training at full width ------------------------------------------
    print("[7] training: GATRes-large on bigtown through Trainer")
    tfx = np.load(os.path.join(REPO, "artifacts", "parity_train_bigtown.npz"))
    tstats = NormStats(norm_type="znorm", mean=float(tfx["stats_mean"]), std=float(tfx["stats_std"]))
    names = [k for k, _ in smodel.named_parameters()]
    per_step = {"band_attention": 50, "band_spmm": 25, "band_attention_bwd": 50, "band_spmm_bwd": 25}

    def fixture_trainer(batch_size, **kw):
        tmodel, preset = select_model("gatres_large", device=dev)
        tmodel.load_state_dict(params_from_parity_npz(npz))
        return Trainer(tmodel, preset.train_config(batch_size=batch_size, **kw), tstats, tpl,
                       device=dev)

    def one_step_grads(tr):
        graph1, x1, m1, k1 = tr._prepare(tpl, fx["x"][:, 0][None, :], tfx["mask"], None, None)
        tr.model.train()
        loss, mets, _ = tr._masked_loss_and_metrics(graph1, x1, x1, m1, k1, "train")
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        return float(loss.detach()), mets, grads

    def grads_within(label, grads, refs):
        """Each gradient: max|Δ| ≤ 1e-3·max|g_ref| + 1e-6. Returns the largest
        share of that bound any gradient used."""
        worst = 0.0
        for name, g, ref in zip(names, grads, refs):
            if not torch.isfinite(g).all():
                raise SystemExit(f"FAIL {label}: gradient of {name} is not finite")
            err, top = float((g - ref).abs().max()), float(ref.abs().max())
            if err > 1e-3 * top + 1e-6:
                raise SystemExit(f"FAIL {label}: gradient of {name} off by {err:.3e} "
                                 f"(max |g_ref| {top:.3e})")
            worst = max(worst, err / (1e-3 * top + 1e-6))
        return worst

    # (a) one step at B 1 against the JAX Trainer's loss, gradients, parameters
    tr1 = fixture_trainer(1)
    reset_launches()
    loss1, mets1, grads1 = one_step_grads(tr1)
    step_launches = read_launches()
    if step_launches != per_step:
        raise SystemExit(f"FAIL launches per train step {step_launches}, expected {per_step}")
    if abs(loss1 - float(tfx["loss"])) > 1e-4 * abs(float(tfx["loss"])):
        raise SystemExit(f"FAIL train loss {loss1!r} against the fixture's {float(tfx['loss'])!r}")
    for k, v in mets1.items():
        ref = float(tfx[f"metric_{k}"])
        if abs(float(v) - ref) > 1e-3 * abs(ref) + 1e-4:
            raise SystemExit(f"FAIL train metric {k}: {float(v)!r} against {ref!r}")
    worst = grads_within("B 1 step vs JAX", grads1,
                         [torch.as_tensor(tfx[f"grad_{k}"], device=dev) for k in names])
    print(f"  B 1 step vs the JAX Trainer ({bytes(tfx['path']).decode()} band path): loss {loss1:.7f} "
          f"against {float(tfx['loss']):.7f}; {len(names)} gradients, each within "
          f"1e-3·max|g_ref| + 1e-6, the worst at {worst:.1%} of it; launches per step {step_launches}")
    losses3 = [float(tr1.train_step(tpl, fx["x"][:, 0][None, :], mask=tfx["mask"])[0])
               for _ in range(3)]
    # An Adam step moves a parameter by up to lr = 5e-4 whatever its gradient's size. A
    # component whose gradient is rounding noise (below the gradient tolerance above) can
    # therefore differ by up to 2·lr a step; the others are held to 3e-4.
    perr = pnoise = 0.0
    for k, p in tr1.model.named_parameters():
        if f"p3_{k}" not in tfx.files:
            continue
        err = (p.detach().cpu() - torch.as_tensor(tfx[f"p3_{k}"])).abs()
        g_ref = torch.as_tensor(tfx[f"grad_{k}"]).abs()
        real = g_ref > 1e-3 * g_ref.max() + 1e-6
        perr = max(perr, float(err[real].max()) if real.any() else 0.0)
        pnoise = max(pnoise, float(err[~real].max()) if (~real).any() else 0.0)
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses3, tfx["step_losses"]))
    if perr > 3e-4 or pnoise > 3 * 2 * 5e-4 or lerr > 1e-3:
        raise SystemExit(f"FAIL after 3 Adam steps: parameters off by {perr:.3e} (atol 3e-4; "
                         f"{pnoise:.3e} where the gradient is noise, bound 3e-3), step losses by "
                         f"{lerr:.3e} relative (1e-3)")
    print(f"  3 Adam steps: losses {[round(v, 6) for v in losses3]}; lin0, lin1, blocks 0 and 24 "
          f"within {perr:.3e} of the JAX parameters ({pnoise:.3e} where the first gradient is "
          f"below its tolerance), step losses within {lerr:.3e} relative")

    # (b) the same step through the plain versions on the card
    tr1p = fixture_trainer(1)
    reset_launches()
    with bops.plain_versions():
        loss_p, _, grads_p = one_step_grads(tr1p)
    if any(read_launches().values()):
        raise SystemExit("FAIL the plain step launched a kernel")
    worst_p = grads_within("kernel step vs plain step", grads1, grads_p)
    print(f"  kernel step vs plain step on the card: loss {loss1:.7f} / {loss_p:.7f}, gradients "
          f"within the same bound, the worst at {worst_p:.1%} of it")
    del tr1, tr1p, grads1, grads_p
    torch.cuda.empty_cache()

    # (c) Trainer.fit: 2 epochs at batch 8, 32 + 16 snapshots in memory
    import tempfile

    tbs, n_train, n_val = 8, 32, 16
    field = fx["x"][:, 0][None, :]
    arr = (field + 0.1 * rng.standard_normal((n_train + n_val, n))).astype(np.float32)
    mk_ds = lambda a: WDNDataset.from_members([_Member(tpl, a, [], None)], tstats)  # noqa: E731
    epochs_log = []
    with tempfile.TemporaryDirectory() as save_dir:
        trn = fixture_trainer(tbs, epochs=2, save_path=save_dir)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        best = trn.fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: print("  " + m),
                       on_epoch_end=lambda ep, m: epochs_log.append(m))
        torch.cuda.synchronize()
        fit_launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_tr, n_ev = 2 * (n_train // tbs), 2 * (n_val // tbs)
        expect = {"band_attention": 50 * (n_tr + n_ev), "band_spmm": 25 * (n_tr + n_ev),
                  "band_attention_bwd": 50 * n_tr, "band_spmm_bwd": 25 * n_tr}
        if fit_launches != expect:
            raise SystemExit(f"FAIL fit launches {fit_launches}, expected {expect}")
        tl = [m["train_loss"] for m in epochs_log]
        vl = [m["val_loss"] for m in epochs_log]
        if len(tl) != 2 or not np.isfinite(tl + vl).all() or tl[1] >= 1.5 * tl[0]:
            raise SystemExit(f"FAIL fit diverged or stopped: train {tl}, val {vl}")
        for which in ("best", "last"):
            params, opt_state, meta = load_checkpoint(
                os.path.join(save_dir, f"{which}_gatres_large.ckpt"), trn.model.state_dict(),
                trn.opt_state_dict())
            if meta["stats"] != tstats or opt_state is None or meta["epoch"] not in (1, 2):
                raise SystemExit(f"FAIL the {which} checkpoint did not reload whole: {meta}")
        if meta["epoch"] != 2 or any(
                not torch.equal(params[k], v.cpu()) for k, v in trn.model.state_dict().items()):
            raise SystemExit("FAIL the last checkpoint does not hold the model's parameters")
    print(f"  fit: 2 epochs, batch {tbs}, {n_train} train + {n_val} val snapshots: train loss {tl}, "
          f"val loss {vl}, best epoch {best['epoch']}, {best['train_time_s']:.2f} s; launches "
          f"{fit_launches}; checkpoints written and reloaded")
    batch = arr[:tbs]
    tgen = torch.Generator().manual_seed(0)
    step_ms = cuda_ms(lambda: trn.train_step(tpl, batch, generator=tgen), 2, 8)
    peak_gb = max(peak_gb, torch.cuda.max_memory_allocated() / 1e9)
    print(f"  train step at batch {tbs}: {step_ms:.3f} ms ({tbs * tpl.n_edge / step_ms * 1e3:.0f} "
          f"edges/s), peak device memory {peak_gb:.3f} GB")
    profile_batch(lambda: trn.train_step(tpl, batch, generator=tgen), "one train step", top=14)

    replaces = {"band_attention": f"{TPU_SRC}:208", "band_spmm": f"{TPU_SRC}:1084",
                "band_attention_bwd": f"{TPU_SRC}:313", "band_spmm_bwd": f"{TPU_SRC}:1164"}
    kernels = []
    for name in wrappers:
        # headline row: B 32 (band_attention*: the H·C 256 shape); the forwards
        # count the serving run's launches, the backwards the fit's
        r = next(r for r in rows if r["name"] == name and r["B"] == bs)
        at = lambda B, hc: next(  # noqa: E731
            q["ms"] for q in rows if q["name"] == name and q["B"] == B and q["hc"] == hc)
        launches = serve_launches.get(name, fit_launches[name])
        if not launches or not fit_launches[name]:
            raise SystemExit(f"FAIL {name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gnn_pressure_estimation_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches,
            "serving_launches": serve_launches.get(name, 0), "serving_batches": n_batches,
            "launches_per_forward": per_forward.get(name, 0),
            "fit_launches": fit_launches[name], "launches_per_train_step": step_launches[name],
            "max_abs_err": max_err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dense_window_bound_ms": r["dense_bound_ms"],
            "shape": f"B {bs}, n_pad {n_pad}, W {W}, H·C {r['hc']}",
            "ms_b8": at(8, r["hc"]),
            **({"ms_hc128": at(bs, 128), "ms_b8_hc128": at(8, 128)} if r["hc"] != 128 else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
