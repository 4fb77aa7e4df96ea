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

8. The dense path at C-Town scale (``inputs/synthctown.inp``, 388 nodes): the
   four dense-mode kernels (``fused_attention``, ``fused_factored``, forward
   and backward) against their plain versions at every shape GATRes-small and
   GATRes-large run there, at B 1 and B 32, and at small ragged shapes (a
   one-way mask, rows of more than 32 entries, C past one tile); atol and
   rtol 1e-4, random cotangents, a third of the nodes zeroed so that
   a_d + a_s == 0 occurs.
9. Fixture parity: GATRes-small with the weights of
   ``artifacts/parity_train_synthctown.npz``: the serving forward per block
   and at the output against the JAX values (1e-3), exactly 30
   ``fused_factored`` launches; one B 1 train step (loss, metrics, every
   gradient, parameters after 3 Adam steps) with exactly 30 forward and 30
   backward launches; the same step through the plain versions on the card.
10. Serving: ``Inferencer`` answers 64 synthctown snapshots at batch 32 with
    GATRes-small (30 launches a forward) and GATRes-large (50), seeded
    weights; each first batch is held against the plain versions on the card.
11. Training: ``Trainer.fit`` of GATRes-small for 2 epochs at batch 32,
    mask_rate 0.95 (30 + 30 launches a step), checkpoints, a resume from the
    first epoch's checkpoint that must end bit-identical; step time (CUDA
    events), edges/s as ``bench.py`` counts them, peak memory; one GATRes-large
    step; ``torch.profiler`` splits of one serving batch and one train step.
12. ``attn_impl="softmax"``: one serving batch and one train step of
    GATRes-small through ``fused_attention`` (30 + 30 launches), held against
    the factored model with the same weights.
13. Times of the four dense kernels at B 32 beside their plain versions, the
    einsum formulation the layer would otherwise run, and their byte bounds.

14. The banded path at 23k nodes: meganet (``simgen.netgen.make_mega``, made
    from its seed; BLK 256, W 1920). The streaming-softmax band attention
    (``band_attention_flash``: out, m, Z; backward from m, Z, delta) against
    its plain version on the meganet layout at H·C 256 and 128, B 1 and B 2,
    and the window band attention (``band_attention_window``) on the bigtown
    layout at the same batches (phase 19 holds both at their serving batches);
    both also at small ragged shapes (fully masked rows, rows of more than 32
    entries, C past one tile); a third of the nodes zeroed; atol and rtol 1e-4.
15. Routing: ``batch()`` with no argument sends meganet to ``"flash"`` and
    bigtown to ``"dma"``.
16. The meganet fixture ``artifacts/parity_train_meganet.npz`` (GATRes-large
    width, the fixture's depth, weights drawn from a seed): forward, loss,
    every gradient and the parameters after 3 Adam steps against the JAX
    ``Trainer`` (its v4 Pallas kernel in interpret mode).
17. meganet, GATRes-large at full depth and width, seeded weights:
    ``Inferencer`` on 16 snapshots at batch 8 with exactly 50
    ``band_attention_flash`` and 25 ``band_spmm`` launches a forward and none
    of the v2 kernel; one train step through the kernels against the same step
    through the plain versions; the same step with ``remat=True``;
    ``Trainer.fit`` for 2 epochs at batch 2 on 8 + 4 snapshots with as many
    backward as forward launches a step and a resume that ends bit-identical;
    ms per batch and per step (CUDA events), edges/s, peak memory, profiler
    splits.
18. bigtown with ``band_attn="window"``: one serving batch (50
    ``band_attention_window`` launches) against the default route's (1e-4),
    the B 1 step of ``artifacts/parity_train_bigtown.npz``, and the same
    serving batch and a batch-8 train step timed under each of the three routes.
19. Times of the four new kernels beside their plain versions and byte bounds:
    the flash pair on meganet at B 8 (serving) and B 2 (training), the kernel
    alone at B 32; the window pair on bigtown at B 32.

The last line is ``{"ok": true, "device": {...}}``; the ``kernels`` JSON line
(all twelve kernels) and the ``nvidia-smi`` line come before it.
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
TPU_DENSE_SRC = "gnn_pressure_estimation_tpu/ops/pallas/graph_attention.py"


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


def device_ms(fn, iters: int = 20):
    """Device time of one call of ``fn`` (every kernel it launches, summed),
    from ``torch.profiler``: what the card spends, without the host's time to
    enqueue. None if the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3 if us else None


def grads_within(label: str, names, grads, refs) -> float:
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


def adam_param_errors(named_parameters, fx) -> tuple[float, float]:
    """Largest deviation of the parameters from the fixture's ``p3_*`` (after
    3 Adam steps), split in two. An Adam step moves a parameter by up to lr
    whatever its gradient's size, so a component whose first gradient is
    rounding noise (below the gradient tolerance, 1e-3·max|g_ref| + 1e-6) can
    differ by up to 2·lr a step: those are returned apart from the rest."""
    perr = pnoise = 0.0
    for k, p in named_parameters:
        if f"p3_{k}" not in fx.files:
            continue
        err = (p.detach().cpu() - torch.as_tensor(fx[f"p3_{k}"])).abs()
        g_ref = torch.as_tensor(fx[f"grad_{k}"]).abs()
        real = g_ref > 1e-3 * g_ref.max() + 1e-6
        perr = max(perr, float(err[real].max()) if real.any() else 0.0)
        pnoise = max(pnoise, float(err[~real].max()) if (~real).any() else 0.0)
    return perr, pnoise


def dense_phases(dev, card, rng, held, reset_launches, read_launches, counts):
    """Phases 8-13: the dense path on synthctown. Returns the kernel rows
    (times and bounds at B 32) and the launch counts of its runs."""
    import tempfile

    from gnn_pressure_estimation_tpu_torch.data.dataset import (
        WDNDataset, _Member, build_template, get_keep_list,
    )
    from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
    from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.models.presets import MODEL_REGISTRY, select_model
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops
    from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga
    from gnn_pressure_estimation_tpu_torch.train import Trainer, load_checkpoint
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    wn = parse_inp(os.path.join(REPO, "inputs", "synthctown.inp"))
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                            name="synthctown")
    n = tpl.n_node
    mask_np = tpl.dense_operators()["adj_sl_mask"]
    mask = torch.as_tensor(mask_np, device=dev)
    ix = tpl.dense_index().to(dev)
    nnz = ix.nnz
    print(f"[8] dense kernels vs plain versions on synthctown: n {n}, edges {tpl.n_edge}, mask "
          f"nonzeros {nnz} ({nnz / n / n:.4%} dense, longest row {ix.nbr.shape[1]})")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def operands(B, n_, H, C, zero_every=3):
        a_d, a_s = randn(B, n_, H), randn(B, n_, H)
        a_d[:, ::zero_every] = 0.0      # zeroed nodes: a_d + a_s == 0 where two of them meet
        a_s[:, ::zero_every] = 0.0
        return a_d, a_s, [randn(B, n_, H, C) for _ in range(4)]

    def check_dense(tag, msk, index, B, H, C, verbose=False):
        """All four kernels at one shape (the factored pair at D = C + 1),
        random cotangents. Returns the operands."""
        n_ = msk.shape[0]
        a_d, a_s, (v, d_out, _, _) = operands(B, n_, H, C)
        _, _, (rv, rq, g_pv, g_nq) = operands(B, n_, H, C + 1)
        label = f"{tag} B{B} H{H} C{C}"
        held("fused_attention", f"fused_attention {label}",
             ga.fused_attention_fwd(a_d, a_s, v, msk, 0.2, index),
             ga.fused_attention_plain(a_d, a_s, v, msk, 0.2), verbose)
        for part, g, r in zip(("d a_dst", "d a_src", "d v"),
                              ga.fused_attention_bwd(a_d, a_s, v, msk, d_out, 0.2, index),
                              ga.fused_attention_bwd_plain(a_d, a_s, v, msk, d_out, 0.2)):
            held("fused_attention_bwd", f"fused_attention_bwd {label} {part}", g, r, verbose)
        for part, g, r in zip(("t_pv", "t_nq"), ga.fused_factored_fwd(a_d, a_s, rv, rq, msk, index),
                              ga.fused_factored_plain(a_d, a_s, rv, rq, msk)):
            held("fused_factored", f"fused_factored {label} {part}", g, r, verbose)
        for part, g, r in zip(("d rhs_v", "d rhs_q"),
                              ga.fused_factored_bwd(a_d, a_s, msk, g_pv, g_nq, index),
                              ga.fused_factored_bwd_plain(a_d, a_s, msk, g_pv, g_nq)):
            held("fused_factored_bwd", f"fused_factored_bwd {label} {part}", g, r, verbose)
        return a_d, a_s, v, d_out, rv, rq, g_pv, g_nq

    shapes = ((2, 32), (1, 32), (2, 128), (1, 128))     # conv1, conv2 of small; of large
    for H, C in shapes:
        check_dense("synthctown", mask, ix, 1, H, C)
    # a one-way mask with rows of more than 32 entries; C past one 256-channel tile; D 34
    rmask = rng.random((70, 70)) < 0.6
    np.fill_diagonal(rmask, True)
    rmask_t = torch.as_tensor(rmask, device=dev)
    for B, H, C in ((3, 2, 5), (2, 1, 300), (2, 3, 33)):
        check_dense("ragged", rmask_t, None, B, H, C)      # index built from the mask's values
    torch.cuda.synchronize()
    print("  B 1 and ragged shapes: all within atol/rtol 1e-4")

    # ---- 9: the synthctown fixture ------------------------------------------
    print("[9] synthctown fixture: GATRes-small against the JAX values")
    npz = os.path.join(REPO, "artifacts", "parity_train_synthctown.npz")
    fx = np.load(npz)
    stats = NormStats(norm_type="znorm", mean=float(fx["stats_mean"]), std=float(fx["stats_std"]))

    def fixture_model(attn_impl="factored"):
        m = GATRes(int(fx["num_blocks"]), int(fx["nc"]), attn_impl=attn_impl)
        m.load_state_dict(params_from_parity_npz(npz))
        return m.to(dev)

    model = fixture_model().eval()
    graph = tpl.batch(1, device=dev)
    acts = {}
    hooks = [blk.register_forward_hook(lambda m, i, o, k=k: acts.__setitem__(k, o))
             for k, blk in enumerate(model.blocks)]
    reset_launches()
    with torch.inference_mode():
        out = model(torch.as_tensor(fx["x_in"], device=dev), graph)
        torch.cuda.synchronize()
    fwd_launches = read_launches()
    for h in hooks:
        h.remove()
    if fwd_launches != counts(fused_factored=30):
        raise SystemExit(f"FAIL launches per dense forward {fwd_launches}")
    block_err = max(check_close(f"synthctown block {k}", a.cpu(),
                                torch.as_tensor(fx[f"ours_act_block_{k}"]), 1e-3, 0.0, verbose=False)
                    for k, a in sorted(acts.items()))
    out_err = check_close("synthctown output", out.cpu(), torch.as_tensor(fx["ours_out"]), 1e-3, 0.0,
                          verbose=False)
    print(f"  forward vs JAX ({bytes(fx['path']).decode()} path): worst block {block_err:.3e}, output "
          f"{out_err:.3e}; launches {fwd_launches['fused_factored']}")

    names = [k for k, _ in model.named_parameters()]
    xb1 = fx["x"][:, 0][None, :]

    def fixture_step(attn_impl="factored"):
        tr = Trainer(fixture_model(attn_impl), MODEL_REGISTRY["gatres_small"].train_config(batch_size=1), stats, tpl, device=dev)
        g1, x1, m1, k1 = tr._prepare(tpl, xb1, fx["mask"], None, None)
        tr.model.train()
        loss, mets, _ = tr._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        return tr, float(loss.detach()), mets, grads

    reset_launches()
    tr1, loss1, mets1, grads1 = fixture_step()
    step_launches = read_launches()
    if step_launches != counts(fused_factored=30, fused_factored_bwd=30):
        raise SystemExit(f"FAIL launches per dense train step {step_launches}")
    if abs(loss1 - float(fx["loss"])) > 1e-4 * abs(float(fx["loss"])):
        raise SystemExit(f"FAIL train loss {loss1!r} against the fixture's {float(fx['loss'])!r}")
    for k, v in mets1.items():
        # corr and r2 of an untrained model (a nearly constant output) are small
        # differences of f32 moment sums: atol 1e-3 there, 1e-4 elsewhere
        ref, atol = float(fx[f"metric_{k}"]), 1e-3 if k in ("train_corr", "train_r2") else 1e-4
        if abs(float(v) - ref) > 1e-3 * abs(ref) + atol:
            raise SystemExit(f"FAIL train metric {k}: {float(v)!r} against {ref!r}")
    worst = grads_within("synthctown B 1 step vs JAX", names, grads1,
                         [torch.as_tensor(fx[f"grad_{k}"], device=dev) for k in names])
    losses3 = [float(tr1.train_step(tpl, xb1, mask=fx["mask"])[0]) for _ in range(3)]
    perr = max(float((p.detach().cpu() - torch.as_tensor(fx[f"p3_{k}"])).abs().max())
               for k, p in tr1.model.named_parameters() if f"p3_{k}" in fx.files)
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses3, fx["step_losses"]))
    if perr > 3e-4 or lerr > 1e-3:
        raise SystemExit(f"FAIL after 3 Adam steps: parameters off by {perr:.3e} (atol 3e-4), "
                         f"step losses by {lerr:.3e} relative (1e-3)")
    print(f"  B 1 step vs the JAX Trainer: loss {loss1:.7f} against {float(fx['loss']):.7f}; "
          f"{len(names)} gradients, each within 1e-3·max|g_ref| + 1e-6, the worst at {worst:.1%} of "
          f"it; after 3 Adam steps parameters within {perr:.3e}, step losses within {lerr:.3e} "
          f"relative; launches per step {step_launches['fused_factored']} + "
          f"{step_launches['fused_factored_bwd']}")
    reset_launches()
    with bops.plain_versions():
        _, loss_p, _, grads_p = fixture_step()
    if any(read_launches().values()):
        raise SystemExit("FAIL the plain dense step launched a kernel")
    worst_p = grads_within("dense kernel step vs plain step", names, grads1, grads_p)
    print(f"  kernel step vs plain step on the card: loss {loss1:.7f} / {loss_p:.7f}, gradients "
          f"within the same bound, the worst at {worst_p:.1%} of it")
    del tr1, grads1, grads_p

    # ---- 10: serving ---------------------------------------------------------
    print("[10] serving synthctown through Inferencer")
    sstats = NormStats(norm_type="znorm", mean=40.0, std=15.0)
    bs, n_snaps = 32, 64
    n_batches = n_snaps // bs
    snaps = rng.standard_normal((n_snaps, n)).astype(np.float32)
    serve_launches, serve_ms, models = {}, {}, {}
    for preset, per_forward in (("gatres_small", 30), ("gatres_large", 50)):
        smodel, _ = select_model(preset, device=dev, seed=0)
        models[preset] = smodel
        inf = Inferencer(smodel, sstats, device=dev)
        obs = inf.observed_indices(tpl, "random", mask_rate=0.95, seed=0)
        inf.infer(tpl, snaps, obs, scaled=True, batch_size=bs)          # warm-up
        torch.cuda.synchronize()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = inf.infer(tpl, snaps, obs, scaled=True, batch_size=bs, with_truth=True)
        end.record()
        end.synchronize()
        got = read_launches()
        if got != counts(fused_factored=n_batches * per_forward):
            raise SystemExit(f"FAIL {preset} serving launches {got}")
        if res.pred.shape != snaps.shape or not np.isfinite(res.pred).all():
            raise SystemExit(f"FAIL {preset} serving output is not a finite [S, n] field")
        with bops.plain_versions():
            ref = inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs)
        err = check_close(f"{preset} served batch vs plain versions", torch.as_tensor(res.pred[:bs]),
                          torch.as_tensor(ref.pred), 1e-3, 1e-4, verbose=False)
        serve_launches[preset] = got["fused_factored"]
        serve_ms[preset] = start.elapsed_time(end) / n_batches
        print(f"  {preset}: {n_snaps} snapshots, batch {bs}, {len(obs)} observed of {n}: "
              f"{serve_ms[preset]:.3f} ms per batch ({bs / serve_ms[preset] * 1e3:.0f} snapshots/s); "
              f"{per_forward} fused_factored launches a forward; first batch within {err:.3e} m of "
              f"the plain versions' (fields of {sstats.mean:.0f} ± {sstats.std:.0f} m)")
        profile_batch(lambda: inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs),
                      f"one {preset} serving batch", top=10)

    # ---- 11: training ----------------------------------------------------------
    print("[11] training GATRes-small on synthctown through Trainer.fit")
    tbs, n_train, n_val = 32, 128, 64
    arr = rng.standard_normal((n_train + n_val, n)).astype(np.float32)
    mk_ds = lambda a: WDNDataset.from_members([_Member(tpl, a, [], None)], sstats)  # noqa: E731

    def small_trainer(preset="gatres_small", **kw):
        m, ps = select_model(preset, device=dev, seed=0)
        return Trainer(m, ps.train_config(batch_size=tbs, mask_rate=0.95, seed=0, **kw), sstats, tpl,
                       device=dev)

    epochs_log = []
    with tempfile.TemporaryDirectory() as dir_full, tempfile.TemporaryDirectory() as dir_cut:
        trn = small_trainer(epochs=2, save_path=dir_full)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        best = trn.fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: print("  " + m),
                       on_epoch_end=lambda ep, m: epochs_log.append(m))
        torch.cuda.synchronize()
        fit_launches = read_launches()
        n_tr, n_ev = 2 * (n_train // tbs), 2 * (n_val // tbs)
        if fit_launches != counts(fused_factored=30 * (n_tr + n_ev), fused_factored_bwd=30 * n_tr):
            raise SystemExit(f"FAIL dense fit launches {fit_launches}")
        tl = [m["train_loss"] for m in epochs_log]
        vl = [m["val_loss"] for m in epochs_log]
        if len(tl) != 2 or not np.isfinite(tl + vl).all() or tl[1] >= 1.5 * tl[0]:
            raise SystemExit(f"FAIL dense fit diverged or stopped: train {tl}, val {vl}")
        params, opt_state, meta = load_checkpoint(
            os.path.join(dir_full, "last_gatres_small.ckpt"), trn.model.state_dict(),
            trn.opt_state_dict())
        if meta["epoch"] != 2 or opt_state is None or any(
                not torch.equal(params[k], v.cpu()) for k, v in trn.model.state_dict().items()):
            raise SystemExit("FAIL the last checkpoint does not hold the model's parameters")
        # one epoch, then a new trainer restores 'last' and runs the second: the
        # backwards use no atomics, so it must end where the uninterrupted run did
        small_trainer(epochs=1, save_path=dir_cut).fit(
            mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: None)
        resumed = small_trainer(epochs=2, save_path=dir_cut)
        resumed.restore(os.path.join(dir_cut, "last_gatres_small.ckpt"))
        resumed.fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: None)
        torch.cuda.synchronize()
        sa, sb = trn.opt_state_dict(), resumed.opt_state_dict()
        same = (all(torch.equal(a, b) for a, b in zip(trn.model.state_dict().values(),
                                                     resumed.model.state_dict().values()))
                and sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa))
        if not same:
            raise SystemExit("FAIL the resumed dense run did not end bit-identical")
    print(f"  fit: 2 epochs, batch {tbs}, {n_train} train + {n_val} val snapshots: train loss {tl}, "
          f"val loss {vl}, best epoch {best['epoch']}, {best['train_time_s']:.2f} s; launches "
          f"{fit_launches['fused_factored']} forward, {fit_launches['fused_factored_bwd']} backward; "
          f"checkpoint reloaded; resumed from epoch 1 and ended bit-identical")
    batch = arr[:tbs]
    tgen = torch.Generator().manual_seed(0)
    train_ms, train_peak = {}, {}
    for preset, blocks in (("gatres_small", 15), ("gatres_large", 25)):
        tr = trn if preset == "gatres_small" else small_trainer(preset)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        tr.train_step(tpl, batch, generator=tgen)
        torch.cuda.synchronize()
        got = read_launches()
        if got != counts(fused_factored=2 * blocks, fused_factored_bwd=2 * blocks):
            raise SystemExit(f"FAIL {preset} launches per train step {got}")
        train_ms[preset] = cuda_ms(lambda: tr.train_step(tpl, batch, generator=tgen), 5, 30)
        train_peak[preset] = torch.cuda.max_memory_allocated() / 1e9
        edges = tbs * blocks * (2 * (tpl.n_edge + n) + tpl.n_edge)
        print(f"  {preset} train step at batch {tbs}: {train_ms[preset]:.3f} ms "
              f"({edges / train_ms[preset] * 1e3:.0f} message edges/s: batch · blocks · "
              f"(2·(E + N) + E)), peak device memory {train_peak[preset]:.3f} GB; launches "
              f"{2 * blocks} + {2 * blocks}")
        profile_batch(lambda: tr.train_step(tpl, batch, generator=tgen),
                      f"one {preset} train step", top=14)
        del tr
    del trn, resumed

    # ---- 12: attn_impl="softmax" ------------------------------------------------
    print('[12] attn_impl="softmax": GATRes-small through fused_attention')
    soft = GATRes(15, 32, attn_impl="softmax")
    soft.load_state_dict(models["gatres_small"].state_dict())
    inf_s = Inferencer(soft, sstats, device=dev)
    inf_f = Inferencer(models["gatres_small"], sstats, device=dev)
    obs = inf_s.observed_indices(tpl, "random", mask_rate=0.95, seed=0)
    reset_launches()
    pred_s = inf_s.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs).pred
    soft_fwd = read_launches()
    if soft_fwd != counts(fused_attention=30):
        raise SystemExit(f"FAIL softmax serving launches {soft_fwd}")
    with bops.plain_versions():
        pred_sp = inf_s.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs).pred
    err = check_close("softmax served batch vs plain versions", torch.as_tensor(pred_s),
                      torch.as_tensor(pred_sp), 1e-3, 1e-4, verbose=False)
    pred_f = inf_f.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs).pred
    print(f"  serving batch: 30 fused_attention launches; within {err:.3e} m of the plain versions' "
          f"and {float(np.abs(pred_s - pred_f).max()):.3e} m of the factored model's")
    smask = rng.random((tbs, n)).argsort(1) < int(n * 0.95)

    def soft_step():
        m = GATRes(15, 32, attn_impl="softmax")
        m.load_state_dict(models["gatres_small"].state_dict())
        tr = Trainer(m, MODEL_REGISTRY["gatres_small"].train_config(batch_size=tbs), sstats, tpl,
                     device=dev)
        g1, x1, m1, k1 = tr._prepare(tpl, batch, smask.reshape(-1), None, None)
        tr.model.train()
        loss, _, _ = tr._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        return tr, float(loss.detach()), grads

    reset_launches()
    tr_s, loss_s, grads_s = soft_step()
    soft_step_launches = read_launches()
    if soft_step_launches != counts(fused_attention=30, fused_attention_bwd=30):
        raise SystemExit(f"FAIL softmax train step launches {soft_step_launches}")
    with bops.plain_versions():
        _, loss_sp, grads_sp = soft_step()
    worst_s = grads_within("softmax kernel step vs plain step", names, grads_s, grads_sp)
    soft_ms = cuda_ms(lambda: tr_s.train_step(tpl, batch, generator=tgen), 5, 30)
    print(f"  train step at batch {tbs}: 30 + 30 launches; loss {loss_s:.7f} / {loss_sp:.7f} (plain), "
          f"gradients within 1e-3·max|g_ref| + 1e-6 of the plain step's, the worst at {worst_s:.1%}; "
          f"{soft_ms:.3f} ms per step")
    del tr_s, grads_s, grads_sp

    # ---- 13: kernel times at B 32 -------------------------------------------------
    print(f"[13] dense kernel times at B {bs} on {card}")

    def factored_einsum(a_d, a_s, vx, qx):
        """The formulation the layer would run without the kernel: the gate
        materialised, one einsum over it and one over the static mask."""
        s_ = a_d[:, :, None, :] + a_s[:, None, :, :]
        gate = (mask[None, :, :, None] & (s_ >= 0)).to(vx.dtype)
        t_adj = torch.einsum("ij,bjhc->bihc", mask.to(vx.dtype), qx)
        t_p = torch.einsum("bijh,bjhc->bihc", gate, torch.cat([vx, qx], dim=-1))
        return t_p[..., : vx.shape[-1]], t_adj - t_p[..., vx.shape[-1]:]

    ix_bytes = {"fwd": 4 * (n + 1 + nnz), "bwd": 4 * (n + 1 + 2 * nnz)}
    rows = []
    for H, C in shapes:
        a_d, a_s, v, d_out, rv, rq, g_pv, g_nq = check_dense("synthctown", mask, ix, bs, H, C)
        a_bytes, D = 4 * 2 * bs * n * H, C + 1
        wide = lambda k, w: 4 * k * bs * n * H * w  # noqa: E731  (k tensors [B, n, H, w])
        for name, fn, plain, einsum, nbytes, ops in (
            ("fused_attention", lambda: ga.fused_attention_fwd(a_d, a_s, v, mask, 0.2, ix),
             lambda: ga.fused_attention_plain(a_d, a_s, v, mask, 0.2), None,
             a_bytes + wide(2, C) + ix_bytes["fwd"], bs * H * nnz * (2 * C + 6)),
            ("fused_attention_bwd",
             lambda: ga.fused_attention_bwd(a_d, a_s, v, mask, d_out, 0.2, ix),
             lambda: ga.fused_attention_bwd_plain(a_d, a_s, v, mask, d_out, 0.2), None,
             2 * a_bytes + wide(3, C) + ix_bytes["fwd"] + ix_bytes["bwd"],
             bs * H * nnz * (4 * C + 14)),
            ("fused_factored", lambda: ga.fused_factored_fwd(a_d, a_s, rv, rq, mask, ix),
             lambda: ga.fused_factored_plain(a_d, a_s, rv, rq, mask),
             lambda: factored_einsum(a_d, a_s, rv, rq),
             a_bytes + wide(4, D) + ix_bytes["fwd"], bs * H * nnz * (D + 1)),
            ("fused_factored_bwd", lambda: ga.fused_factored_bwd(a_d, a_s, mask, g_pv, g_nq, ix),
             lambda: ga.fused_factored_bwd_plain(a_d, a_s, mask, g_pv, g_nq), None,
             a_bytes + wide(4, D) + ix_bytes["bwd"], bs * H * nnz * (D + 1)),
        ):
            t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
            r = dict(name=name, H=H, C=C, ms=cuda_ms(fn, 5, 50), device_ms=device_ms(fn),
                     plain_ms=cuda_ms(plain, 2, 5),
                     einsum_ms=cuda_ms(einsum, 2, 5) if einsum else None, library_ms=None,
                     bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations")
            rows.append(r)
            dms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
            ein = "" if einsum is None else f", einsum formulation {r['einsum_ms']:.4f} ms"
            print(f"  {name} H {H} C {C}: {r['ms']:.4f} ms a call (CUDA events over 50 calls of the "
                  f"wrapper), {dms} on the device, plain {r['plain_ms']:.4f} ms{ein}, library none "
                  f"(no PyTorch call computes a batched gate or mask over an n×n pattern), bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}, {nbytes / 1e6:.2f} MB)")
    return dict(
        rows=rows, nnz=nnz, n=n, serve_launches=serve_launches, serve_ms=serve_ms,
        fit_launches=fit_launches, train_ms=train_ms, train_peak=train_peak, soft_ms=soft_ms,
        soft_launches={"fused_attention": soft_fwd["fused_attention"],
                       "fused_attention_bwd": soft_step_launches["fused_attention_bwd"]})



def mega_phases(dev, card, rng, held, reset_launches, read_launches, counts, big):
    """Phases 14-19: the banded path at 23k nodes (meganet) through the
    streaming-softmax band attention, and bigtown through the window band
    attention. ``big`` carries the bigtown template, fixtures and layout.
    Returns the kernel rows and the launch counts of its runs."""
    import tempfile

    from gnn_pressure_estimation_tpu_torch.data.dataset import (
        WDNDataset, _Member, build_template, get_keep_list,
    )
    from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.models.presets import MODEL_REGISTRY, select_model
    from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops
    from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_mega
    from gnn_pressure_estimation_tpu_torch.train import Trainer
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    t0 = time.perf_counter()
    wn = make_mega()
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                            name="meganet")
    n = tpl.n_node
    bl = tpl.band_layout()
    nB, BLK, W = bl.adj_mask.shape
    n_pad, n_ext = bl.n_pad, bl.n_pad + W - BLK
    mask = torch.as_tensor(bl.adj_mask.view(np.int8), device=dev)
    ix = tpl.band_index("adj_mask").to(dev)
    print(f"[14] meganet: n {n}, edges {tpl.n_edge}, nB {nB}, BLK {BLK}, W {W}, n_pad {n_pad}, "
          f"n_ext {n_ext}, mask nonzeros {ix.nnz} ({bl.adj_mask.mean():.4%} dense), "
          f"{int(ix.empty_row.shape[0])} padded rows; generated, laid out and indexed on the host "
          f"in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def operands(msk, B, H, C):
        """a_dst, a_src_win, x_ext, d_out; a third of the nodes zeroed, so that
        a_dst + a_src == 0 occurs."""
        nB_, BLK_, W_ = msk.shape
        np_, ne_ = nB_ * BLK_, nB_ * BLK_ + W_ - BLK_
        a_dst, a_src = randn(B, np_, H), randn(nB_, B, W_, H)
        a_dst[:, ::3] = 0.0
        a_src[:, :, ::3] = 0.0
        return a_dst, a_src, randn(B, ne_, H, C), randn(B, np_, H, C)

    def check_flash(tag, msk, index, B, H, C, verbose=False):
        a_dst, a_src, x_ext, d_out = operands(msk, B, H, C)
        label = f"{tag} B{B} H{H} C{C}"
        got = ba.band_attention_flash_fwd(a_dst, a_src, x_ext, msk, 0.2, index)
        ref = ba.band_attention_flash_plain(a_dst, a_src, x_ext, msk, 0.2)
        for part, g, r in zip(("out", "m", "Z"), got, ref):
            held("band_attention_flash", f"band_attention_flash {label} {part}", g, r, verbose)
        out, m, Z = ref
        delta = (d_out * out).sum(dim=-1)
        got = ba.band_attention_flash_bwd(a_dst, a_src, x_ext, msk, m, Z, delta, d_out, 0.2, index)
        ref = ba.band_attention_flash_bwd_plain(a_dst, a_src, x_ext, msk, m, Z, delta, d_out, 0.2)
        for part, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, ref):
            held("band_attention_flash_bwd", f"band_attention_flash_bwd {label} {part}", g, r,
                 verbose)
        return a_dst, a_src, x_ext, d_out, m, Z, delta

    def check_window(tag, msk, index, B, H, C, verbose=False):
        a_dst, a_src, x_ext, d_out = operands(msk, B, H, C)
        x_win = bops.band_windows_ext(x_ext, *msk.shape)
        del x_ext
        label = f"{tag} B{B} H{H} C{C}"
        held("band_attention_window", f"band_attention_window {label}",
             ba.band_attention_window_fwd(a_dst, a_src, x_win, msk, 0.2, index),
             ba.band_attention_window_plain(a_dst, a_src, x_win, msk, 0.2), verbose)
        got = ba.band_attention_window_bwd(a_dst, a_src, x_win, msk, d_out, 0.2, index)
        ref = ba.band_attention_window_bwd_plain(a_dst, a_src, x_win, msk, d_out, 0.2)
        for part, g, r in zip(("d a_dst", "d a_src_win", "d x_win"), got, ref):
            held("band_attention_window_bwd", f"band_attention_window_bwd {label} {part}", g, r,
                 verbose)
        return a_dst, a_src, x_win, d_out

    # B 1 is the batch of the fixture steps (phases 16 and 18), B 2 of the meganet
    # train step; the serving batches are held in phase 19, before they are timed
    for B in (1, 2):
        for H in (2, 1):
            check_flash("meganet", mask, ix, B, H, 128, verbose=True)
            check_window("bigtown", big["mask"], big["mask_ix"], B, H, 128, verbose=True)
    rmask = rng.random((3, 16, 70)) < 0.3
    rmask[-1, -5:] = False                       # fully masked (padded) rows
    wide = rng.random((2, 16, 200)) < 0.4        # rows of ~80 entries: three chunks of 32
    for m_np in (rmask, wide):
        m_t = torch.as_tensor(m_np.view(np.int8), device=dev)
        for B, H, C in ((3, 2, 32), (2, 1, 300), (2, 3, 33)):
            check_flash("ragged", m_t, None, B, H, C)      # index built from the mask's values
            check_window("ragged", m_t, None, B, H, C)
    torch.cuda.synchronize()
    print("  ragged shapes: all within atol/rtol 1e-4")

    # ---- 15: routing ------------------------------------------------------------
    routes = {"meganet": tpl.batch(1, device=dev).band_attn,
              "bigtown": big["tpl"].batch(1, device=dev).band_attn}
    if routes != {"meganet": "flash", "bigtown": "dma"}:
        raise SystemExit(f"FAIL routing {routes}")
    print(f"[15] routing with no argument: {routes}")

    # ---- 16: the meganet fixture ------------------------------------------------
    npz = os.path.join(REPO, "artifacts", "parity_train_meganet.npz")
    fx = np.load(npz)
    depth = int(fx["num_blocks"])
    print(f"[16] meganet fixture: GATRes nc {int(fx['nc'])}, {depth} blocks, against the JAX values "
          f"({bytes(fx['path']).decode()} path)")
    stats = NormStats(norm_type="znorm", mean=float(fx["stats_mean"]), std=float(fx["stats_std"]))

    def fixture_model():
        m = GATRes(depth, int(fx["nc"]), attn_impl="factored")
        m.load_state_dict(params_from_parity_npz(npz))
        return m.to(dev)

    model = fixture_model().eval()
    graph = tpl.batch(1, device=dev)
    acts = {}
    hooks = [blk.register_forward_hook(lambda m, i, o, k=k: acts.__setitem__(k, o))
             for k, blk in enumerate(model.blocks)]
    reset_launches()
    with torch.inference_mode():
        out = graph.unpack_nodes(
            model(graph.pack_nodes(torch.as_tensor(fx["x_in"], device=dev), n), graph), n)
        torch.cuda.synchronize()
    got = read_launches()
    for h in hooks:
        h.remove()
    if got != counts(band_attention_flash=2 * depth, band_spmm=depth):
        raise SystemExit(f"FAIL launches per meganet fixture forward {got}")
    out_err = check_close("meganet fixture output", out.cpu(), torch.as_tensor(fx["ours_out"]),
                          1e-3, 0.0, verbose=False)
    real = [graph.unpack_nodes(acts[k], n) for k in range(depth)]
    amax = np.array([float(a.abs().max()) for a in real])
    mean = np.array([float(a.double().mean()) for a in real])
    stat_err = max(np.abs(amax - fx["block_absmax"]).max(), np.abs(mean - fx["block_mean"]).max())
    if stat_err > 1e-3:
        raise SystemExit(f"FAIL meganet block statistics off by {stat_err:.3e}")
    print(f"  forward vs JAX: output within {out_err:.3e}, per-block |act| max and mean within "
          f"{stat_err:.3e}; launches {got['band_attention_flash']} + {got['band_spmm']}")
    names = [k for k, _ in model.named_parameters()]
    xb1 = fx["x"][:, 0][None, :]

    def fixture_step():
        tr = Trainer(fixture_model(), MODEL_REGISTRY["gatres_large"].train_config(batch_size=1),
                     stats, tpl, device=dev)
        g1, x1, m1, k1 = tr._prepare(tpl, xb1, fx["mask"], None, None)
        tr.model.train()
        loss, mets, _ = tr._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        return tr, float(loss.detach()), mets, grads

    reset_launches()
    tr1, loss1, mets1, grads1 = fixture_step()
    got = read_launches()
    if got != counts(band_attention_flash=2 * depth, band_spmm=depth,
                     band_attention_flash_bwd=2 * depth, band_spmm_bwd=depth):
        raise SystemExit(f"FAIL launches per meganet fixture step {got}")
    if abs(loss1 - float(fx["loss"])) > 1e-4 * abs(float(fx["loss"])):
        raise SystemExit(f"FAIL train loss {loss1!r} against the fixture's {float(fx['loss'])!r}")
    for k, v in mets1.items():
        ref, atol = float(fx[f"metric_{k}"]), 1e-3 if k in ("train_corr", "train_r2") else 1e-4
        if abs(float(v) - ref) > 1e-3 * abs(ref) + atol:
            raise SystemExit(f"FAIL train metric {k}: {float(v)!r} against {ref!r}")
    worst = grads_within("meganet B 1 step vs JAX", names, grads1,
                         [torch.as_tensor(fx[f"grad_{k}"], device=dev) for k in names])
    losses3 = [float(tr1.train_step(tpl, xb1, mask=fx["mask"])[0]) for _ in range(3)]
    perr, pnoise = adam_param_errors(tr1.model.named_parameters(), fx)
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses3, fx["step_losses"]))
    if perr > 3e-4 or pnoise > 3 * 2 * 5e-4 or lerr > 1e-3:
        raise SystemExit(f"FAIL after 3 Adam steps: parameters off by {perr:.3e} (atol 3e-4; "
                         f"{pnoise:.3e} where the gradient is noise, bound 3e-3), step losses by "
                         f"{lerr:.3e} relative (1e-3)")
    print(f"  B 1 step vs the JAX Trainer: loss {loss1:.7f} against {float(fx['loss']):.7f}; "
          f"{len(names)} gradients, each within 1e-3·max|g_ref| + 1e-6, the worst at {worst:.1%} of "
          f"it; after 3 Adam steps parameters within {perr:.3e} ({pnoise:.3e} where the first "
          f"gradient is below its tolerance), step losses within {lerr:.3e} relative")
    del tr1, grads1, model, acts, real
    torch.cuda.empty_cache()

    # ---- 17: meganet at full depth and width ---------------------------------
    print("[17] meganet, GATRes-large (25 blocks, nc 128), seeded weights")
    sstats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    smodel, preset = select_model("gatres_large", device=dev, seed=0)
    inf = Inferencer(smodel, sstats, device=dev)
    bs, n_snaps = 8, 16
    n_batches = n_snaps // bs
    snaps = rng.standard_normal((n_snaps, n)).astype(np.float32)
    obs = inf.observed_indices(tpl, "random", mask_rate=0.95, seed=0)
    inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = inf.infer(tpl, snaps, obs, scaled=True, batch_size=bs, with_truth=True)
    end.record()
    end.synchronize()
    serve_launches = read_launches()
    if serve_launches != counts(band_attention_flash=n_batches * 50, band_spmm=n_batches * 25):
        raise SystemExit(f"FAIL meganet serving launches {serve_launches}")
    if res.pred.shape != snaps.shape or not np.isfinite(res.pred).all():
        raise SystemExit("FAIL meganet serving output is not a finite [S, n] field")
    serve_ms = start.elapsed_time(end) / n_batches
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    with bops.plain_versions():
        ref = inf.infer(tpl, snaps[:2], obs, scaled=True, batch_size=2)
    got2 = inf.infer(tpl, snaps[:2], obs, scaled=True, batch_size=2)
    err = check_close("meganet served fields vs plain versions", torch.as_tensor(got2.pred),
                      torch.as_tensor(ref.pred), 1e-3, 1e-4, verbose=False)
    print(f"  serving: {n_snaps} snapshots, batch {bs}, {len(obs)} observed of {n}: {serve_ms:.3f} ms "
          f"per batch ({bs / serve_ms * 1e3:.1f} snapshots/s, "
          f"{bs * tpl.n_edge / serve_ms * 1e3:.0f} edges/s), peak device memory {serve_peak:.3f} GB; "
          f"50 band_attention_flash + 25 band_spmm launches a forward, 0 of band_attention; two "
          f"fields within {err:.3e} m of the plain versions'")
    profile_batch(lambda: inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs),
                  "one meganet serving batch", top=10)

    tbs, n_train, n_val = 2, 8, 4
    arr = rng.standard_normal((n_train + n_val, n)).astype(np.float32)
    tmask = (rng.random((tbs, n)).argsort(1) < int(n * 0.95)).reshape(-1)
    pnames = [k for k, _ in smodel.named_parameters()]

    def mega_trainer(remat=False, **kw):
        m = GATRes(25, 128, attn_impl="factored", remat=remat)
        m.load_state_dict(smodel.state_dict())
        return Trainer(m, preset.train_config(batch_size=tbs, mask_rate=0.95, seed=0, **kw), sstats,
                       tpl, device=dev)

    def one_step(remat=False):
        tr = mega_trainer(remat)
        g1, x1, m1, k1 = tr._prepare(tpl, arr[:tbs], tmask, None, None)
        tr.model.train()
        torch.cuda.reset_peak_memory_stats()
        loss, _, _ = tr._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        return float(loss.detach()), grads, torch.cuda.max_memory_allocated() / 1e9

    per_step = counts(band_attention_flash=50, band_spmm=25, band_attention_flash_bwd=50,
                      band_spmm_bwd=25)
    reset_launches()
    loss_k, grads_k, peak_k = one_step()
    step_launches = read_launches()
    if step_launches != per_step:
        raise SystemExit(f"FAIL launches per meganet train step {step_launches}")
    with bops.plain_versions():
        loss_p, grads_p, _ = one_step()
    worst_p = grads_within("meganet kernel step vs plain step", pnames, grads_k, grads_p)
    reset_launches()
    loss_r, grads_r, peak_r = one_step(remat=True)
    remat_launches = read_launches()
    if remat_launches != counts(band_attention_flash=100, band_spmm=50,
                                band_attention_flash_bwd=50, band_spmm_bwd=25):
        raise SystemExit(f"FAIL launches per remat step {remat_launches}")
    if not all(torch.equal(a, b) for a, b in zip(grads_k, grads_r)):
        raise SystemExit("FAIL the remat step's gradients differ from the plain-autograd step's")
    print(f"  train step at batch {tbs}: kernels vs plain versions on the card: loss {loss_k:.7f} / "
          f"{loss_p:.7f}, {len(pnames)} gradients within 1e-3·max|g_ref| + 1e-6, the worst at "
          f"{worst_p:.1%}; launches {step_launches['band_attention_flash']} + "
          f"{step_launches['band_spmm']} forward, {step_launches['band_attention_flash_bwd']} + "
          f"{step_launches['band_spmm_bwd']} backward; remat=True: the same gradients to the bit, "
          f"peak {peak_r:.3f} GB against {peak_k:.3f} GB, 100 + 50 forward launches")
    del grads_k, grads_p, grads_r
    torch.cuda.empty_cache()

    mk_ds = lambda a: WDNDataset.from_members([_Member(tpl, a, [], None)], sstats)  # noqa: E731
    epochs_log = []
    with tempfile.TemporaryDirectory() as dir_full, tempfile.TemporaryDirectory() as dir_cut:
        trn = mega_trainer(epochs=2, save_path=dir_full)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        best = trn.fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: print("  " + m),
                       on_epoch_end=lambda ep, m: epochs_log.append(m))
        torch.cuda.synchronize()
        fit_launches = read_launches()
        fit_peak = torch.cuda.max_memory_allocated() / 1e9
        n_tr, n_ev = 2 * (n_train // tbs), 2 * (n_val // tbs)
        expect = counts(band_attention_flash=50 * (n_tr + n_ev), band_spmm=25 * (n_tr + n_ev),
                        band_attention_flash_bwd=50 * n_tr, band_spmm_bwd=25 * n_tr)
        if fit_launches != expect:
            raise SystemExit(f"FAIL meganet fit launches {fit_launches}, expected {expect}")
        tl = [m["train_loss"] for m in epochs_log]
        vl = [m["val_loss"] for m in epochs_log]
        if len(tl) != 2 or not np.isfinite(tl + vl).all() or tl[1] >= 1.5 * tl[0]:
            raise SystemExit(f"FAIL meganet fit diverged or stopped: train {tl}, val {vl}")
        mega_trainer(epochs=1, save_path=dir_cut).fit(
            mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: None)
        resumed = mega_trainer(epochs=2, save_path=dir_cut)
        resumed.restore(os.path.join(dir_cut, "last_gatres_large.ckpt"))
        resumed.fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: None)
        torch.cuda.synchronize()
        sa, sb = trn.opt_state_dict(), resumed.opt_state_dict()
        same = (all(torch.equal(a, b) for a, b in zip(trn.model.state_dict().values(),
                                                     resumed.model.state_dict().values()))
                and sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa))
        if not same:
            raise SystemExit("FAIL the resumed meganet run did not end bit-identical")
    del resumed
    batch = arr[:tbs]
    tgen = torch.Generator().manual_seed(0)
    step_ms = cuda_ms(lambda: trn.train_step(tpl, batch, generator=tgen), 2, 8)
    fit_peak = max(fit_peak, torch.cuda.max_memory_allocated() / 1e9)
    print(f"  fit: 2 epochs, batch {tbs}, {n_train} train + {n_val} val snapshots: train loss {tl}, "
          f"val loss {vl}, best epoch {best['epoch']}, {best['train_time_s']:.2f} s; launches "
          f"{fit_launches['band_attention_flash']} + {fit_launches['band_spmm']} forward, "
          f"{fit_launches['band_attention_flash_bwd']} + {fit_launches['band_spmm_bwd']} backward; "
          f"resumed from epoch 1 and ended bit-identical")
    print(f"  train step at batch {tbs}: {step_ms:.3f} ms ({tbs * tpl.n_edge / step_ms * 1e3:.0f} "
          f"edges/s), peak device memory {fit_peak:.3f} GB")
    profile_batch(lambda: trn.train_step(tpl, batch, generator=tgen), "one meganet train step",
                  top=14)
    del trn, inf, smodel
    torch.cuda.empty_cache()

    # ---- 18: bigtown through the window route ----------------------------------
    print('[18] bigtown with band_attn="window"')
    btpl, bnpz = big["tpl"], big["npz"]
    wmodel, wpreset = select_model("gatres_large", device=dev)
    wmodel.load_state_dict(params_from_parity_npz(bnpz))
    bstats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    wbs = 32
    wsnaps = (big["x"][:, 0][None, :] + 0.1 * rng.standard_normal((wbs, btpl.n_node))
              ).astype(np.float32)
    inf_w = Inferencer(wmodel, bstats, device=dev, band_attn="window")
    inf_d = Inferencer(wmodel, bstats, device=dev)
    wobs = inf_w.observed_indices(btpl, "random", mask_rate=0.95, seed=0)
    inf_w.infer(btpl, wsnaps, wobs, scaled=True, batch_size=wbs)           # warm-up
    torch.cuda.synchronize()
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pred_w = inf_w.infer(btpl, wsnaps, wobs, scaled=True, batch_size=wbs).pred
    end.record()
    end.synchronize()
    window_serve = read_launches()
    if window_serve != counts(band_attention_window=50, band_spmm=25):
        raise SystemExit(f"FAIL window serving launches {window_serve}")
    window_serve_ms = start.elapsed_time(end)
    pred_d = inf_d.infer(btpl, wsnaps, wobs, scaled=True, batch_size=wbs).pred
    werr = check_close("window served batch vs the default route", torch.as_tensor(pred_w),
                       torch.as_tensor(pred_d), 1e-4, 1e-4, verbose=False)
    print(f"  serving batch of {wbs}: {window_serve_ms:.3f} ms, 50 band_attention_window + 25 "
          f"band_spmm launches; within {werr:.3e} m of the default (dma) route's")
    # the same batch, and a train step at batch 8, under each route in turn: what
    # the routing rule costs or saves on this layout
    rbs = 8
    rbatch = wsnaps[:rbs]
    route_ms = {}
    for route in ("dma", "flash", "window", "dma"):
        inf_r = Inferencer(wmodel, bstats, device=dev, band_attn=route)
        pred_r = inf_r.infer(btpl, wsnaps, wobs, scaled=True, batch_size=wbs).pred
        check_close(f"bigtown served batch under {route!r} vs the default route",
                    torch.as_tensor(pred_r), torch.as_tensor(pred_d), 1e-4, 1e-4, verbose=False)
        serve = cuda_ms(lambda: inf_r.infer(btpl, wsnaps, wobs, scaled=True, batch_size=wbs), 1, 3)
        rmodel, _ = select_model("gatres_large", device=dev)
        rmodel.load_state_dict(wmodel.state_dict())
        trr = Trainer(rmodel, wpreset.train_config(batch_size=rbs, band_attn=route), bstats, btpl,
                      device=dev)
        rgen = torch.Generator().manual_seed(0)
        step = cuda_ms(lambda: trr.train_step(btpl, rbatch, generator=rgen), 2, 5)
        route_ms.setdefault(route, []).append((serve, step))
        del inf_r, trr, rmodel
        torch.cuda.empty_cache()
    for route, runs in route_ms.items():
        print(f"  bigtown under band_attn={route!r}: " + "; ".join(
            f"serving batch of {wbs} {a:.3f} ms, train step at batch {rbs} {b:.3f} ms"
            for a, b in runs))
    tfx = big["tfx"]
    tstats = NormStats(norm_type="znorm", mean=float(tfx["stats_mean"]), std=float(tfx["stats_std"]))
    tmodel, _ = select_model("gatres_large", device=dev)
    tmodel.load_state_dict(params_from_parity_npz(bnpz))
    trw = Trainer(tmodel, wpreset.train_config(batch_size=1, band_attn="window"), tstats, btpl,
                  device=dev)
    g1, x1, m1, k1 = trw._prepare(btpl, big["x"][:, 0][None, :], tfx["mask"], None, None)
    trw.model.train()
    reset_launches()
    loss_w, _, _ = trw._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
    grads_w = torch.autograd.grad(loss_w, list(trw.model.parameters()))
    torch.cuda.synchronize()
    window_step = read_launches()
    if window_step != counts(band_attention_window=50, band_spmm=25, band_attention_window_bwd=50,
                             band_spmm_bwd=25):
        raise SystemExit(f"FAIL window train step launches {window_step}")
    loss_w = float(loss_w.detach())
    if abs(loss_w - float(tfx["loss"])) > 1e-4 * abs(float(tfx["loss"])):
        raise SystemExit(f"FAIL window train loss {loss_w!r} against {float(tfx['loss'])!r}")
    wnames = [k for k, _ in tmodel.named_parameters()]
    worst_w = grads_within("window B 1 step vs JAX", wnames, grads_w,
                           [torch.as_tensor(tfx[f"grad_{k}"], device=dev) for k in wnames])
    print(f"  B 1 step vs the JAX Trainer's fixture: loss {loss_w:.7f} against "
          f"{float(tfx['loss']):.7f}; {len(wnames)} gradients within their bound, the worst at "
          f"{worst_w:.1%}; launches 50 + 25 forward, 50 + 25 backward")
    del trw, grads_w, inf_w, inf_d, wmodel, tmodel
    torch.cuda.empty_cache()

    # ---- 19: kernel times ---------------------------------------------------------
    print(f"[19] times of the flash kernels (meganet) and the window kernels (bigtown) on {card}")
    rows = []

    def bound(r):
        t_bytes, t_ops = r["bytes"] / PEAK_BYTES_S * 1e3, r["ops"] / PEAK_F32_S * 1e3
        r["bound_ms"], r["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        r["library_ms"] = None
        rows.append(r)
        print(f"  {r['name']} {r['net']} B {r['B']} H·C {r['hc']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library none (no PyTorch call computes a masked softmax over "
              f"band windows), bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['bytes'] / 1e6:.1f} MB)")

    f_ix = 4 * (n_pad + 1 + ix.nnz)                       # row_ptr, col
    b_ix = 4 * (n_pad + 1 + n_ext + 1 + 2 * ix.nnz)       # row_ptr, t_ptr, t_entry, t_row
    v2_ms = {}
    for B in (bs, tbs):
        for H, C in ((2, 128), (1, 128)):
            a_dst, a_src, x_ext, d_out, m, Z, delta = check_flash("meganet", mask, ix, B, H, C)
            # a_src counted once per extended row, not as its windowed copy
            small, wide_ = 4 * B * n_pad * H, 4 * B * H * C
            bound(dict(
                name="band_attention_flash", net="meganet", B=B, hc=H * C,
                ms=cuda_ms(lambda: ba.band_attention_flash_fwd(a_dst, a_src, x_ext, mask, 0.2, ix), 3, 20),
                plain_ms=cuda_ms(lambda: ba.band_attention_flash_plain(a_dst, a_src, x_ext, mask, 0.2), 1, 2),
                bytes=3 * small + 4 * B * n_ext * H + wide_ * (n_ext + n_pad) + f_ix,
                ops=B * H * ix.nnz * (2 * C + 8)))
            bound(dict(
                name="band_attention_flash_bwd", net="meganet", B=B, hc=H * C,
                ms=cuda_ms(lambda: ba.band_attention_flash_bwd(
                    a_dst, a_src, x_ext, mask, m, Z, delta, d_out, 0.2, ix), 3, 20),
                plain_ms=cuda_ms(lambda: ba.band_attention_flash_bwd_plain(
                    a_dst, a_src, x_ext, mask, m, Z, delta, d_out, 0.2), 1, 2),
                bytes=5 * small + 4 * B * n_ext * H + 4 * nB * B * W * H
                + wide_ * (2 * n_ext + n_pad) + b_ix,
                ops=B * H * ix.nnz * (4 * C + 12)))
            if B == bs:
                # the whole-window (v2) kernels on the same inputs: a mask scan against a list walk
                v2_ms[H * C] = (
                    cuda_ms(lambda: ba.band_attention_fwd(a_dst, a_src, x_ext, mask, 0.2), 3, 10),
                    cuda_ms(lambda: ba.band_attention_bwd(a_dst, a_src, x_ext, mask, d_out, 0.2, ix),
                            3, 10))
                print(f"  for comparison, band_attention (whole-window softmax, mask scan) on the same "
                      f"inputs: forward {v2_ms[H * C][0]:.4f} ms, backward {v2_ms[H * C][1]:.4f} ms")
            del a_dst, a_src, x_ext, d_out, m, Z, delta
            torch.cuda.empty_cache()
    a_dst, a_src, x_ext, d_out = operands(mask, 32, 2, 128)
    out, m, Z = ba.band_attention_flash_fwd(a_dst, a_src, x_ext, mask, 0.2, ix)
    delta = (d_out * out).sum(dim=-1)
    ms_b32 = {
        "band_attention_flash": cuda_ms(
            lambda: ba.band_attention_flash_fwd(a_dst, a_src, x_ext, mask, 0.2, ix), 3, 20),
        "band_attention_flash_bwd": cuda_ms(lambda: ba.band_attention_flash_bwd(
            a_dst, a_src, x_ext, mask, m, Z, delta, d_out, 0.2, ix), 3, 20)}
    print(f"  kernels alone at B 32, H·C 256 (no plain version there: it holds several "
          f"[nB, B, BLK, W, H] tensors of 11 GB each): "
          f"forward {ms_b32['band_attention_flash']:.4f} ms, backward "
          f"{ms_b32['band_attention_flash_bwd']:.4f} ms")
    del a_dst, a_src, x_ext, d_out, out, m, Z, delta
    torch.cuda.empty_cache()

    bbl = btpl.band_layout()
    bnB, bBLK, bW = bbl.adj_mask.shape
    bix, bmask = big["mask_ix"], big["mask"]
    bn_pad = bbl.n_pad
    # the window cells that some row of their block reads: what the forward must fetch
    blk_i, _, j_i = np.nonzero(bbl.adj_mask)
    cells = len(np.unique(blk_i * bW + j_i))
    wb_ix = 4 * (bn_pad + 1 + bix.nnz) + 4 * (bn_pad + bW - bBLK + 1 + 2 * bix.nnz)
    for H, C in ((2, 128), (1, 128)):
        B = wbs
        a_dst, a_src, x_win, d_out = check_window("bigtown", bmask, bix, B, H, C)
        small, wide_ = 4 * B * bn_pad * H, 4 * B * H * C
        bound(dict(
            name="band_attention_window", net="bigtown", B=B, hc=H * C,
            ms=cuda_ms(lambda: ba.band_attention_window_fwd(a_dst, a_src, x_win, bmask, 0.2, bix), 3, 20),
            plain_ms=cuda_ms(lambda: ba.band_attention_window_plain(a_dst, a_src, x_win, bmask, 0.2), 1, 3),
            bytes=small + 4 * B * H * cells + wide_ * (cells + bn_pad) + 4 * (bn_pad + 1 + bix.nnz),
            ops=B * H * bix.nnz * (2 * C + 6)))
        # the backward writes both window cotangents densely: every cell once
        bound(dict(
            name="band_attention_window_bwd", net="bigtown", B=B, hc=H * C,
            ms=cuda_ms(lambda: ba.band_attention_window_bwd(
                a_dst, a_src, x_win, bmask, d_out, 0.2, bix), 3, 20),
            plain_ms=cuda_ms(lambda: ba.band_attention_window_bwd_plain(
                a_dst, a_src, x_win, bmask, d_out, 0.2), 1, 3),
            bytes=2 * small + 4 * B * H * cells + wide_ * (cells + bn_pad)
            + 4 * bnB * B * bW * H * (1 + C) + wb_ix,
            ops=B * H * bix.nnz * (4 * C + 12)))
        del a_dst, a_src, x_win, d_out
        torch.cuda.empty_cache()
    return dict(rows=rows, ms_b32=ms_b32, v2_ms=v2_ms, serve_launches=serve_launches, serve_ms=serve_ms,
                serve_batch=bs, fit_launches=fit_launches, step_launches=step_launches,
                step_ms=step_ms, train_batch=tbs, fit_peak=fit_peak, window_serve=window_serve,
                window_step=window_step, window_serve_ms=window_serve_ms, route_ms=route_ms,
                serve_batches=n_batches,
                shape=f"n_pad {n_pad}, W {W}", window_shape=f"n_pad {bn_pad}, W {bW}")


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
        band_attention_bwd, band_attention_bwd_plain, band_attention_flash_bwd,
        band_attention_flash_fwd, band_attention_fwd, band_attention_plain,
        band_attention_window_bwd, band_attention_window_fwd,
    )
    from gnn_pressure_estimation_tpu_torch.ops.band_spmm import (
        band_spmm_bwd, band_spmm_bwd_plain, band_spmm_fwd, band_spmm_plain,
    )
    from gnn_pressure_estimation_tpu_torch.ops.graph_attention import (
        fused_attention_bwd, fused_attention_fwd, fused_factored_bwd, fused_factored_fwd,
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
    band_wrappers = {"band_attention": band_attention_fwd, "band_spmm": band_spmm_fwd,
                     "band_attention_bwd": band_attention_bwd, "band_spmm_bwd": band_spmm_bwd}
    wrappers = {**band_wrappers,
                "fused_attention": fused_attention_fwd, "fused_attention_bwd": fused_attention_bwd,
                "fused_factored": fused_factored_fwd, "fused_factored_bwd": fused_factored_bwd,
                "band_attention_flash": band_attention_flash_fwd,
                "band_attention_flash_bwd": band_attention_flash_bwd,
                "band_attention_window": band_attention_window_fwd,
                "band_attention_window_bwd": band_attention_window_bwd}

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

    def read_launches():
        return {k: w.launches for k, w in wrappers.items()}

    def counts(**launched):
        """The expected reading: the named kernels' counts, 0 for the others."""
        return {k: launched.get(k, 0) for k in wrappers}
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
    per_step = counts(band_attention=50, band_spmm=25, band_attention_bwd=50, band_spmm_bwd=25)

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
    worst = grads_within("B 1 step vs JAX", names, grads1,
                         [torch.as_tensor(tfx[f"grad_{k}"], device=dev) for k in names])
    print(f"  B 1 step vs the JAX Trainer ({bytes(tfx['path']).decode()} band path): loss {loss1:.7f} "
          f"against {float(tfx['loss']):.7f}; {len(names)} gradients, each within "
          f"1e-3·max|g_ref| + 1e-6, the worst at {worst:.1%} of it; launches per step {step_launches}")
    losses3 = [float(tr1.train_step(tpl, fx["x"][:, 0][None, :], mask=tfx["mask"])[0])
               for _ in range(3)]
    # components whose gradient is rounding noise are held to 3 steps of 2·lr = 3e-3,
    # the others to 3e-4
    perr, pnoise = adam_param_errors(tr1.model.named_parameters(), tfx)
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
    worst_p = grads_within("kernel step vs plain step", names, grads1, grads_p)
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
        expect = counts(band_attention=50 * (n_tr + n_ev), band_spmm=25 * (n_tr + n_ev),
                        band_attention_bwd=50 * n_tr, band_spmm_bwd=25 * n_tr)
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
    del trn
    torch.cuda.empty_cache()
    dense = dense_phases(dev, card, rng, held, reset_launches, read_launches, counts)
    mega = mega_phases(dev, card, rng, held, reset_launches, read_launches, counts,
                       dict(tpl=tpl, npz=npz, x=fx["x"], tfx=tfx, mask=mask, mask_ix=mask_ix))

    kernels = []
    for name in band_wrappers:
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
    # the dense kernels: headline row H 2 (conv1 of GATRes-small: C 32, D 33); the
    # factored pair counts the synthctown serving and fit runs, the attention pair
    # the attn_impl="softmax" batch and step
    dense_replaces = {"fused_attention": 70, "fused_attention_bwd": 82,
                      "fused_factored": 224, "fused_factored_bwd": 240}
    dense_launches = {"fused_factored": sum(dense["serve_launches"].values()),
                      "fused_factored_bwd": dense["fit_launches"]["fused_factored_bwd"],
                      **dense["soft_launches"]}
    for name, line in dense_replaces.items():
        shaped = {(r["H"], r["C"]): r for r in dense["rows"] if r["name"] == name}
        r = shaped[(2, 32)]
        if not dense_launches[name]:
            raise SystemExit(f"FAIL {name} was not launched on the dense path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gnn_pressure_estimation_tpu_torch/csrc/{name}.cu",
            "replaces": f"{TPU_DENSE_SRC}:{line}", "launches": dense_launches[name],
            "max_abs_err": max_err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "device_ms": r["device_ms"], "einsum_ms": r["einsum_ms"],
            "shape": f"B 32, n {dense['n']}, nonzeros {dense['nnz']}, H 2, C 32",
            "by_shape": {f"H{h} C{c}": {k: q[k] for k in ("ms", "device_ms", "plain_ms", "einsum_ms",
                                                          "bound_ms", "bytes")}
                         for (h, c), q in shaped.items()},
        })
    # the flash pair: headline row meganet at the serving batch, H·C 256; the forward
    # counts the meganet serving run's launches, the backward the fit's. The window
    # pair: bigtown at B 32; the serving batch's and the B 1 step's launches
    new_kernels = {
        "band_attention_flash": (531, mega["serve_launches"], "meganet", mega["serve_batch"]),
        "band_attention_flash_bwd": (677, mega["fit_launches"], "meganet", mega["serve_batch"]),
        "band_attention_window": (47, mega["window_serve"], "bigtown", 32),
        "band_attention_window_bwd": (99, mega["window_step"], "bigtown", 32)}
    for name, (line, launched, net, B) in new_kernels.items():
        shaped = {(r["B"], r["hc"]): r for r in mega["rows"] if r["name"] == name}
        r = shaped[(B, 256)]
        if not launched[name]:
            raise SystemExit(f"FAIL {name} was not launched on its path")
        flash = net == "meganet"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gnn_pressure_estimation_tpu_torch/csrc/{name}.cu",
            "replaces": f"{TPU_SRC}:{line}", "launches": launched[name],
            "launches_per_forward": (mega["serve_launches"][name] // mega["serve_batches"]
                                     if flash else mega["window_serve"][name]),
            "launches_per_train_step": (mega["step_launches"] if flash else mega["window_step"])[name],
            "max_abs_err": max_err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "shape": f"{net}, B {B}, {mega['shape'] if flash else mega['window_shape']}, H·C 256",
            **({} if name != "band_attention_window" else {"bigtown_route_ms": {
                k: [{"serve_b32": a, "step_b8": b} for a, b in v]
                for k, v in mega["route_ms"].items()}}),
            **({"ms_b32": mega["ms_b32"][name]} if flash else {}),
            "by_shape": {f"B{b} HC{hc}": {k: q[k] for k in ("ms", "plain_ms", "bound_ms", "bytes")}
                         for (b, hc), q in shaped.items()},
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
