"""Dataset generation: token sampling → parallel solve → zarr-zip.

Capability parity with reference scenegenv7.py's main flow (:338-726):

- 10× scenario oversampling so rejections still reach ``num_scenarios``
  accepted scenes (:355)
- host process-pool execution with per-batch fault tolerance (failed batches
  dropped, generation continues — replaces the Ray actor pool + RayError
  handling, :567-628)
- zarr output layout identical to the reference: per-attribute groups with
  ``train/valid/test`` arrays, per-attribute train-split stats attrs
  (min/max/mean/std/mcoef/bcoef/cv), root attrs ``config``/``args``/
  ``ordered_names_by_attr`` (:643-726), final zip at ``<storage_dir>.zip``
  — and, unlike the reference, the directory store actually lands in
  ``storage_dir`` instead of a hardcoded ``"test"`` dir (SURVEY §2 quirk).

A copy of ``gnn_pressure_estimation_tpu/simgen/runner.py`` over the port's
executor, solver and ``ZarrZipWriter``: one INI, seed and network give the
same store in both packages. The solver backend is settled before any batch
runs and logged: ``backend="cpp"`` raises if the C++ solver does not build,
and the automatic choice says when it falls back to the NumPy solver. The
worker processes are spawned, not forked (the caller may hold threads: the
CUDA runtime's, the profiler's), and are handed the settled backend.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp
import os
import shutil
import time
from typing import Optional

import numpy as np

from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
from gnn_pressure_estimation_tpu_torch.data.zarrzip import (
    ZarrZipReader,
    ZarrZipWriter,
    zip_directory_store,
)
from gnn_pressure_estimation_tpu_torch.simgen import solver_api, solver_cpp
from gnn_pressure_estimation_tpu_torch.simgen.config import GenOptions, read_config
from gnn_pressure_estimation_tpu_torch.simgen.executor import ScenarioExecutor
from gnn_pressure_estimation_tpu_torch.simgen.tokens import (
    apply_injections,
    build_feature_specs,
    build_injections,
    sample_params,
)

_WORKER: dict = {}

TOKEN_KEY = "token"  # reference ParamEnum.RANDOM_TOKEN zarr array name


def mean_feature_corr(df: np.ndarray) -> float:
    """Mean of the feature-correlation matrix (the reference's ``mcoef``
    diagnostic, scenegenv7.py:668-699 uses ``np.corrcoef`` directly).

    For wide matrices the n×n corrcoef is quadratic in nodes (a 23k-node
    network would materialize a 4.2 GB matrix just to take its mean), so
    past 2048 columns this uses the exact closed form instead: with columns
    z-scored (ddof=1), mean_ij corr_ij = Σ_s (Σ_i z_si)² / ((S−1)·m²) over
    the m nonconstant columns — identical to ``nanmean(corrcoef)`` because
    NaN entries come exactly from the constant columns."""
    df = np.asarray(df, float)
    if df.shape[0] <= 1:
        return 1.0
    if df.shape[1] <= 2048:
        with np.errstate(invalid="ignore", divide="ignore"):
            return float(np.nanmean(np.corrcoef(df.T)))
    sd = df.std(axis=0, ddof=1)
    ok = sd > 0
    m = int(ok.sum())
    if m == 0:
        return float("nan")
    z = (df[:, ok] - df[:, ok].mean(axis=0)) / sd[ok]
    s = z.sum(axis=1)
    return float((s @ s) / (df.shape[0] - 1) / (m * m))


def _worker_init(inp_text: str, cfg_path: str, opts: GenOptions,
                 backend: Optional[str] = None):
    """Per-process executor construction (reference WDNRayExecutor.__init__
    loads the INP once per actor, Executorv7.py:86-134); a worker process is
    given the backend its parent settled."""
    if backend is not None:
        solver_api.set_backend(backend)
    wn = parse_inp(inp_text)
    cfg = read_config(cfg_path)
    specs = build_feature_specs(wn, cfg, opts)
    _WORKER["executor"] = ScenarioExecutor(wn, specs, cfg, opts)
    _WORKER["specs"] = specs
    _WORKER["injections"] = build_injections(specs, opts)


def _worker_run(args):
    """Sample (or take precomputed) parameter rows and solve them."""
    batch_seed, chunk_size, preset_params = args
    ex: ScenarioExecutor = _WORKER["executor"]
    if preset_params is not None:
        # update_*_json overrides compose with --load_params: the prior
        # store's rows are replayed with the named elements pinned
        params = apply_injections(
            _WORKER["specs"], np.asarray(preset_params, np.float64),
            _WORKER["injections"],
        )
    else:
        rng = np.random.default_rng(batch_seed)
        params = sample_params(
            _WORKER["specs"], chunk_size, rng, _WORKER["injections"]
        )
    return ex.simulate(params)


def solver_backend(requested: Optional[str]) -> str:
    """The backend the executors will run. ``"cpp"`` asked for explicitly
    must build and load, or this raises with the build's error; ``None``
    takes the C++ solver when it builds and the NumPy one otherwise (the
    backend rule of ``solver_api``), which the caller logs."""
    if requested == "cpp":
        solver_cpp.build()                  # raises RuntimeError with make's output
        if not solver_cpp.is_available():
            raise RuntimeError(f"the C++ solver built but did not load ({solver_cpp.library_path()})")
        return "cpp"
    if requested not in (None, "py"):
        raise ValueError(f"solver backend {requested!r} is not 'cpp' or 'py'")
    return requested or solver_api._resolve_backend()


def load_computed_params(store_path: str) -> np.ndarray:
    """Read a prior run's accepted parameter matrix (reference
    RayTokenGenerator.load_computed_params, TokenGeneratorByRange.py:628-633)."""
    with ZarrZipReader(store_path) as r:
        return r.read_array(TOKEN_KEY)


def generate(
    config_path: str,
    opts: Optional[GenOptions] = None,
    log_fn=print,
) -> str:
    """Run the full generation; returns the path of the output zip."""
    opts = opts or GenOptions(config=config_path)
    cfg = read_config(config_path)
    wn_inp_path = cfg.get("general", "wn_inp_path")
    storage_dir = cfg.get("general", "storage_dir")
    num_scenarios = cfg.getint("general", "num_scenarios")

    with open(wn_inp_path) as f:
        inp_text = f.read()
    wn = parse_inp(inp_text)
    specs = build_feature_specs(wn, cfg, opts)
    if not specs:
        raise ValueError("no gen_* flags enabled — nothing to randomize")

    batch_size = opts.batch_size
    attrs = opts.attributes()
    backend = solver_backend(opts.backend)
    fell_back = opts.backend is None and backend == "py"
    log_fn(f"solver backend: {backend}"
           + (" (the C++ solver did not build; NumPy solver)" if fell_back else ""))

    preset = None
    if opts.load_params:
        # regenerate from a prior run's accepted parameter rows — no
        # oversampling (every row already passed the filters), and row
        # order is preserved so the rebuilt store is byte-identical
        preset = load_computed_params(opts.load_params)
        num_scenarios = preset.shape[0]
        work = [
            (0, 0, preset[b : b + batch_size])
            for b in range(0, num_scenarios, batch_size)
        ]
    else:
        backup = num_scenarios * opts.oversample_factor
        num_batches = max(backup // batch_size, 1)
        seeds = [opts.seed * 1_000_003 + b for b in range(num_batches)]
        work = [(s, batch_size, None) for s in seeds]

    t0 = time.time()
    log_fn(
        f"generate: {num_scenarios} scenarios "
        + (f"(from {opts.load_params})" if preset is not None
           else f"(oversampled {num_scenarios * opts.oversample_factor})")
        + f" on {opts.executors} workers, batch {batch_size}, attrs {attrs}"
    )

    collected: dict[str, list[np.ndarray]] = {a: [] for a in attrs}
    token_rows: list[np.ndarray] = []
    ordered_names: dict[str, list[str]] = {}
    success = 0
    batches_done = 0

    def consume(result):
        nonlocal success, batches_done
        batch, names, ok_params = result
        batches_done += 1
        if not batch:
            return
        got = min(v.shape[0] for v in batch.values())
        take = min(got, num_scenarios - success)
        if take <= 0:
            return
        for key, value in batch.items():
            collected[key].append(value[:take])
            if key not in ordered_names:
                ordered_names[key] = names[key]
        token_rows.append(ok_params[:take])
        success += take

    if opts.executors <= 1 or preset is not None:
        # load mode runs in-process sequentially: row order must match the
        # source store exactly, and solve cost dominates setup anyway
        _worker_init(inp_text, config_path, opts)
        for w in work:
            if success >= num_scenarios:
                break
            try:
                consume(_worker_run(w))
            except Exception as e:  # per-batch fault tolerance
                log_fn(f"WARNING! batch failed: {e}")
    else:
        with cf.ProcessPoolExecutor(
            max_workers=opts.executors,
            mp_context=mp.get_context("spawn"),
            initializer=_worker_init,
            initargs=(inp_text, config_path, opts, backend),
        ) as pool:
            pending = {pool.submit(_worker_run, w) for w in work}
            for fut in cf.as_completed(pending):
                if success >= num_scenarios:
                    for p in pending:
                        p.cancel()
                    break
                try:
                    consume(fut.result())
                except Exception as e:
                    log_fn(f"WARNING! batch failed: {e}")

    elapsed = time.time() - t0
    log_fn(f"Simulation time: {elapsed:.1f} s; Success/Expected: {success}/{num_scenarios}")
    if success == 0:
        raise RuntimeError("no scenario survived the plausibility filters")

    # ---- assemble splits + stats + zip ---------------------------------
    os.makedirs(storage_dir, exist_ok=True)
    shutil.rmtree(storage_dir, ignore_errors=True)

    train_ratio, valid_ratio = opts.train_ratio, opts.valid_ratio
    train_idx = int(success * train_ratio)
    valid_idx = train_idx + int(success * valid_ratio)

    config_dict = {sect: dict(cfg.items(sect)) for sect in cfg.sections()}
    with ZarrZipWriter(storage_dir) as w:  # directory store
        w.set_attrs("", {
            "config": config_dict,
            "args": {k: v for k, v in opts.to_dict().items()},
            "ordered_names_by_attr": ordered_names,
        })
        for key in attrs:
            if not collected[key]:
                continue
            a = np.concatenate(collected[key], axis=0)[:success]
            train_a, valid_a, test_a = a[:train_idx], a[train_idx:valid_idx], a[valid_idx:]
            w.create_group(key)
            df = train_a.astype(float)
            feat_coef = mean_feature_corr(df)
            with np.errstate(invalid="ignore", divide="ignore"):
                batch_coef = float(np.nanmean(np.corrcoef(df))) if df.shape[0] > 1 else 1.0
                cv = float(np.mean(df.var(axis=-1) / df.mean(axis=-1)))
            w.set_attrs(key, {
                "min": float(train_a.min()),
                "max": float(train_a.max()),
                "mean": float(train_a.mean()),
                "std": float(train_a.std()),
                "mcoef": feat_coef,
                "bcoef": batch_coef,
                "cv": cv,
            })
            chunk = (max(batch_size, 1), a.shape[-1])
            w.write_array(f"{key}/train", train_a, chunks=chunk)
            w.write_array(f"{key}/valid", valid_a, chunks=chunk)
            w.write_array(f"{key}/test", test_a, chunks=chunk)

        if opts.save_params and token_rows:
            # audit trail: accepted parameter rows, row-aligned with the
            # attribute arrays, Blosc-lz4 like the reference's token array
            # (TokenGeneratorByRange.py:592-621) — a store regenerates
            # bit-identically via ``load_params``
            tokens = np.concatenate(token_rows, axis=0)[:success].astype(np.float64)
            w.write_array(
                TOKEN_KEY, tokens,
                chunks=(max(batch_size, 1), max(tokens.shape[-1], 1)),
                compressor="blosc",
            )

    if opts.debug:
        dump_debug(storage_dir, collected, success, log_fn)

    zip_path = storage_dir.rstrip("/\\") + ".zip"
    zip_directory_store(storage_dir, zip_path)
    log_fn(f"Execution time: {time.time() - t0:.1f} s → {zip_path}")
    return zip_path


def dump_debug(storage_dir: str, collected: dict, success: int, log_fn=print):
    """Generation observability (reference scenegenv7.py:728-742 renders
    per-attribute histograms with plt.show): per-attribute histograms and
    min/max/mean/std/corr diagnostics, logged as text and rendered to
    ``<storage_dir>_debug.png`` (headless-safe)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = [k for k, v in collected.items() if v]
    fig, axes = plt.subplots(1, max(len(keys), 1), figsize=(6 * len(keys), 4))
    axes = np.atleast_1d(axes)
    for ax, key in zip(axes, keys):
        a = np.concatenate(collected[key], axis=0)[:success].astype(float)
        flat = a.ravel()
        corr = mean_feature_corr(a)
        log_fn(
            f"debug[{key}]: shape={a.shape} min={flat.min():.4g} "
            f"max={flat.max():.4g} mean={flat.mean():.4g} std={flat.std():.4g} "
            f"feat_corr={corr:.4f}"
        )
        hist, edges = np.histogram(flat, bins=10)
        bars = " ".join(
            f"[{lo:.3g},{hi:.3g}):{c}"
            for lo, hi, c in zip(edges[:-1], edges[1:], hist)
        )
        log_fn(f"debug[{key}] hist10: {bars}")
        ax.hist(flat, bins=100, alpha=0.5, label=key)
        ax.set_title(key)
        ax.legend()
    png = storage_dir.rstrip("/\\") + "_debug.png"
    fig.tight_layout()
    fig.savefig(png, dpi=80)
    plt.close(fig)
    log_fn(f"debug figure → {png}")
