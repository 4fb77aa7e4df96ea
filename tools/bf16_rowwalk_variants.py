"""The bf16-operand row walk (``csrc/band_rowwalk.cuh``, ``kBf16``) on one card:
its build variants, and the parent tree's round-on-load instance beside it.

    python3 tools/bf16_rowwalk_variants.py [--parent DIR] [--out FILE]

Needs a CUDA card and ``nvcc``. Builds ``csrc/band_attention.cu`` (v2) and
``csrc/band_attention_flash.cu`` (v4) once as they stand (the kept build)
and once for each variant of the bf16 walk, from a copy of ``csrc`` with the
walk's constants rewritten (``kBf16Group``: entries staged ahead;
``kBf16MinBlocks``: the thread blocks of 8 warps an SM must hold at NV 1
(H·C ≤ 128) and NV 2, 4 capping the walk at 64 registers, 5 at 48, 6 at
40), all ``nvcc`` at once, and prints each
bf16 instance's registers and spills. On seeded inputs at the main path's
shapes (bigtown B 32 through v2, meganet B 8 through v4, H·C 256 and 128,
random rows and logit halves, a third of the nodes' halves zeroed) it holds
every variant's output against the kept build's (bit for bit, every row) and
the kept build against the plain version (1e-4), then times every variant
beside the f32 instance of the kept build (CUDA events, 20 launches after
3, in turns), with the byte bound at 2-byte rows.

``--parent DIR``: a checkout of the tree before the bf16 rows were stored
(its instance takes f32 x_ext and rounds each x as it loads it). Its two
sources are built from DIR's ``csrc`` and called through their C entries on
the same inputs in f32; the outputs (and v4's m and Z) must equal the kept
build's bit for bit on every row with a set column; then parent and kept
build are timed in turns (parent, change, change, parent).

``--out``: the numbers as JSON. Builds and the variants' sources go to the
package's git-ignored ``_build/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
# tag → (staging depth, thread blocks an SM must hold at NV 1, at NV 2); the kept
# build is (2, 5, 4)
VARIANTS = {"g4": (4, 5, 4), "m44": (2, 4, 4), "m55": (2, 5, 5), "m64": (2, 6, 4)}
KEPT = "kept"


def variant_sources(csrc: str, out_dir: str, tag: str, group: int, mb1: int, mb2: int) -> str:
    """A copy of ``csrc`` under ``out_dir`` whose bf16 walk stages ``group``
    entries and must fit ``mb1`` / ``mb2`` thread blocks an SM at NV 1 / 2;
    returns its directory."""
    dst = os.path.join(out_dir, tag, "csrc")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    path = os.path.join(dst, "band_rowwalk.cuh")
    with open(path) as f:
        text = f.read()
    for pat, val in ((r"constexpr int kBf16Group = \d+;", f"constexpr int kBf16Group = {group};"),
                     (r"constexpr int kBf16MinBlocks\[2\] = \{\d+, \d+\};",
                      f"constexpr int kBf16MinBlocks[2] = {{{mb1}, {mb2}}};")):
        text, n = re.subn(pat, val, text)
        if n != 1:
            raise SystemExit(f"FAIL {path}: {pat} found {n} times, not once")
    with open(path, "w") as f:
        f.write(text)
    return dst


def build(csrc: str, out_dir: str, tag: str) -> dict:
    """Compile v2's and v4's sources of ``csrc``, both at once; returns
    {source: (library path, compiler output)}."""
    from gnn_pressure_estimation_tpu_torch.ops import _build

    procs = {}
    for src in ("band_attention", "band_attention_flash"):
        so = os.path.join(out_dir, f"{src}-{tag}.so")
        procs[src] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, os.path.join(csrc, f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish(procs: dict) -> dict:
    out = {}
    for src, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"FAIL build of {so}:\n{log}")
        lib = ctypes.CDLL(so)
        fn = getattr(lib, src + "_fwd")
        n_ptr = 10 if src.endswith("flash") else 8
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                          ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[src] = (fn, log)
    return out


def launch(fn, flash, a_dst, a_src, x, ix, C, bf16):
    """One forward through a C entry: ``(out,)`` or ``(out, m, Z)``."""
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops

    nB, BLK, W = ix.nB, ix.BLK, ix.W
    B, _, H, _ = x.shape
    dev = x.device
    n_empty = int(ix.empty_row.shape[0])
    out = torch.empty((B, nB * BLK, H, C), dtype=torch.float32, device=dev)
    mean = torch.empty((B, nB, H * C) if n_empty else (1,), dtype=torch.float32, device=dev)
    stats = [torch.empty((B, nB * BLK, H), dtype=torch.float32, device=dev) for _ in range(2)] \
        if flash else []
    ptrs = [a_dst.data_ptr(), a_src.data_ptr(), x.data_ptr(), ix.row_ptr.data_ptr(),
            ix.col.data_ptr(), ix.empty_ptr.data_ptr(), mean.data_ptr(), out.data_ptr(),
            *[t.data_ptr() for t in stats]]
    rc = fn(*ptrs, B, nB, BLK, W, H, C, n_empty, int(bops.vector_loads(x, C)), int(bf16), 0.2,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"FAIL launch: CUDA error {rc}")
    return (out, *stats)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout of the tree that rounds x on load")
    ap.add_argument("--out", help="write the numbers here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bf16_rowwalk_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import PEAK_BYTES_S, cuda_ms, ptxas_table, smi_line
    from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
    from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
    from gnn_pressure_estimation_tpu_torch.ops import _build
    from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
    from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_mega

    dev = torch.device("cuda")
    card = smi_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    csrc = str(_build.CSRC_DIR)
    t0 = time.perf_counter()
    procs = {KEPT: build(csrc, out_dir, KEPT)}
    for tag, (g, mb1, mb2) in VARIANTS.items():
        procs[tag] = build(variant_sources(csrc, out_dir, tag, g, mb1, mb2), out_dir, tag)
    if args.parent:
        procs["parent"] = build(os.path.join(args.parent, "gnn_pressure_estimation_tpu_torch",
                                             "csrc"), out_dir, "parent")
    libs = {tag: finish(p) for tag, p in procs.items()}
    print(f"built {sum(len(p) for p in procs.values())} libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    result = {"card": card, "registers": {}, "rows": [], "parent": []}
    for tag, srcs in libs.items():
        for src, (_, log) in srcs.items():
            for fn, regs, stack, st, ld in ptxas_table(log):
                if tag == KEPT or fn.startswith("band_rowwalk_kernel") and fn.endswith("true>"):
                    result["registers"].setdefault(tag, {})[f"{src} {fn}"] = [regs, stack, st, ld]
                    print(f"  {tag} {src}: {fn}: {regs} registers, {stack} bytes stack, "
                          f"spill {st} / {ld}")

    gen = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    nets = {}
    wn = parse_inp(os.path.join(ROOT, "inputs", "bigtown.inp"))
    nets["bigtown"] = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                                     name="bigtown")[0]
    wn = make_mega()
    nets["meganet"] = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                                     name="meganet")[0]
    for net, flash, B in (("bigtown", False, 32), ("meganet", True, 8)):
        tpl = nets[net]
        bl = tpl.band_layout()
        mask = torch.as_tensor(bl.adj_mask.view(np.int8), device=dev)
        ix = tpl.band_index("adj_mask").to(dev)
        nB, BLK, W = bl.adj_mask.shape
        n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
        real = (ix.row_ptr[1:] != ix.row_ptr[:-1])                       # rows with a set column
        src = "band_attention_flash" if flash else "band_attention"
        for H, C in ((2, 128), (1, 128)):
            a_dst, a_src = randn(B, n_pad, H), randn(nB, B, W, H)
            a_dst[:, ::3] = 0.0
            a_src[:, :, ::3] = 0.0
            x = randn(B, n_ext, H, C)
            xb = x.to(torch.bfloat16)
            label = f"{net} B {B} H·C {H * C}"
            kept = launch(libs[KEPT][src][0], flash, a_dst, a_src, xb, ix, C, True)
            plain = (ba.band_attention_flash_plain if flash else ba.band_attention_plain)(
                a_dst, a_src, xb, mask, 0.2, True)
            plain = plain if flash else (plain,)
            err = max(float((k - p).abs().max()) for k, p in zip(kept, plain))
            if not all(torch.allclose(k, p, atol=1e-4, rtol=1e-4) for k, p in zip(kept, plain)):
                raise SystemExit(f"FAIL {src} bf16 {label}: {err:.3e} from the plain version")
            del plain
            for tag in VARIANTS:
                got = launch(libs[tag][src][0], flash, a_dst, a_src, xb, ix, C, True)
                if not all(torch.equal(g, k) for g, k in zip(got, kept)):
                    raise SystemExit(f"FAIL {src} {tag} {label}: not the kept build's output")
            f32 = launch(libs[KEPT][src][0], flash, a_dst, a_src, x, ix, C, False)[0]
            gap = float((f32 - kept[0]).abs().max())
            nbytes = 4 * (B * n_pad * H + B * n_ext * H + B * n_pad * H * C) + 2 * B * n_ext * H * C \
                + 4 * (n_pad + 1 + ix.nnz) + 4 * (nB + 1) + (8 * B * n_pad * H if flash else 0)
            bound = nbytes / PEAK_BYTES_S * 1e3
            t = {"f32": []}

            def run(tag, xx=xb, bf=True):
                return lambda: launch(libs[tag][src][0], flash, a_dst, a_src, xx, ix, C, bf)
            for tag in ("f32", KEPT, *VARIANTS, *VARIANTS, KEPT, "f32"):
                fn = run(KEPT, x, False) if tag == "f32" else run(tag)
                t.setdefault(tag, []).append(cuda_ms(fn, 3, 20))
            row = dict(src=src, net=net, B=B, hc=H * C, bound_ms=bound, bytes=nbytes,
                       plain_err=err, f32_gap=gap, ms={k: v for k, v in t.items()})
            result["rows"].append(row)
            print(f"  {src} bf16 {label}: within {err:.3e} of plain, {gap:.3e} from f32 "
                  f"(max |out| {float(kept[0].abs().max()):.3e}); every variant bit-equal; bound "
                  f"{bound:.4f} ms at 2-byte rows ({nbytes / 1e6:.1f} MB); ms: "
                  + ", ".join(f"{k} " + " / ".join(f"{v:.4f}" for v in vs) for k, vs in t.items()))
            if args.parent:
                old = launch(libs["parent"][src][0], flash, a_dst, a_src, x, ix, C, True)
                rr = real.repeat(B)
                same = [torch.equal(o.reshape(B * n_pad, -1)[rr], k.reshape(B * n_pad, -1)[rr])
                        for o, k in zip(old, kept)]
                pad = float((old[0].reshape(B * n_pad, -1)[~rr]
                             - kept[0].reshape(B * n_pad, -1)[~rr]).abs().max()) \
                    if bool((~rr).any()) else 0.0
                if not all(same):
                    raise SystemExit(f"FAIL {src} bf16 {label}: not the parent's output on the real "
                                     f"rows ({same})")
                tp = {"parent": [], "change": []}
                for who in ("parent", "change", "change", "parent"):
                    fn = (lambda: launch(libs["parent"][src][0], flash, a_dst, a_src, x, ix, C, True)) \
                        if who == "parent" else run(KEPT)
                    tp[who].append(cuda_ms(fn, 3, 20))
                result["parent"].append(dict(src=src, net=net, B=B, hc=H * C, ms=tp,
                                             real_rows_equal=True, padded_max_diff=pad))
                print(f"  {src} bf16 {label} against the parent (f32 x_ext, rounded on load): out"
                      + (", m, Z" if flash else "") + f" equal bit for bit on the {int(real.sum())} "
                      f"real rows of each graph; padded rows within {pad:.3e}; parent "
                      + " / ".join(f"{v:.4f}" for v in tp["parent"]) + " ms, change "
                      + " / ".join(f"{v:.4f}" for v in tp["change"]) + " ms (in turns)")
            del a_dst, a_src, x, xb, kept, f32
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
